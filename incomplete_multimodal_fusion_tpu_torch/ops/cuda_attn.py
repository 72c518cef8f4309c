"""Kernel K1, ``zorro_attention_qkv``: multi-head self-attention over the
fused [B, N, 3I] qkv projection (csrc/zorro_attention.cu).

Counterpart of the JAX package's ops/pallas_attn.py (the zorro-masked
encoder attention) and ops/pallas_small_attn.py (the decoder's unmasked
attention). With ``types`` the Zorro mask applies: a query attends a key iff
they have the same token type, or the query is a fusion token and the key is
not padding (``PAD_TYPE``). Without ``types`` nothing is masked.

The scale multiplies the f32 scores (q.k) * scale, in the kernel and in the
plain version alike, as ops/attention.multihead_attention does.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
(bf16 only) or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .attention import multihead_attention, zorro_mask_from_padded_types

PAD_TYPE = 255
SUPPORTED_DH = (32, 64, 128)

# launches of the kernel, per mode; only the wrapper's launch adds to them
LAUNCHES = {"zorro": 0, "none": 0}


def zorro_attention_qkv_reference(qkv: torch.Tensor, heads: int,
                                  types: Optional[torch.Tensor] = None,
                                  fusion_type: Optional[int] = None,
                                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version, the JAX ``_packed_qkv_xla`` (pallas_attn.py:775)
    with types and ``small_attention_qkv_xla`` (pallas_small_attn.py:179)
    without. qkv [B, N, 3I] -> [B, N, I]."""
    b, n, three_i = qkv.shape
    inner = three_i // 3
    dh = inner // heads
    q, k, v = qkv.split(inner, dim=-1)
    mask = None
    if types is not None:
        mask = zorro_mask_from_padded_types(types, fusion_type, PAD_TYPE)[:, None]
    out = multihead_attention(q.reshape(b, n, heads, dh), k.reshape(b, n, heads, dh),
                              v.reshape(b, n, heads, dh), mask=mask, scale=scale)
    return out.reshape(b, n, inner)


def zorro_attention_qkv(qkv: torch.Tensor, heads: int, types: Optional[torch.Tensor] = None,
                        fusion_type: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """qkv [B, N, 3I] laid out [q | k | v], heads packed inside each;
    types [B, N] int (PAD_TYPE = padding) or None. Returns [B, N, I]."""
    if qkv.device.type == "cpu":
        return zorro_attention_qkv_reference(qkv, heads, types, fusion_type, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"zorro_attention_qkv: no kernel for device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"zorro_attention_qkv: the kernel takes bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"zorro_attention_qkv: bad qkv shape {tuple(qkv.shape)} for {heads} heads")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("zorro_attention_qkv: qkv must be contiguous and 16-byte aligned")
    b, n, three_i = qkv.shape
    inner = three_i // 3
    dh = inner // heads
    if dh not in SUPPORTED_DH:
        raise ValueError(f"zorro_attention_qkv: head dim {dh} not in {SUPPORTED_DH}")
    if types is not None:
        if types.shape != (b, n) or types.device != qkv.device:
            raise ValueError(f"zorro_attention_qkv: types must be [B, N] = {(b, n)} on {qkv.device}")
        if fusion_type is None:
            raise ValueError("zorro_attention_qkv: fusion_type is needed with types")
        types = types.to(torch.int32).contiguous()
    if scale is None:
        scale = dh ** -0.5
    out = torch.empty((b, n, inner), dtype=qkv.dtype, device=qkv.device)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = cuda_build.bind("zorro_attention.cu", "zorro_attention_qkv_bf16",
                         [p, p, p, i, i, i, i, ll, ll, ll, ll, ll, ctypes.c_float, i, i, p])
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), 0 if types is None else types.data_ptr(), out.data_ptr(),
                 b, n, heads, dh, n * three_i, three_i, n * inner, inner,
                 0 if types is None else n, float(scale),
                 -1 if fusion_type is None else int(fusion_type), int(types is not None), stream)
    cuda_build.check_launch(err, "zorro_attention_qkv")
    LAUNCHES["none" if types is None else "zorro"] += 1
    return out
