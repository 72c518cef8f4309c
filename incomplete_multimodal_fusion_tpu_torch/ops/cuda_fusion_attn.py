"""Kernel K3, ``fusion_row_attention`` (csrc/fusion_row_attention.cu),
counterpart of the JAX package's ops/pallas_fusion_attn.py.

Each fusion position attends, per head, over its T modality slots of the
t-major KV grid and its own fusion-token key/value (the last slot), with an
f32 softmax over the T + 1 slots. A CPU tensor goes to the plain version; a
CUDA tensor launches the kernel (bf16 only) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

SUPPORTED_DH = (32, 64, 128)
MAX_MODALITIES = 8

# launches of the kernel; only the wrapper's launch adds to it
LAUNCHES = {"fusion_row": 0}


def fusion_row_attention_reference(q, kv_grid, kv_f, heads: int, dh: int):
    """Plain PyTorch version, the JAX ``fusion_row_attention_xla``
    (pallas_fusion_attn.py:215): q * scale in the activation dtype, scores
    and softmax in f32, weights cast to the activation dtype for the mix.
    q [B, F, I], kv_grid [B, T*F, 2I] t-major, kv_f [B, F, 2I] -> [B, F, I]."""
    b, f, inner = q.shape
    t_mod = kv_grid.shape[1] // f
    scale = dh ** -0.5
    qh = q.reshape(b, f, heads, dh)
    k_g, v_g = kv_grid.reshape(b, t_mod, f, 2 * inner).chunk(2, dim=-1)
    k_g = k_g.reshape(b, t_mod, f, heads, dh).transpose(1, 2)  # [B, F, T, h, dh]
    v_g = v_g.reshape(b, t_mod, f, heads, dh).transpose(1, 2)
    k_f, v_f = kv_f.reshape(b, f, 2, heads, dh).chunk(2, dim=2)
    k = torch.cat([k_g, k_f], dim=2)  # [B, F, T+1, h, dh]
    v = torch.cat([v_g, v_f], dim=2)
    sim = ((qh[:, :, None] * scale).float() * k.float()).sum(dim=-1)  # [B, F, T+1, h]
    attn = torch.softmax(sim, dim=2)
    out = (attn[..., None].to(v.dtype) * v).sum(dim=2)
    return out.reshape(b, f, inner).to(q.dtype)


def fusion_row_attention(q, kv_grid, kv_f, heads: int, dh: int):
    """q [B, F, I]; kv_grid [B, T*F, 2I] t-major; kv_f [B, F, 2I]. Returns
    [B, F, I]: softmax over the T + 1 slots per fusion position, the fusion
    token's own kv as the last slot."""
    if q.device.type == "cpu":
        return fusion_row_attention_reference(q, kv_grid, kv_f, heads, dh)
    if q.device.type != "cuda":
        raise ValueError(f"fusion_row_attention: no kernel for device {q.device}")
    b, f, inner = q.shape
    for t in (q, kv_grid, kv_f):
        if t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError("fusion_row_attention: operands must be contiguous bfloat16 "
                             f"tensors on {q.device}")
    t_mod = kv_grid.shape[1] // f
    if (inner != heads * dh or dh not in SUPPORTED_DH or not 1 <= t_mod <= MAX_MODALITIES
            or heads > 32 or kv_grid.shape != (b, t_mod * f, 2 * inner)
            or kv_f.shape != (b, f, 2 * inner)):
        raise ValueError(f"fusion_row_attention: bad shapes q {tuple(q.shape)}, kv_grid "
                         f"{tuple(kv_grid.shape)}, kv_f {tuple(kv_f.shape)} for {heads} x {dh}")
    out = torch.empty_like(q)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = cuda_build.bind("fusion_row_attention.cu", "fusion_row_attention_bf16",
                         [p, p, p, p, i, i, i, i, i, ctypes.c_float, p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), kv_grid.data_ptr(), kv_f.data_ptr(), out.data_ptr(),
                 b, f, t_mod, heads, dh, float(dh ** -0.5), stream)
    cuda_build.check_launch(err, "fusion_row_attention")
    LAUNCHES["fusion_row"] += 1
    return out
