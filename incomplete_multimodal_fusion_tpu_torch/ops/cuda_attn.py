"""Kernel K1, ``zorro_attention_qkv``: multi-head self-attention over the
fused [B, N, 3I] qkv projection (csrc/zorro_attention.cu), forward and
backward.

Counterpart of the JAX package's ops/pallas_attn.py (the zorro-masked
encoder attention) and ops/pallas_small_attn.py (the decoder's unmasked
attention). With ``types`` the Zorro mask applies: a query attends a key iff
they have the same token type, or the query is a fusion token and the key is
not padding (``PAD_TYPE``). Without ``types`` nothing is masked.

The scale multiplies the f32 scores (q.k) * scale, then masked scores become
the finite ``NEG_INF`` of pallas_attn.py:37, in the kernels and the plain
versions alike. The forward can also return the f32 row log-sum-exp
``lse`` [B, H, N]; the backward recomputes the probabilities from it.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
(bf16 only) or raises. ``ZorroAttentionQKV`` is the autograd Function the
model calls: on CPU tensors it runs the plain forward and backward, on CUDA
tensors the two kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .attention import upcast, zorro_mask_from_padded_types

PAD_TYPE = 255
NEG_INF = -0.7 * torch.finfo(torch.float32).max
SUPPORTED_DH = (32, 64, 128)

# launches of the kernels, per mode; only the wrappers' launches add to them
LAUNCHES = {"zorro": 0, "none": 0, "zorro_backward": 0, "none_backward": 0}


def _heads_view(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, N, H*dh] -> [B, H, N, dh]."""
    b, n, inner = t.shape
    return t.reshape(b, n, heads, inner // heads).transpose(1, 2)


def _scores(qkv, heads, types, fusion_type, scale):
    """q, k, v as [B, H, N, dh] and the scaled, masked f32 scores."""
    inner = qkv.shape[-1] // 3
    q, k, v = (_heads_view(t, heads) for t in qkv.split(inner, dim=-1))
    s = torch.einsum("bhid,bhjd->bhij", upcast(q), upcast(k)) * scale
    if types is not None:
        allowed = zorro_mask_from_padded_types(types, fusion_type, PAD_TYPE)[:, None]
        s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    return q, k, v, s


def zorro_attention_qkv_reference(qkv: torch.Tensor, heads: int,
                                  types: Optional[torch.Tensor] = None,
                                  fusion_type: Optional[int] = None,
                                  scale: Optional[float] = None, return_lse: bool = False):
    """Plain PyTorch version, the JAX ``_packed_qkv_xla`` (pallas_attn.py:775)
    with types and ``small_attention_qkv_xla`` (pallas_small_attn.py:179)
    without: f32 scores and softmax, probabilities cast to the activation
    dtype for the value product. qkv [B, N, 3I] -> [B, N, I] (and lse)."""
    b, n, three_i = qkv.shape
    if scale is None:
        scale = (three_i // 3 // heads) ** -0.5
    _, _, v, s = _scores(qkv, heads, types, fusion_type, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhij,bhjd->bhid", upcast(p.to(qkv.dtype)), upcast(v))
    out = out.transpose(1, 2).reshape(b, n, three_i // 3).to(qkv.dtype)
    return (out, lse) if return_lse else out


def zorro_attention_qkv_backward_reference(qkv, types, o, lse, do, heads: int,
                                           fusion_type: Optional[int] = None,
                                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain backward with the cast points of the Pallas bodies
    (pallas_attn.py:529-664 classic form, pallas_small_attn.py:70):
    P = exp(s - lse) in f32, D = rowsum(dO * O) in f32, dV = P(bf16)^T dO,
    dS = P * (dP - D) cast to the activation dtype, dQ = dS K * scale,
    dK = dS^T Q * scale. Returns dqkv [B, N, 3I] in qkv's dtype."""
    b, n, three_i = qkv.shape
    dtype = qkv.dtype
    if scale is None:
        scale = (three_i // 3 // heads) ** -0.5
    q, k, v, s = _scores(qkv, heads, types, fusion_type, scale)
    p = torch.exp(s - lse[..., None])
    dof = upcast(_heads_view(do, heads))
    d = (dof * upcast(_heads_view(o, heads))).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhij,bhid->bhjd", upcast(p.to(dtype)), dof)
    dp = torch.einsum("bhid,bhjd->bhij", dof, upcast(v))
    ds = upcast((p * (dp - d)).to(dtype))
    dq = torch.einsum("bhij,bhjd->bhid", ds, upcast(k)) * scale
    dk = torch.einsum("bhij,bhid->bhjd", ds, upcast(q)) * scale
    parts = [t.transpose(1, 2).reshape(b, n, three_i // 3) for t in (dq, dk, dv)]
    return torch.cat(parts, dim=-1).to(dtype)


def _check_qkv(name, qkv, heads, types, fusion_type):
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"{name}: bad qkv shape {tuple(qkv.shape)} for {heads} heads")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be contiguous and 16-byte aligned")
    b, n, three_i = qkv.shape
    dh = three_i // 3 // heads
    if dh not in SUPPORTED_DH:
        raise ValueError(f"{name}: head dim {dh} not in {SUPPORTED_DH}")
    if types is None:
        return None
    if types.shape != (b, n) or types.device != qkv.device:
        raise ValueError(f"{name}: types must be [B, N] = {(b, n)} on {qkv.device}")
    if fusion_type is None:
        raise ValueError(f"{name}: fusion_type is needed with types")
    return types.to(torch.int32).contiguous()


def zorro_attention_qkv(qkv: torch.Tensor, heads: int, types: Optional[torch.Tensor] = None,
                        fusion_type: Optional[int] = None,
                        scale: Optional[float] = None, return_lse: bool = False):
    """qkv [B, N, 3I] laid out [q | k | v], heads packed inside each;
    types [B, N] int (PAD_TYPE = padding) or None. Returns [B, N, I], and
    with ``return_lse`` also the f32 row log-sum-exp [B, H, N]."""
    if qkv.device.type == "cpu":
        return zorro_attention_qkv_reference(qkv, heads, types, fusion_type, scale, return_lse)
    types = _check_qkv("zorro_attention_qkv", qkv, heads, types, fusion_type)
    b, n, three_i = qkv.shape
    inner = three_i // 3
    dh = inner // heads
    if scale is None:
        scale = dh ** -0.5
    out = torch.empty((b, n, inner), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device) if return_lse else None
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = cuda_build.bind("zorro_attention.cu", "zorro_attention_qkv_bf16",
                         [p, p, p, p, i, i, i, i, ll, ll, ll, ll, ll, ctypes.c_float, i, i, p])
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), 0 if types is None else types.data_ptr(), out.data_ptr(),
                 0 if lse is None else lse.data_ptr(), b, n, heads, dh, n * three_i, three_i,
                 n * inner, inner, 0 if types is None else n, float(scale),
                 -1 if fusion_type is None else int(fusion_type), int(types is not None), stream)
    cuda_build.check_launch(err, "zorro_attention_qkv")
    LAUNCHES["none" if types is None else "zorro"] += 1
    return (out, lse) if return_lse else out


def zorro_attention_qkv_backward(qkv: torch.Tensor, types: Optional[torch.Tensor],
                                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                                 heads: int, fusion_type: Optional[int] = None,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """dqkv [B, N, 3I] of ``zorro_attention_qkv`` from its input, its output
    ``o``, its ``lse`` and the output gradient ``do``."""
    if qkv.device.type == "cpu":
        return zorro_attention_qkv_backward_reference(qkv, types, o, lse, do, heads,
                                                      fusion_type, scale)
    types = _check_qkv("zorro_attention_qkv_backward", qkv, heads, types, fusion_type)
    b, n, three_i = qkv.shape
    inner = three_i // 3
    dh = inner // heads
    for name, t, shape, dtype in (("o", o, (b, n, inner), qkv.dtype),
                                  ("do", do, (b, n, inner), qkv.dtype),
                                  ("lse", lse, (b, heads, n), torch.float32)):
        if (t.shape != shape or t.dtype != dtype or t.device != qkv.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"zorro_attention_qkv_backward: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on {qkv.device}")
    if scale is None:
        scale = dh ** -0.5
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)  # rowsum(dO * O)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = cuda_build.bind("zorro_attention.cu", "zorro_attention_qkv_bwd_bf16",
                         [p, p, p, p, p, p, p, i, i, i, i, ll, ctypes.c_float, i, i, p])
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), 0 if types is None else types.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dqkv.data_ptr(), delta.data_ptr(), b, n, heads, dh,
                 0 if types is None else n, float(scale),
                 -1 if fusion_type is None else int(fusion_type), int(types is not None), stream)
    cuda_build.check_launch(err, "zorro_attention_qkv_backward")
    LAUNCHES["none_backward" if types is None else "zorro_backward"] += 1
    return dqkv


class ZorroAttentionQKV(torch.autograd.Function):
    """``zorro_attention_qkv`` with its backward:
    ``ZorroAttentionQKV.apply(qkv, heads, types, fusion_type, scale)``.
    Saves qkv, the output (activation dtype) and the f32 lse; without a
    gradient to compute (serving) the forward writes no lse."""

    @staticmethod
    def forward(ctx, qkv, heads, types=None, fusion_type=None, scale=None):
        if not ctx.needs_input_grad[0]:
            return zorro_attention_qkv(qkv, heads, types, fusion_type, scale)
        out, lse = zorro_attention_qkv(qkv, heads, types, fusion_type, scale, return_lse=True)
        ctx.save_for_backward(qkv, types, out, lse)
        ctx.heads, ctx.fusion_type, ctx.scale = heads, fusion_type, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, types, out, lse = ctx.saved_tensors
        dqkv = zorro_attention_qkv_backward(qkv, types, out, lse, dout.contiguous(), ctx.heads,
                                            ctx.fusion_type, ctx.scale)
        return dqkv, None, None, None, None
