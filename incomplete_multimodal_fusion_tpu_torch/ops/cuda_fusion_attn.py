"""Kernel K3, ``fusion_row_attention`` (csrc/fusion_row_attention.cu),
forward and backward, counterpart of the JAX package's
ops/pallas_fusion_attn.py.

Each fusion position attends, per head, over its T modality slots of the
t-major KV grid and its own fusion-token key/value (the last slot), with an
f32 softmax over the T + 1 slots. A CPU tensor goes to the plain version; a
CUDA tensor launches the kernel (its bf16 instance, or for f32 tensors its
f32 one, ``*_f32`` in the library, the TPU kernel's f32 path) or raises.
``FusionRowAttention`` is the autograd Function the model calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_attn, cuda_build
from .attention import upcast

SUPPORTED_DH = (32, 64, 128)
MAX_MODALITIES = 8

# launches of the kernels, per instance (``_f32``: the f32 instance); only
# the wrappers' launches add to them
LAUNCHES = {"fusion_row": 0, "fusion_row_backward": 0, "fusion_row_f32": 0, "fusion_row_f32_backward": 0}


def _slots(q, kv_grid, kv_f, heads, dh):
    """qh [B, F, h, dh] scaled in the activation dtype; k, v
    [B, F, T+1, h, dh] with the fusion token's own kv as the last slot."""
    b, f, inner = q.shape
    t_mod = kv_grid.shape[1] // f
    qh = q.reshape(b, f, heads, dh) * dh ** -0.5
    k_g, v_g = kv_grid.reshape(b, t_mod, f, 2 * inner).chunk(2, dim=-1)
    k_g = k_g.reshape(b, t_mod, f, heads, dh).transpose(1, 2)  # [B, F, T, h, dh]
    v_g = v_g.reshape(b, t_mod, f, heads, dh).transpose(1, 2)
    k_f, v_f = kv_f.reshape(b, f, 2, heads, dh).chunk(2, dim=2)
    return qh, torch.cat([k_g, k_f], dim=2), torch.cat([v_g, v_f], dim=2)


def fusion_row_attention_reference(q, kv_grid, kv_f, heads: int, dh: int, plane_valid=None):
    """Plain PyTorch version, the JAX ``fusion_row_attention_xla``
    (pallas_fusion_attn.py:215): q * scale in the activation dtype, scores
    and softmax in f32, weights cast to the activation dtype for the mix.
    q [B, F, I], kv_grid [B, T*F, 2I] t-major, kv_f [B, F, 2I] -> [B, F, I].
    ``plane_valid`` [T+1] bool, when given, gives the excluded slots the
    score -0.7 * f32 max, the plain path of layers.py:500-502."""
    b, f, inner = q.shape
    qh, k, v = _slots(q, kv_grid, kv_f, heads, dh)
    sim = (upcast(qh[:, :, None]) * upcast(k)).sum(dim=-1)  # [B, F, T+1, h]
    if plane_valid is not None:
        sim = torch.where(plane_valid[None, None, :, None], sim,
                          torch.full_like(sim, -0.7 * torch.finfo(torch.float32).max))
    attn = torch.softmax(sim, dim=2)
    out = (attn[..., None].to(v.dtype) * v).sum(dim=2)
    return out.reshape(b, f, inner).to(q.dtype)


def fusion_row_attention_backward_reference(q, kv_grid, kv_f, do, heads: int, dh: int):
    """Plain backward with the cast points of the Pallas body
    (pallas_fusion_attn.py:95-126): dattn = do . v in f32,
    ds = attn (dattn - sum attn dattn), dq = sum_t ds k_t * scale,
    dk_t = ds_t qh, dv_t = attn_t(cast) * do as an activation-dtype product.
    Returns (dq, dkv_grid, dkv_f) in the operands' dtype and layout."""
    b, f, inner = q.shape
    t_mod = kv_grid.shape[1] // f
    dt = q.dtype
    qh, k, v = _slots(q, kv_grid, kv_f, heads, dh)
    qf = upcast(qh)[:, :, None]  # [B, F, 1, h, dh]
    attn = torch.softmax((qf * upcast(k)).sum(dim=-1), dim=2)  # [B, F, T+1, h]
    do_h = do.reshape(b, f, 1, heads, dh)
    dattn = (upcast(do_h) * upcast(v)).sum(dim=-1)
    ds = attn * (dattn - (attn * dattn).sum(dim=2, keepdim=True))
    dq = (ds[..., None] * upcast(k)).sum(dim=2) * dh ** -0.5
    dk = (ds[..., None] * qf).to(dt)  # [B, F, T+1, h, dh]
    dv = attn.to(dt)[..., None] * do_h
    dkv = torch.cat([dk, dv], dim=3)  # [B, F, T+1, 2, h, dh] -> rows of 2I
    dkv = dkv.reshape(b, f, t_mod + 1, 2 * inner)
    dkv_grid = dkv[:, :, :t_mod].transpose(1, 2).reshape(b, t_mod * f, 2 * inner)
    return dq.reshape(b, f, inner).to(dt), dkv_grid.contiguous(), dkv[:, :, t_mod].contiguous()


def _check(name, q, kv_grid, kv_f, heads, dh, *more):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    b, f, inner = q.shape
    if q.dtype not in cuda_attn.KERNEL_DTYPES:
        raise ValueError(f"{name}: the kernel takes bfloat16 or float32, got {q.dtype}")
    for t in (q, kv_grid, kv_f, *more):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous {q.dtype} tensors on {q.device}")
    t_mod = kv_grid.shape[1] // f
    if (inner != heads * dh or dh not in SUPPORTED_DH or not 1 <= t_mod <= MAX_MODALITIES
            or kv_grid.shape != (b, t_mod * f, 2 * inner)
            or kv_f.shape != (b, f, 2 * inner) or any(t.shape != q.shape for t in more)):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, kv_grid "
                         f"{tuple(kv_grid.shape)}, kv_f {tuple(kv_f.shape)} for {heads} x {dh}")
    return b, f, t_mod


@functools.cache
def _fwd_fn(dtype: torch.dtype):
    """The forward entry of ``dtype``'s instance, bound once."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("fusion_row_attention.cu",
                           f"fusion_row_attention_{cuda_attn.KERNEL_DTYPES[dtype]}",
                           [p, p, p, p, i, i, i, i, i, ctypes.c_float, p])


@functools.cache
def _bwd_fn(dtype: torch.dtype):
    """The backward entry of ``dtype``'s instance, bound once."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("fusion_row_attention.cu",
                           f"fusion_row_attention_bwd_{cuda_attn.KERNEL_DTYPES[dtype]}",
                           [p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p])


def fusion_row_attention(q, kv_grid, kv_f, heads: int, dh: int):
    """q [B, F, I]; kv_grid [B, T*F, 2I] t-major; kv_f [B, F, 2I]. Returns
    [B, F, I]: softmax over the T + 1 slots per fusion position, the fusion
    token's own kv as the last slot."""
    if q.device.type == "cpu":
        return fusion_row_attention_reference(q, kv_grid, kv_f, heads, dh)
    b, f, t_mod = _check("fusion_row_attention", q, kv_grid, kv_f, heads, dh)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fwd_fn(q.dtype)(q.data_ptr(), kv_grid.data_ptr(), kv_f.data_ptr(), out.data_ptr(),
                               b, f, t_mod, heads, dh, float(dh ** -0.5), stream)
    cuda_build.check_launch(err, "fusion_row_attention")
    LAUNCHES[cuda_attn.launch_key("fusion_row", q.dtype)] += 1
    return out


def fusion_row_attention_backward(q, kv_grid, kv_f, do, heads: int, dh: int):
    """(dq, dkv_grid, dkv_f) of ``fusion_row_attention`` given the output
    gradient ``do`` [B, F, I]."""
    if q.device.type == "cpu":
        return fusion_row_attention_backward_reference(q, kv_grid, kv_f, do, heads, dh)
    b, f, t_mod = _check("fusion_row_attention_backward", q, kv_grid, kv_f, heads, dh, do)
    dq, dkv_grid, dkv_f = torch.empty_like(q), torch.empty_like(kv_grid), torch.empty_like(kv_f)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_fn(q.dtype)(q.data_ptr(), kv_grid.data_ptr(), kv_f.data_ptr(), do.data_ptr(), dq.data_ptr(),
                               dkv_grid.data_ptr(), dkv_f.data_ptr(), b, f, t_mod, heads, dh,
                               float(dh ** -0.5), stream)
    cuda_build.check_launch(err, "fusion_row_attention_backward")
    LAUNCHES[cuda_attn.launch_key("fusion_row", q.dtype, backward=True)] += 1
    return dq, dkv_grid, dkv_f


class FusionRowAttention(torch.autograd.Function):
    """``fusion_row_attention`` with its backward:
    ``FusionRowAttention.apply(q, kv_grid, kv_f, heads, dh)``."""

    @staticmethod
    def forward(ctx, q, kv_grid, kv_f, heads, dh):
        ctx.save_for_backward(q, kv_grid, kv_f)
        ctx.heads, ctx.dh = heads, dh
        return fusion_row_attention(q, kv_grid, kv_f, heads, dh)

    @staticmethod
    def backward(ctx, do):
        dq, dkv_grid, dkv_f = fusion_row_attention_backward(*ctx.saved_tensors, do.contiguous(),
                                                            ctx.heads, ctx.dh)
        return dq, dkv_grid, dkv_f, None, None
