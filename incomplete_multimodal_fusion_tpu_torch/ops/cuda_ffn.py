"""Kernel K2, ``fused_ffn``: the feed-forward with its hidden activation kept
on chip (csrc/fused_ffn.cu), counterpart of the JAX package's
ops/pallas_ffn.py.

Two modes:
  * ``geglu_ffn``: bias-less LayerNorm (f32, eps 1e-5) -> cast -> x.W_in^T
    -> val * gelu(gate) -> cast -> .W_out^T, the FF of every encoder and
    fusion block;
  * ``mlp_ffn``: x.W1^T + b1 -> gelu -> cast -> .W2^T + b2, the decoder MLP.

Weights are in nn.Linear layout ([out, in]); the JAX functions take the
transposes. GELU is the exact (erf) form. A CPU tensor goes to the plain
version; a CUDA tensor launches the kernel (bf16 only) or raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

LN_EPS = 1e-5

# launches of the kernel, per mode; only the wrappers' launches add to them
LAUNCHES = {"geglu": 0, "mlp": 0}


def geglu_ffn_reference(x, gamma, w_in, w_out):
    """Plain PyTorch version, the JAX ``geglu_ffn_xla`` (pallas_ffn.py:268):
    norm in f32, products in f32 from activation-dtype operands, casts after
    the norm and after the GEGLU product. x [M, D], gamma [D],
    w_in [2I, D], w_out [D, I] -> [M, D]."""
    inner = w_out.shape[1]
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + LN_EPS) * gamma.float()).to(x.dtype)
    u = xn.float() @ w_in.float().t()
    val, gate = u[:, :inner], u[:, inner:]
    a = (val * F.gelu(gate)).to(x.dtype)
    return (a.float() @ w_out.float().t()).to(x.dtype)


def mlp_ffn_reference(x, w1, b1, w2, b2):
    """Plain PyTorch version, the JAX ``mlp_ffn_xla`` (pallas_ffn.py:423).
    x [M, D], w1 [H, D], b1 [H], w2 [O, H], b2 [O] -> [M, O]."""
    h = x.float() @ w1.float().t() + b1.float()
    a = F.gelu(h).to(x.dtype)
    return (a.float() @ w2.float().t() + b2.float()).to(x.dtype)


def _check(name, x, *tensors):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    for t in (x, *tensors):
        if t.device != x.device:
            raise ValueError(f"{name}: all operands must be on {x.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name}: operands must be contiguous and 32-byte aligned")
    if x.dim() != 2 or any(s % 16 for s in x.shape[1:]):
        raise ValueError(f"{name}: x must be [M, D] with D a multiple of 16, got {tuple(x.shape)}")


def geglu_ffn(x, gamma, w_in, w_out):
    """Fused LayerNorm + GEGLU FF. x [M, D], gamma [D], w_in [2I, D],
    w_out [D, I] -> [M, D]."""
    if x.device.type == "cpu":
        return geglu_ffn_reference(x, gamma, w_in, w_out)
    _check("geglu_ffn", x, gamma, w_in, w_out)
    m, d = x.shape
    inner = w_out.shape[1]
    if gamma.shape != (d,) or w_in.shape != (2 * inner, d) or w_out.shape != (d, inner) or inner % 16:
        raise ValueError(f"geglu_ffn: bad shapes gamma {tuple(gamma.shape)}, w_in "
                         f"{tuple(w_in.shape)}, w_out {tuple(w_out.shape)} for D = {d}")
    y = torch.empty_like(x)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = cuda_build.bind("fused_ffn.cu", "geglu_ffn_bf16", [p, p, p, p, p, i, i, i, p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), gamma.data_ptr(), w_in.data_ptr(), w_out.data_ptr(), y.data_ptr(),
                 m, d, inner, stream)
    cuda_build.check_launch(err, "geglu_ffn")
    LAUNCHES["geglu"] += 1
    return y


def mlp_ffn(x, w1, b1, w2, b2):
    """Fused fc1 -> GELU -> fc2. x [M, D], w1 [H, D], b1 [H], w2 [O, H],
    b2 [O] -> [M, O]."""
    if x.device.type == "cpu":
        return mlp_ffn_reference(x, w1, b1, w2, b2)
    _check("mlp_ffn", x, w1, b1, w2, b2)
    m, d = x.shape
    hidden, out = w1.shape[0], w2.shape[0]
    if (w1.shape != (hidden, d) or b1.shape != (hidden,) or w2.shape != (out, hidden)
            or b2.shape != (out,) or hidden % 16 or out % 16):
        raise ValueError(f"mlp_ffn: bad shapes w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
                         f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} for D = {d}")
    y = torch.empty((m, out), dtype=x.dtype, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = cuda_build.bind("fused_ffn.cu", "mlp_ffn_bf16", [p, p, p, p, p, p, i, i, i, i, p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 y.data_ptr(), m, d, hidden, out, stream)
    cuda_build.check_launch(err, "mlp_ffn")
    LAUNCHES["mlp"] += 1
    return y
