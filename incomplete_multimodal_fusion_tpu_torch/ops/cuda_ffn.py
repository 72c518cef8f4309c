"""Kernel K2, ``fused_ffn``: the feed-forward with its hidden activation kept
on chip (csrc/fused_ffn.cu), and its backward (csrc/fused_ffn_bwd.cu),
counterpart of the JAX package's ops/pallas_ffn.py.

Two modes:
  * ``geglu_ffn``: bias-less LayerNorm (f32, eps 1e-5) -> cast -> x.W_in^T
    -> val * gelu(gate) -> cast -> .W_out^T, the FF of every encoder and
    fusion block;
  * ``mlp_ffn``: x.W1^T + b1 -> gelu -> cast -> .W2^T + b2, the decoder MLP.

Weights are in nn.Linear layout ([out, in]); the JAX functions take the
transposes, and the backward returns weight gradients in the port's layout.
GELU is the exact (erf) form. A CPU tensor goes to the plain version; a CUDA
tensor launches the kernel (bf16 only) or raises. ``GegluFFN`` and
``MlpFFN`` are the autograd Functions the model calls.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import cuda_build
from .attention import upcast

LN_EPS = 1e-5

# launches of the kernels, per mode; only the wrappers' launches add to them
LAUNCHES = {"geglu": 0, "mlp": 0, "geglu_backward": 0, "mlp_backward": 0}


def _gelu_parts(g: torch.Tensor):
    """Exact-erf GELU value and derivative (pallas_ffn.py:95-100)."""
    cdf = 0.5 * (1.0 + torch.erf(g * (1.0 / math.sqrt(2.0))))
    pdf = torch.exp(-0.5 * g * g) * (1.0 / math.sqrt(2.0 * math.pi))
    return g * cdf, cdf + g * pdf


def bias_free_norm(x, gamma):
    """Bias-less LayerNorm in f32: (z, rstd, z * gamma)."""
    xf = upcast(x)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    z = (xf - mean) * rstd
    return z, rstd, z * upcast(gamma)


def geglu_ffn_reference(x, gamma, w_in, w_out):
    """Plain PyTorch version, the JAX ``geglu_ffn_xla`` (pallas_ffn.py:268):
    norm in f32, products in f32 from activation-dtype operands, casts after
    the norm and after the GEGLU product. x [M, D], gamma [D],
    w_in [2I, D], w_out [D, I] -> [M, D]."""
    inner = w_out.shape[1]
    xn = bias_free_norm(x, gamma)[2].to(x.dtype)
    u = upcast(xn) @ upcast(w_in).t()
    val, gate = u[:, :inner], u[:, inner:]
    a = (val * F.gelu(gate)).to(x.dtype)
    return (upcast(a) @ upcast(w_out).t()).to(x.dtype)


def geglu_ffn_backward_reference(x, gamma, w_in, w_out, dy):
    """Plain backward with the cast points of the Pallas body
    (pallas_ffn.py:116-176): recompute LN, u and the GEGLU parts; dW_out =
    dy^T a(bf16); da = dy W_out; du = [da gelu(gate), da val gelu'(gate)]
    cast; dW_in = du^T xn; dxn = du W_in; dgamma = sum(dxn z); the bias-less
    LN backward for dx. Returns (dx, dgamma, dW_in, dW_out), each in its
    operand's dtype and layout."""
    dt = x.dtype
    inner = w_out.shape[1]
    z, rstd, xn = bias_free_norm(x, gamma)
    xn = xn.to(dt)
    u = upcast(xn) @ upcast(w_in).t()
    val, gate = u[:, :inner], u[:, inner:]
    gv, gd = _gelu_parts(gate)
    a = (val * gv).to(dt)
    dyf = upcast(dy)
    dw_out = dyf.t() @ upcast(a)
    da = dyf @ upcast(w_out)
    du = upcast(torch.cat([da * gv, da * val * gd], dim=-1).to(dt))
    dw_in = du.t() @ upcast(xn)
    dxn = du @ upcast(w_in)
    dgamma = (dxn * z).sum(dim=0)
    dz = dxn * upcast(gamma)
    dx = (dz - dz.mean(dim=-1, keepdim=True) - z * (dz * z).mean(dim=-1, keepdim=True)) * rstd
    return dx.to(dt), dgamma.to(gamma.dtype), dw_in.to(w_in.dtype), dw_out.to(w_out.dtype)


def mlp_ffn_reference(x, w1, b1, w2, b2):
    """Plain PyTorch version, the JAX ``mlp_ffn_xla`` (pallas_ffn.py:423).
    x [M, D], w1 [H, D], b1 [H], w2 [O, H], b2 [O] -> [M, O]."""
    h = upcast(x) @ upcast(w1).t() + upcast(b1)
    a = F.gelu(h).to(x.dtype)
    return (upcast(a) @ upcast(w2).t() + upcast(b2)).to(x.dtype)


def mlp_ffn_backward_reference(x, w1, b1, w2, b2, dy):
    """Plain backward with the cast points of the Pallas body
    (pallas_ffn.py:303-347): dW2 = dy^T a(bf16), db2 = sum dy,
    da = dy W2, dh = da gelu'(h) cast, dW1 = dh^T x, db1 = sum dh (f32 over
    the cast values), dx = dh W1. Returns (dx, dW1, db1, dW2, db2)."""
    dt = x.dtype
    h = upcast(x) @ upcast(w1).t() + upcast(b1)
    gv, gd = _gelu_parts(h)
    a = gv.to(dt)
    dyf = upcast(dy)
    dw2 = dyf.t() @ upcast(a)
    db2 = dyf.sum(dim=0)
    dh = upcast(((dyf @ upcast(w2)) * gd).to(dt))
    dw1 = dh.t() @ upcast(x)
    db1 = dh.sum(dim=0)
    dx = dh @ upcast(w1)
    return (dx.to(dt), dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


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


def _check_geglu(name, x, gamma, w_in, w_out):
    d = x.shape[1]
    inner = w_out.shape[1]
    if gamma.shape != (d,) or w_in.shape != (2 * inner, d) or w_out.shape != (d, inner) or inner % 16:
        raise ValueError(f"{name}: bad shapes gamma {tuple(gamma.shape)}, w_in "
                         f"{tuple(w_in.shape)}, w_out {tuple(w_out.shape)} for D = {d}")
    return inner


def _check_mlp(name, x, w1, b1, w2, b2):
    d = x.shape[1]
    hidden, out = w1.shape[0], w2.shape[0]
    if (w1.shape != (hidden, d) or b1.shape != (hidden,) or w2.shape != (out, hidden)
            or b2.shape != (out,) or hidden % 16 or out % 16):
        raise ValueError(f"{name}: bad shapes w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
                         f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} for D = {d}")
    return hidden, out


def geglu_ffn(x, gamma, w_in, w_out):
    """Fused LayerNorm + GEGLU FF. x [M, D], gamma [D], w_in [2I, D],
    w_out [D, I] -> [M, D]."""
    if x.device.type == "cpu":
        return geglu_ffn_reference(x, gamma, w_in, w_out)
    _check("geglu_ffn", x, gamma, w_in, w_out)
    inner = _check_geglu("geglu_ffn", x, gamma, w_in, w_out)
    m, d = x.shape
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
    hidden, out = _check_mlp("mlp_ffn", x, w1, b1, w2, b2)
    m, d = x.shape
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


@functools.cache
def _geglu_bwd_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("fused_ffn_bwd.cu", "geglu_ffn_bwd_bf16", [p] * 13 + [i, i, i, p])


@functools.cache
def _mlp_bwd_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("fused_ffn_bwd.cu", "mlp_ffn_bwd_bf16", [p] * 13 + [i, i, i, i, p])


@functools.cache
def _bwd_scratch_fn():
    fn = cuda_build.load("fused_ffn_bwd.cu").ffn_bwd_scratch_floats
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn


def _bwd_scratch(name, x, mode, m, d, hid, d_out):
    """The backward's f32 scratch, as large as its library asks for the
    shapes (mode 0 GEGLU, 1 MLP): the weight-gradient partials, the row
    blocks' vector partials and the wide path's dxn."""
    with torch.cuda.device(x.device):
        floats = _bwd_scratch_fn()(mode, m, d, hid, d_out)
    if floats < 0:
        raise ValueError(f"{name}: no kernel for M = {m}, widths {d}, {hid}, {d_out}")
    return torch.empty((floats,), dtype=torch.float32, device=x.device)


def geglu_ffn_backward(x, gamma, w_in, w_out, dy):
    """(dx, dgamma, dW_in, dW_out) of ``geglu_ffn``, weights in nn.Linear
    layout."""
    if x.device.type == "cpu":
        return geglu_ffn_backward_reference(x, gamma, w_in, w_out, dy)
    _check("geglu_ffn_backward", x, gamma, w_in, w_out, dy)
    inner = _check_geglu("geglu_ffn_backward", x, gamma, w_in, w_out)
    if dy.shape != x.shape:
        raise ValueError(f"geglu_ffn_backward: dy {tuple(dy.shape)} must match x {tuple(x.shape)}")
    m, d = x.shape
    du, a, xn = (torch.empty((m, w), dtype=x.dtype, device=x.device) for w in (2 * inner, inner, d))
    scratch = _bwd_scratch("geglu_ffn_backward", x, 0, m, d, inner, d)
    dx, dgamma = torch.empty_like(x), torch.empty_like(gamma)
    dw_in, dw_out = torch.empty_like(w_in), torch.empty_like(w_out)
    fn = _geglu_bwd_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), gamma.data_ptr(), w_in.data_ptr(), w_out.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), dgamma.data_ptr(), dw_in.data_ptr(), dw_out.data_ptr(),
                 du.data_ptr(), a.data_ptr(), xn.data_ptr(), scratch.data_ptr(), m, d, inner, stream)
    cuda_build.check_launch(err, "geglu_ffn_backward")
    LAUNCHES["geglu_backward"] += 1
    return dx, dgamma, dw_in, dw_out


def mlp_ffn_backward(x, w1, b1, w2, b2, dy):
    """(dx, dW1, db1, dW2, db2) of ``mlp_ffn``, weights in nn.Linear
    layout."""
    if x.device.type == "cpu":
        return mlp_ffn_backward_reference(x, w1, b1, w2, b2, dy)
    _check("mlp_ffn_backward", x, w1, b1, w2, b2, dy)
    hidden, out = _check_mlp("mlp_ffn_backward", x, w1, b1, w2, b2)
    m, d = x.shape
    if dy.shape != (m, out):
        raise ValueError(f"mlp_ffn_backward: dy {tuple(dy.shape)} must be {(m, out)}")
    dh, a = (torch.empty((m, hidden), dtype=x.dtype, device=x.device) for _ in range(2))
    scratch = _bwd_scratch("mlp_ffn_backward", x, 1, m, d, hidden, out)
    dx, dw1, db1 = torch.empty_like(x), torch.empty_like(w1), torch.empty_like(b1)
    dw2, db2 = torch.empty_like(w2), torch.empty_like(b2)
    fn = _mlp_bwd_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
                 dh.data_ptr(), a.data_ptr(), scratch.data_ptr(), m, d, hidden, out, stream)
    cuda_build.check_launch(err, "mlp_ffn_backward")
    LAUNCHES["mlp_backward"] += 1
    return dx, dw1, db1, dw2, db2


class GegluFFN(torch.autograd.Function):
    """``geglu_ffn`` with its backward: ``GegluFFN.apply(x, gamma, w_in,
    w_out)``. Saves the inputs; the backward recomputes the activation."""

    @staticmethod
    def forward(ctx, x, gamma, w_in, w_out):
        ctx.save_for_backward(x, gamma, w_in, w_out)
        return geglu_ffn(x, gamma, w_in, w_out)

    @staticmethod
    def backward(ctx, dy):
        return geglu_ffn_backward(*ctx.saved_tensors, dy.contiguous())


class MlpFFN(torch.autograd.Function):
    """``mlp_ffn`` with its backward: ``MlpFFN.apply(x, w1, b1, w2, b2)``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return mlp_ffn(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        return mlp_ffn_backward(*ctx.saved_tensors, dy.contiguous())
