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
GELU is the exact (erf) form. Each direction of each mode is an operator of
ops/library.py (``geglu_ffn``, ``mlp_ffn``, ``mlp_ffn_tasks`` and their
backwards): on a CPU tensor the plain version, on a CUDA tensor the kernel,
or an error on any other dtype: bf16 tensors the kernels above, f32
ones their f32 instance (``*_f32`` in the libraries, the TPU kernels' f32
path: every product in three TF32 parts on the tensor cores, every sum in
f32 (csrc/ffn_tf32.cuh); forward 2 launches, 3 where the hidden width splits
over blocks at small M; backward 4). The f32 instance takes d and the output
width up to 256, every model width of the default paths; wider (`base`,
`large`), by that shape rule alone, it runs its FFMA chain (simt_f32.cuh:
forward GEGLU 4 launches, MLP 2; backward 9).
``mlp_ffn_tasks`` is the MLP with a task axis (T MLPs, each with its own
weights, in one launch), the decoder trunks of T tasks batched.

The bf16 kernels take hidden widths that are multiples of 16. A GEGLU inner
width that is not (the `large` config's int(1024 * 8 / 3) = 2730) is
zero-padded in the weights before the launch (``pad_geglu_hidden``): a
padded val and gate row gives a = val gelu(gate) = 0, which adds nothing to
y, dx or the real rows and columns of the weight gradients, so the padding
is exact; the backward drops the padded gradient rows and columns. The f32
instance takes any width and is launched unpadded.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import cuda_attn, cuda_build, library
from .attention import upcast

LN_EPS = 1e-5

# launches of the kernels, per mode and instance (``_f32``: the f32
# instance); only the wrappers' launches add to them
LAUNCHES = {"geglu": 0, "mlp": 0, "geglu_backward": 0, "mlp_backward": 0,
            "geglu_f32": 0, "mlp_f32": 0, "geglu_f32_backward": 0, "mlp_f32_backward": 0,
            "mlp_tasks": 0, "mlp_tasks_f32": 0}


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
    if x.dtype not in cuda_attn.KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernel takes bfloat16 or float32, got {x.dtype}")
    for t in (x, *tensors):
        if t.device != x.device:
            raise ValueError(f"{name}: all operands must be on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: every operand must be {x.dtype} as x is, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name}: operands must be contiguous and 32-byte aligned")
    if x.dim() != 2 or any(s % 16 for s in x.shape[1:]):
        raise ValueError(f"{name}: x must be [M, D] with D a multiple of 16, got {tuple(x.shape)}")


def _check_geglu(name, x, gamma, w_in, w_out):
    d = x.shape[1]
    inner = w_out.shape[1]
    if gamma.shape != (d,) or w_in.shape != (2 * inner, d) or w_out.shape != (d, inner):
        raise ValueError(f"{name}: bad shapes gamma {tuple(gamma.shape)}, w_in "
                         f"{tuple(w_in.shape)}, w_out {tuple(w_out.shape)} for D = {d}")
    return inner


HIDDEN_MULTIPLE = 16  # the kernels' hidden widths


def pad_geglu_hidden(w_in, w_out):
    """GEGLU weights with the inner width I zero-padded up to a multiple of
    HIDDEN_MULTIPLE: w_in [2I, D] -> [2Ip, D] (val rows, zeros, gate rows,
    zeros), w_out [D, I] -> [D, Ip] (zero columns). The padded units give
    a = 0, so the function is unchanged. Weights already aligned come back
    as they are."""
    inner = w_out.shape[1]
    pad = -inner % HIDDEN_MULTIPLE
    if pad == 0:
        return w_in, w_out
    zeros = w_in.new_zeros((pad, w_in.shape[1]))
    w_in = torch.cat([w_in[:inner], zeros, w_in[inner:], zeros]).contiguous()
    return w_in, F.pad(w_out, (0, pad)).contiguous()


def unpad_geglu_grads(dw_in, dw_out, inner: int):
    """The gradients of the unpadded weights from those of
    ``pad_geglu_hidden``'s: the val and gate rows of dW_in and the first
    ``inner`` columns of dW_out."""
    padded = dw_out.shape[1]
    if padded == inner:
        return dw_in, dw_out
    return (torch.cat([dw_in[:inner], dw_in[padded:padded + inner]]),
            dw_out[:, :inner].contiguous())


def _check_mlp(name, x, w1, b1, w2, b2):
    d = x.shape[1]
    hidden, out = w1.shape[0], w2.shape[0]
    if (w1.shape != (hidden, d) or b1.shape != (hidden,) or w2.shape != (out, hidden)
            or b2.shape != (out,) or hidden % 16 or out % 16):
        raise ValueError(f"{name}: bad shapes w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
                         f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} for D = {d}")
    return hidden, out


@functools.cache
def _geglu_fwd_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("fused_ffn.cu", "geglu_ffn_bf16", [p] * 6 + [i, i, i, p])


@functools.cache
def _mlp_fwd_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("fused_ffn.cu", "mlp_ffn_bf16", [p] * 7 + [i, i, i, i, p])


@functools.cache
def _fwd_workspace_fn():
    fn = cuda_build.load("fused_ffn.cu").ffn_fwd_workspace_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn


@functools.cache
def _fwd_kernels_fn():
    fn = cuda_build.load("fused_ffn.cu").ffn_fwd_kernels
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn


def forward_kernels(geglu: bool, m: int, d: int, hid: int, d_out: int) -> int:
    """How many kernels one forward launches on the card for these shapes
    (M rows, input width d, GEGLU inner or MLP hidden width ``hid``, output
    width ``d_out``), as the library plans it: 1, or 2 where the row path
    splits the hidden width at small M; 3 (GEGLU) or 2 (MLP) past the row
    path's widths. A GEGLU inner width is counted padded, as launched."""
    if geglu:
        hid += -hid % HIDDEN_MULTIPLE
    n = _fwd_kernels_fn()(0 if geglu else 1, m, d, hid, d_out)
    if n < 0:
        raise ValueError(f"fused_ffn: no kernel for M = {m}, widths {d}, {hid}, {d_out}")
    return n


@functools.cache
def _f32_plan_fn(source: str, name: str):
    """An int query (a, m, d, hid, d_out) of an f32 library: kernels a call."""
    fn = getattr(cuda_build.load(source), name)
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn


def forward_kernels_f32(geglu: bool, m: int, d: int, hid: int, d_out: int, tasks: int = 0) -> int:
    """How many kernels one f32 forward launches on the card (``tasks``:
    ``mlp_ffn_tasks`` over that many tasks): the split of the weights and the
    row kernel, and the reduction where the hidden width splits over blocks;
    past d or d_out 256 the FFMA chain's 4 (GEGLU) or 2 (MLP)."""
    if tasks:
        n = _f32_plan_fn("fused_ffn.cu", "ffn_fwd_tasks_f32_kernels")(tasks, m, d, hid, d_out)
    else:
        n = _f32_plan_fn("fused_ffn.cu", "ffn_fwd_f32_kernels")(0 if geglu else 1, m, d, hid, d_out)
    if n < 0:
        raise ValueError(f"fused_ffn: no f32 kernel for M = {m}, widths {d}, {hid}, {d_out}")
    return n


def backward_kernels_f32(geglu: bool, m: int, d: int, hid: int, d_out: int) -> int:
    """How many kernels one f32 backward launches: 4 (the split of the
    weights, the row pass, the weight gradients, the reduction), or the
    FFMA chain's 9 past d or d_out 256."""
    return _f32_plan_fn("fused_ffn_bwd.cu", "ffn_bwd_f32_kernels")(0 if geglu else 1, m, d, hid, d_out)


def _fwd_workspace(name, x, mode, m, d, hid, d_out):
    """The forward's workspace (mode 0 GEGLU, 1 MLP), as large as its library
    asks for the shapes: the row path's partial outputs where it splits the
    hidden width at small M, xn and the activation past the row path's
    widths; None where it needs none."""
    size = _fwd_workspace_fn()(mode, m, d, hid, d_out)
    if size < 0:
        raise ValueError(f"{name}: no kernel for M = {m}, widths {d}, {hid}, {d_out}")
    return torch.empty((size,), dtype=torch.uint8, device=x.device) if size else None


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.cache
def _f32_fn(name: str, pointers: int, ints: int):
    """An entry of the f32 instance (pointers, then ints, then the stream),
    bound once."""
    source = "fused_ffn_bwd.cu" if "bwd" in name else "fused_ffn.cu"
    return cuda_build.bind(source, name, [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p])


@functools.cache
def _f32_floats_fn(name: str):
    """floats(mode, m, d, hid, d_out) of an f32 workspace."""
    fn = getattr(cuda_build.load("fused_ffn_bwd.cu" if "bwd" in name else "fused_ffn.cu"), name)
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn


def _f32_workspace(x, name, mode, m, d, hid, d_out):
    """The f32 workspace the library asks for (``mode``: 0 GEGLU, 1 MLP, or
    the task count), on x's device: its plan reads the card's SMs."""
    with torch.cuda.device(x.device):
        floats = _f32_floats_fn(name)(mode, m, d, hid, d_out)
    if floats < 0:
        raise ValueError(f"{name}: no kernel for M = {m}, widths {d}, {hid}, {d_out}")
    return torch.empty((floats,), dtype=torch.float32, device=x.device)


def _launch_f32(x, name, pointers, ints, what):
    """Calls the f32 entry ``name`` on x's device and stream."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _f32_fn(name, len(pointers), len(ints))(*pointers, *ints, stream)
    cuda_build.check_launch(err, what)


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


def _geglu_cuda(x, gamma, w_in, w_out):
    _check("geglu_ffn", x, gamma, w_in, w_out)
    _check_geglu("geglu_ffn", x, gamma, w_in, w_out)
    if x.dtype == torch.float32:
        m, d = x.shape
        inner = w_out.shape[1]
        y = torch.empty_like(x)
        ws = _f32_workspace(x, "ffn_fwd_f32_workspace_floats", 0, m, d, inner, d)
        _launch_f32(x, "geglu_ffn_f32", [t.data_ptr() for t in (x, gamma, w_in, w_out, y, ws)], [m, d, inner],
                    "geglu_ffn")
        LAUNCHES["geglu_f32"] += 1
        return y
    w_in, w_out = pad_geglu_hidden(w_in, w_out)
    inner = w_out.shape[1]
    m, d = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        ws = _fwd_workspace("geglu_ffn", x, 0, m, d, inner, d)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _geglu_fwd_fn()(x.data_ptr(), gamma.data_ptr(), w_in.data_ptr(), w_out.data_ptr(), y.data_ptr(),
                              _ptr(ws), m, d, inner, stream)
    cuda_build.check_launch(err, "geglu_ffn")
    LAUNCHES["geglu"] += 1
    return y


def _mlp_cuda(x, w1, b1, w2, b2):
    _check("mlp_ffn", x, w1, b1, w2, b2)
    hidden, out = _check_mlp("mlp_ffn", x, w1, b1, w2, b2)
    m, d = x.shape
    y = torch.empty((m, out), dtype=x.dtype, device=x.device)
    if x.dtype == torch.float32:
        ws = _f32_workspace(x, "ffn_fwd_f32_workspace_floats", 1, m, d, hidden, out)
        _launch_f32(x, "mlp_ffn_f32", [t.data_ptr() for t in (x, w1, b1, w2, b2, y, ws)], [m, d, hidden, out],
                    "mlp_ffn")
        LAUNCHES["mlp_f32"] += 1
        return y
    with torch.cuda.device(x.device):
        ws = _fwd_workspace("mlp_ffn", x, 1, m, d, hidden, out)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _mlp_fwd_fn()(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                            y.data_ptr(), _ptr(ws), m, d, hidden, out, stream)
    cuda_build.check_launch(err, "mlp_ffn")
    LAUNCHES["mlp"] += 1
    return y


def _geglu_backward_cuda(x, gamma, w_in, w_out, dy):
    _check("geglu_ffn_backward", x, gamma, w_in, w_out, dy)
    real_inner = _check_geglu("geglu_ffn_backward", x, gamma, w_in, w_out)
    if dy.shape != x.shape:
        raise ValueError(f"geglu_ffn_backward: dy {tuple(dy.shape)} must match x {tuple(x.shape)}")
    if x.dtype == torch.float32:
        m, d = x.shape
        dx, dgamma = torch.empty_like(x), torch.empty_like(gamma)
        dw_in, dw_out = torch.empty_like(w_in), torch.empty_like(w_out)
        scratch = _f32_workspace(x, "ffn_bwd_f32_scratch_floats", 0, m, d, real_inner, d)
        _launch_f32(x, "geglu_ffn_bwd_f32", [t.data_ptr() for t in (x, gamma, w_in, w_out, dy, dx, dgamma, dw_in,
                                                                     dw_out, scratch)],
                    [m, d, real_inner], "geglu_ffn_backward")
        LAUNCHES["geglu_f32_backward"] += 1
        return dx, dgamma, dw_in, dw_out
    w_in, w_out = pad_geglu_hidden(w_in, w_out)
    inner = w_out.shape[1]
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
    return (dx, dgamma, *unpad_geglu_grads(dw_in, dw_out, real_inner))


def _mlp_backward_cuda(x, w1, b1, w2, b2, dy):
    _check("mlp_ffn_backward", x, w1, b1, w2, b2, dy)
    hidden, out = _check_mlp("mlp_ffn_backward", x, w1, b1, w2, b2)
    m, d = x.shape
    if dy.shape != (m, out):
        raise ValueError(f"mlp_ffn_backward: dy {tuple(dy.shape)} must be {(m, out)}")
    dx, dw1, db1 = torch.empty_like(x), torch.empty_like(w1), torch.empty_like(b1)
    dw2, db2 = torch.empty_like(w2), torch.empty_like(b2)
    if x.dtype == torch.float32:
        scratch = _f32_workspace(x, "ffn_bwd_f32_scratch_floats", 1, m, d, hidden, out)
        _launch_f32(x, "mlp_ffn_bwd_f32", [t.data_ptr() for t in (x, w1, b1, w2, dy, dx, dw1, db1, dw2, db2,
                                                                   scratch)],
                    [m, d, hidden, out], "mlp_ffn_backward")
        LAUNCHES["mlp_f32_backward"] += 1
        return dx, dw1, db1, dw2, db2
    dh, a = (torch.empty((m, hidden), dtype=x.dtype, device=x.device) for _ in range(2))
    scratch = _bwd_scratch("mlp_ffn_backward", x, 1, m, d, hidden, out)
    fn = _mlp_bwd_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
                 dh.data_ptr(), a.data_ptr(), scratch.data_ptr(), m, d, hidden, out, stream)
    cuda_build.check_launch(err, "mlp_ffn_backward")
    LAUNCHES["mlp_backward"] += 1
    return dx, dw1, db1, dw2, db2




# ---------------------------------------------------------------------------
# K2's MLP with a task axis: T independent MLPs (the decoder trunks of T
# tasks, each with its own weights) in one launch, the task one more grid
# coordinate; what ``jax.vmap`` over pallas_ffn.py's MLP kernel makes of it
# (multimae.py:285-289). Its backward runs K2b's MLP once per task.
# ---------------------------------------------------------------------------

def mlp_ffn_tasks_reference(x, w1, b1, w2, b2):
    """Plain version: ``mlp_ffn_reference`` once per task. x [T, M, D],
    w1 [T, H, D], b1 [T, H], w2 [T, O, H], b2 [T, O] -> [T, M, O]."""
    return torch.stack([mlp_ffn_reference(x[t], w1[t], b1[t], w2[t], b2[t]) for t in range(x.shape[0])])


def _check_mlp_tasks(name, x, w1, b1, w2, b2):
    if x.dim() != 3 or w1.dim() != 3 or b1.dim() != 2 or w2.dim() != 3 or b2.dim() != 2:
        raise ValueError(f"{name}: x must be [T, M, D] and the weights stacked over T, got x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}")
    t = x.shape[0]
    if any(w.shape[0] != t for w in (w1, b1, w2, b2)):
        raise ValueError(f"{name}: every operand must have the task axis of x, {t}")
    _check(name, x[0], w1[0], b1[0], w2[0], b2[0])  # shapes, dtype, device, alignment of the first task
    for v in (x, w1, b1, w2, b2):
        if not v.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return _check_mlp(name, x[0], w1[0], b1[0], w2[0], b2[0])


@functools.cache
def _mlp_tasks_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("fused_ffn.cu", "mlp_ffn_tasks_bf16", [p] * 7 + [i] * 5 + [p])


@functools.cache
def _tasks_plan_fn(name: str):
    """``ffn_fwd_tasks_workspace_bytes`` or ``ffn_fwd_tasks_kernels``:
    (tasks, m, d, hid, d_out) -> bytes or kernels (-1 for shapes the
    kernels do not take)."""
    fn = getattr(cuda_build.load("fused_ffn.cu"), name)
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn


def tasks_forward_kernels(t: int, m: int, d: int, hid: int, d_out: int) -> int:
    """How many kernels one ``mlp_ffn_tasks`` call launches on the card for
    T tasks of these shapes: 1, or 2 where the row path splits the hidden
    width; past the row path's widths 2 a task (the wide path, task by
    task)."""
    n = _tasks_plan_fn("ffn_fwd_tasks_kernels")(t, m, d, hid, d_out)
    if n < 0:
        raise ValueError(f"fused_ffn: no kernel for T = {t}, M = {m}, widths {d}, {hid}, {d_out}")
    return n


def _mlp_tasks_cuda(x, w1, b1, w2, b2):
    hidden, out = _check_mlp_tasks("mlp_ffn_tasks", x, w1, b1, w2, b2)
    t, m, d = x.shape
    y = torch.empty((t, m, out), dtype=x.dtype, device=x.device)
    if x.dtype == torch.float32:
        ws = _f32_workspace(x, "ffn_fwd_tasks_f32_workspace_floats", t, m, d, hidden, out)
        _launch_f32(x, "mlp_ffn_tasks_f32", [v.data_ptr() for v in (x, w1, b1, w2, b2, y, ws)],
                    [t, m, d, hidden, out], "mlp_ffn_tasks")
        LAUNCHES["mlp_tasks_f32"] += 1
        return y
    with torch.cuda.device(x.device):
        size = _tasks_plan_fn("ffn_fwd_tasks_workspace_bytes")(t, m, d, hidden, out)
        if size < 0:
            raise ValueError(f"mlp_ffn_tasks: no kernel for T = {t}, M = {m}, widths {d}, {hidden}, {out}")
        ws = torch.empty((size,), dtype=torch.uint8, device=x.device) if size else None
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _mlp_tasks_fn()(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                              y.data_ptr(), _ptr(ws), t, m, d, hidden, out, stream)
    cuda_build.check_launch(err, "mlp_ffn_tasks")
    LAUNCHES["mlp_tasks"] += 1
    return y


# ---------------------------------------------------------------------------
# The operators (ops/library.py): CUDA implementation the launcher above,
# CPU implementation the plain version, fake implementation shapes only.
# ---------------------------------------------------------------------------

def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _geglu_grad(ctx, dy):
    return geglu_ffn_backward(*ctx.saved_tensors, dy.contiguous())


def _mlp_grad(ctx, dy):
    return mlp_ffn_backward(*ctx.saved_tensors, dy.contiguous())


def _mlp_tasks_grad(ctx, dy):
    """K2b's MLP once per task on that task's rows and weights, the
    gradients stacked over the task axis."""
    x, w1, b1, w2, b2 = ctx.saved_tensors
    dy = dy.contiguous()
    grads = [mlp_ffn_backward(x[t], w1[t], b1[t], w2[t], b2[t], dy[t]) for t in range(x.shape[0])]
    return tuple(torch.stack(g) for g in zip(*grads))


def _empty_like_all(*tensors):
    return tuple(torch.empty_like(t) for t in tensors)


_GEGLU_BACKWARD = library.define(
    "geglu_ffn_backward",
    "(Tensor x, Tensor gamma, Tensor w_in, Tensor w_out, Tensor dy) -> (Tensor, Tensor, Tensor, Tensor)",
    geglu_ffn_backward_reference, _geglu_backward_cuda, lambda x, gamma, w_in, w_out, dy: _empty_like_all(
        x, gamma, w_in, w_out))
_GEGLU = library.define(
    "geglu_ffn", "(Tensor x, Tensor gamma, Tensor w_in, Tensor w_out) -> Tensor",
    geglu_ffn_reference, _geglu_cuda, lambda x, gamma, w_in, w_out: torch.empty_like(x),
    _geglu_grad, _save_inputs)
_MLP_BACKWARD = library.define(
    "mlp_ffn_backward",
    "(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor dy) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    mlp_ffn_backward_reference, _mlp_backward_cuda, lambda x, w1, b1, w2, b2, dy: _empty_like_all(
        x, w1, b1, w2, b2))
_MLP = library.define(
    "mlp_ffn", "(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> Tensor",
    mlp_ffn_reference, _mlp_cuda, lambda x, w1, b1, w2, b2: x.new_empty((x.shape[0], w2.shape[0])),
    _mlp_grad, _save_inputs)
_MLP_TASKS = library.define(
    "mlp_ffn_tasks", "(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> Tensor",
    mlp_ffn_tasks_reference, _mlp_tasks_cuda,
    lambda x, w1, b1, w2, b2: x.new_empty((x.shape[0], x.shape[1], w2.shape[1])), _mlp_tasks_grad, _save_inputs)


def geglu_ffn(x, gamma, w_in, w_out):
    """Fused LayerNorm + GEGLU FF. x [M, D], gamma [D], w_in [2I, D],
    w_out [D, I] -> [M, D]. Differentiable: the operator's backward is
    K2b."""
    return _GEGLU(x, gamma, w_in, w_out)


def mlp_ffn(x, w1, b1, w2, b2):
    """Fused fc1 -> GELU -> fc2. x [M, D], w1 [H, D], b1 [H], w2 [O, H],
    b2 [O] -> [M, O]. Differentiable."""
    return _MLP(x, w1, b1, w2, b2)


def mlp_ffn_tasks(x, w1, b1, w2, b2):
    """T fused MLPs in one launch: x [T, M, D], w1 [T, H, D], b1 [T, H],
    w2 [T, O, H], b2 [T, O] -> [T, M, O]. Differentiable: the backward is
    K2b's MLP, once per task."""
    return _MLP_TASKS(x, w1, b1, w2, b2)


def geglu_ffn_backward(x, gamma, w_in, w_out, dy):
    """(dx, dgamma, dW_in, dW_out) of ``geglu_ffn``, weights in nn.Linear
    layout."""
    return _GEGLU_BACKWARD(x, gamma, w_in, w_out, dy)


def mlp_ffn_backward(x, w1, b1, w2, b2, dy):
    """(dx, dW1, db1, dW2, db2) of ``mlp_ffn``, weights in nn.Linear
    layout."""
    return _MLP_BACKWARD(x, w1, b1, w2, b2, dy)


class GegluFFN:
    """``geglu_ffn`` with its gradient, called as an autograd Function is:
    ``GegluFFN.apply(x, gamma, w_in, w_out)``."""

    apply = staticmethod(geglu_ffn)


class MlpFFN:
    """``mlp_ffn`` with its gradient: ``MlpFFN.apply(x, w1, b1, w2, b2)``."""

    apply = staticmethod(mlp_ffn)
