"""Kernel K6, ``fused_block_attn``: the attention half of an encoder block in
hand-written kernels (csrc/fused_block_attn.cu), forward and backward, the
counterpart of the JAX package's ops/pallas_block_attn.py:

    y = x + to_out(zorro_attn(to_q(h), to_kv(h))),   h = LN_g2(LN_g1(x)),

both LayerNorms bias-free (f32 statistics, eps 1e-5). The casts are those of
the Pallas bodies: LN1's output, h, q and kv, the probabilities for P.V, each
head's output and the out projection are rounded to the activation dtype
before the residual add; the backward's are listed at
``fused_block_attn_backward_reference``.

Weights are in nn.Linear layout: wq [I, D], wkv [2I, D], wo [D, I], gains
g1, g2 [D] (the JAX function takes the transposes and [1, D] gains); the
backward returns the gradients in the same layout. Both directions are
operators of ops/library.py: on a CPU tensor the plain version, on a CUDA
tensor the kernels (D % 16 == 0, D and I up
to ``MAX_D``, dh in 32, 64, 128) or raises. The bf16 instance: the forward
three (the projection pass, K1's forward, the out projection), the backward
eight (the projection pass, dout, K1's forward with its D epilogue, K1b's
two, the row pass, the weight-gradient product and its reduction). The f32
instance (``*_f32`` in the library, the TPU kernel's f32 path): the forward
six, the backward fifteen, every product and sum in f32.
``fused_block_attn`` is what ``EncoderBlock(fused_block=True)`` calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_attn, cuda_build, library
from .attention import upcast
from .cuda_ffn import bias_free_norm

# launches of the kernels; only the wrappers' launches add to them
# ("attention_with_delta": K6b's attention pass alone, which no path calls;
# "f32_*": the f32 instance)
LAUNCHES = {"forward": 0, "backward": 0, "attention_with_delta": 0, "f32_forward": 0, "f32_backward": 0}
# the widest D (and I) the kernels take: the row products keep a 64-row
# bf16 tile of that width in shared memory beside two 64 x 64 weight windows
# (every width the earlier design took: D = I up to 832, I up to 1,248, D
# up to 1,632)
MAX_D = 1664


def block_attn_supported(n: int, d: int, inner: int) -> bool:
    """The JAX package's gate (pallas_block_attn.py:339): the shapes the
    fused route takes, the same answers on both sides."""
    return (n <= 768 and n % 8 == 0 and inner % 64 == 0
            and (n * n * 4 + 12 * n * max(d, inner) * 4 + 3 * d * inner * 2) <= 14e6)


def _ln_backward(dout, z, rstd, g):
    """Backward of out = z * g (pallas_block_attn.py:56-62): (dx, dg), dg
    summed over every row."""
    dg = (dout * z).reshape(-1, z.shape[-1]).sum(dim=0)
    dz = dout * upcast(g)
    dx = (dz - dz.mean(dim=-1, keepdim=True) - z * (dz * z).mean(dim=-1, keepdim=True)) * rstd
    return dx, dg


def _forward_parts(x, g1, g2, wq, wkv):
    """The double norm with its rounds (pallas_block_attn.py:71-79) and the
    rounded projections: (z1, r1, z2, r2, h, qkv)."""
    dt = x.dtype
    z1, r1, a = bias_free_norm(x, g1)
    z2, r2, h = bias_free_norm(a.to(dt), g2)
    h = h.to(dt)
    q = (upcast(h) @ upcast(wq).t()).to(dt)
    kv = (upcast(h) @ upcast(wkv).t()).to(dt)
    return z1, r1, z2, r2, h, torch.cat([q, kv], dim=-1)


def fused_block_attn_reference(x, types, g1, g2, wq, wkv, wo, heads: int, fusion_type: int):
    """Plain PyTorch version, the JAX ``fused_block_attn_xla``
    (pallas_block_attn.py:293). x [B, N, D]; types [B, N] int (PAD_TYPE =
    padding) -> y [B, N, D]."""
    *_, qkv = _forward_parts(x, g1, g2, wq, wkv)
    out = cuda_attn.zorro_attention_qkv_reference(qkv, heads, types, fusion_type)
    return x + (upcast(out) @ upcast(wo).t()).to(x.dtype)


def fused_block_attn_backward_reference(x, types, g1, g2, wq, wkv, wo, dy, heads: int, fusion_type: int):
    """Plain backward with the cast points of the Pallas body
    (pallas_block_attn.py:108-202): recompute h, q, kv; dout = dy Wo rounded;
    per head the f32 softmax p, P = round(p), o = P V in f32 and round(o) for
    dWo; D = rowsum(dout * o) on the unrounded o; dS = round(p (dP - D));
    dq = round(dS K * scale), dk = round(dS^T Q * scale), dv = round(P^T dout);
    dhid = dq Wq + dkv Wkv in f32; both LayerNorm backwards in f32;
    dx = round(dy + dx_ln). The weight and gain gradients are f32 sums over
    every row, cast once to their parameter's dtype. Returns
    (dx, dg1, dg2, dwq, dwkv, dwo)."""
    dt = x.dtype
    b, n, d = x.shape
    inner = wq.shape[0]
    dh = inner // heads
    scale = dh ** -0.5
    z1, r1, z2, r2, h, qkv = _forward_parts(x, g1, g2, wq, wkv)
    q, k, v = (cuda_attn.heads_view(t, heads) for t in qkv.split(inner, dim=-1))
    dyf = upcast(dy)
    dout = upcast((dyf @ upcast(wo)).to(dt))
    doh = cuda_attn.heads_view(dout, heads)

    s = torch.einsum("bhid,bhjd->bhij", upcast(q), upcast(k)) * scale
    allowed = cuda_attn.zorro_allowed(types, fusion_type)[:, None]
    p = torch.softmax(torch.where(allowed, s, torch.full_like(s, cuda_attn.NEG_INF)), dim=-1)
    pb = upcast(p.to(dt))
    oh = torch.einsum("bhij,bhjd->bhid", pb, upcast(v))
    dv = torch.einsum("bhij,bhid->bhjd", pb, doh)
    dp = torch.einsum("bhid,bhjd->bhij", doh, upcast(v))
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    ds = upcast((p * (dp - delta)).to(dt))
    dq = (torch.einsum("bhij,bhjd->bhid", ds, upcast(k)) * scale).to(dt)
    dk = (torch.einsum("bhij,bhid->bhjd", ds, upcast(q)) * scale).to(dt)
    dq, dk, dv = (upcast(cuda_attn.merge_heads(t).to(dt)) for t in (dq, dk, dv))
    out = upcast(cuda_attn.merge_heads(oh).to(dt))

    def rows(t):
        return t.reshape(b * n, t.shape[-1])

    dwo = rows(dyf).t() @ rows(out)
    hf = rows(upcast(h))
    dwq = rows(dq).t() @ hf
    dkv = torch.cat([dk, dv], dim=-1)
    dwkv = rows(dkv).t() @ hf
    dhid = dq @ upcast(wq) + dkv @ upcast(wkv)
    da, dg2 = _ln_backward(dhid, z2, r2, g2)
    dx_ln, dg1 = _ln_backward(da, z1, r1, g1)
    return ((dyf + dx_ln).to(dt), dg1.to(g1.dtype), dg2.to(g2.dtype), dwq.to(wq.dtype), dwkv.to(wkv.dtype),
            dwo.to(wo.dtype))


def _check(name, x, types, g1, g2, wq, wkv, wo, heads, dy=None):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, N, D], got {tuple(x.shape)}")
    b, n, d = x.shape
    inner = wq.shape[0]
    if x.dtype not in cuda_attn.KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernel takes bfloat16 or float32, got {x.dtype}")
    for what, t, shape in (("x", x, (b, n, d)), ("g1", g1, (d,)), ("g2", g2, (d,)), ("wq", wq, (inner, d)),
                           ("wkv", wkv, (2 * inner, d)), ("wo", wo, (d, inner)), ("dy", dy, (b, n, d))):
        if t is None:
            continue
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: every operand must be {x.dtype} as x is, got {t.dtype} for {what}")
        if tuple(t.shape) != shape or t.device != x.device or not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name}: {what} must be a contiguous, 32-byte aligned tensor of shape {shape} "
                             f"on {x.device}, got {tuple(t.shape)}")
    if d % 16 or d > MAX_D or inner > MAX_D:
        raise ValueError(f"{name}: D = {d} must be a multiple of 16 and D, I = {inner} at most {MAX_D}")
    if inner % heads or inner // heads not in cuda_attn.SUPPORTED_DH:
        raise ValueError(f"{name}: head dim {inner / heads:g} not in {cuda_attn.SUPPORTED_DH}")
    if tuple(types.shape) != (b, n) or types.device != x.device:
        raise ValueError(f"{name}: types must be [B, N] = {(b, n)} on {x.device}")
    return types.to(torch.int32).contiguous()


@functools.cache
def _fwd_fn():
    """The forward's C entry point, bound once."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("fused_block_attn.cu", "fused_block_attn_fwd_bf16",
                           [p] * 10 + [i, i, i, i, i, ctypes.c_float, i, p])


@functools.cache
def _bwd_fn():
    """The backward's C entry point, bound once."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("fused_block_attn.cu", "fused_block_attn_bwd_bf16",
                           [p] * 23 + [i, i, i, i, i, ctypes.c_float, i, i, p])


@functools.cache
def _fwd_f32_fn():
    """The f32 instance's forward entry, bound once."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("fused_block_attn.cu", "fused_block_attn_fwd_f32",
                           [p] * 9 + [i, i, i, i, i, ctypes.c_float, i, p])


@functools.cache
def _bwd_f32_fn():
    """The f32 instance's backward entry, bound once."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("fused_block_attn.cu", "fused_block_attn_bwd_f32",
                           [p] * 14 + [i, i, i, i, i, ctypes.c_float, i, p])


@functools.cache
def _f32_scratch_fn():
    """floats(backward, B, N, D, I, H) of the f32 instance's workspace."""
    fn = cuda_build.load("fused_block_attn.cu").fused_block_attn_f32_scratch_floats
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    return fn


def _f32_scratch(x, backward: bool, inner: int, heads: int):
    b, n, d = x.shape
    floats = _f32_scratch_fn()(int(backward), b, n, d, inner, heads)
    return torch.empty((floats,), dtype=torch.float32, device=x.device)


@functools.cache
def _bwd_sizes_fn():
    """(splits(m, d, inner), row_block(), dh_floats(m, d)): the backward's
    workspace sizes, from its library (the weight gradients' row ranges,
    the row pass's rows a block, its dhid workspace)."""
    lib = cuda_build.load("fused_block_attn.cu")
    lib.fused_block_attn_bwd_splits.argtypes = [ctypes.c_int] * 3
    lib.fused_block_attn_row_block.argtypes = []
    lib.fused_block_attn_bwd_dh_floats.argtypes = [ctypes.c_int] * 2
    lib.fused_block_attn_bwd_splits.restype = lib.fused_block_attn_row_block.restype = ctypes.c_int
    lib.fused_block_attn_bwd_dh_floats.restype = ctypes.c_longlong
    return lib.fused_block_attn_bwd_splits, lib.fused_block_attn_row_block, lib.fused_block_attn_bwd_dh_floats


def _forward_cuda(x, types, g1, g2, wq, wkv, wo, heads, fusion_type):
    types = _check("fused_block_attn", x, types, g1, g2, wq, wkv, wo, heads)
    b, n, d = x.shape
    inner = wq.shape[0]
    y = torch.empty_like(x)
    if x.dtype == torch.float32:
        ws = _f32_scratch(x, False, inner, heads)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _fwd_f32_fn()(x.data_ptr(), types.data_ptr(), g1.data_ptr(), g2.data_ptr(), wq.data_ptr(),
                                wkv.data_ptr(), wo.data_ptr(), y.data_ptr(), ws.data_ptr(), b, n, d, heads,
                                inner // heads, float((inner // heads) ** -0.5), int(fusion_type), stream)
        cuda_build.check_launch(err, "fused_block_attn")
        LAUNCHES["f32_forward"] += 1
        return y
    qkv = torch.empty((b, n, 3 * inner), dtype=x.dtype, device=x.device)  # workspaces
    out = torch.empty((b, n, inner), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fwd_fn()(x.data_ptr(), types.data_ptr(), g1.data_ptr(), g2.data_ptr(), wq.data_ptr(),
                        wkv.data_ptr(), wo.data_ptr(), y.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, n, d, heads,
                        inner // heads, float((inner // heads) ** -0.5), int(fusion_type), stream)
    cuda_build.check_launch(err, "fused_block_attn")
    LAUNCHES["forward"] += 1
    return y


def _backward_cuda(x, types, g1, g2, wq, wkv, wo, dy, heads, fusion_type):
    """The kernels write dWq and dWkv as one [3I, D] slab; an operator's
    outputs start their own storage, so dWkv is copied out of it."""
    types = _check("fused_block_attn_backward", x, types, g1, g2, wq, wkv, wo, heads, dy)
    b, n, d = x.shape
    inner = wq.shape[0]
    if x.dtype == torch.float32:
        return _backward_f32(x, types, g1, g2, wq, wkv, wo, dy, heads, fusion_type)
    m = b * n
    dev, bf = x.device, x.dtype
    splits_fn, row_block_fn, dh_floats_fn = _bwd_sizes_fn()
    with torch.cuda.device(dev):
        splits = splits_fn(m, d, inner)
    row_block = row_block_fn()
    dx, dg1, dg2 = torch.empty_like(x), torch.empty_like(g1), torch.empty_like(g2)
    dw_qkv = torch.empty((3 * inner, d), dtype=bf, device=dev)  # dWq, then dWkv
    dwo = torch.empty_like(wo)
    qkv, dqkv = (torch.empty((b, n, 3 * inner), dtype=bf, device=dev) for _ in range(2))
    h = torch.empty_like(x)
    out, dout = (torch.empty((b, n, inner), dtype=bf, device=dev) for _ in range(2))
    lse, delta = (torch.empty((b, heads, n), dtype=torch.float32, device=dev) for _ in range(2))
    dhid = torch.empty((max(dh_floats_fn(m, d), 1),), dtype=torch.float32, device=dev)
    part = torch.empty((splits * (3 * inner * d + d * inner),), dtype=torch.float32, device=dev)
    vec = torch.empty((-(-m // row_block), 2 * d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bwd_fn()(x.data_ptr(), types.data_ptr(), g1.data_ptr(), g2.data_ptr(), wq.data_ptr(),
                        wkv.data_ptr(), wo.data_ptr(), dy.data_ptr(), dx.data_ptr(), dg1.data_ptr(), dg2.data_ptr(),
                        dw_qkv.data_ptr(), dwo.data_ptr(), qkv.data_ptr(), h.data_ptr(), out.data_ptr(),
                        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), dhid.data_ptr(),
                        part.data_ptr(), vec.data_ptr(), b, n, d, heads, inner // heads, float((inner // heads) ** -0.5),
                        int(fusion_type), splits, stream)
    cuda_build.check_launch(err, "fused_block_attn_backward")
    LAUNCHES["backward"] += 1
    return dx, dg1, dg2, dw_qkv[:inner], dw_qkv[inner:].clone(), dwo


def _backward_f32(x, types, g1, g2, wq, wkv, wo, dy, heads, fusion_type):
    """The f32 instance's backward on checked operands."""
    b, n, d = x.shape
    inner = wq.shape[0]
    dx, dg1, dg2, dwo = torch.empty_like(x), torch.empty_like(g1), torch.empty_like(g2), torch.empty_like(wo)
    dw_qkv = torch.empty((3 * inner, d), dtype=x.dtype, device=x.device)  # dWq, then dWkv
    ws = _f32_scratch(x, True, inner, heads)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _bwd_f32_fn()(x.data_ptr(), types.data_ptr(), g1.data_ptr(), g2.data_ptr(), wq.data_ptr(),
                            wkv.data_ptr(), wo.data_ptr(), dy.data_ptr(), dx.data_ptr(), dg1.data_ptr(),
                            dg2.data_ptr(), dw_qkv.data_ptr(), dwo.data_ptr(), ws.data_ptr(), b, n, d, heads,
                            inner // heads, float((inner // heads) ** -0.5), int(fusion_type), stream)
    cuda_build.check_launch(err, "fused_block_attn_backward")
    LAUNCHES["f32_backward"] += 1
    return dx, dg1, dg2, dw_qkv[:inner], dw_qkv[inner:].clone(), dwo


@functools.cache
def _attend_fn():
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("fused_block_attn.cu", "fused_block_attn_attend_bf16",
                           [p] * 6 + [i, i, i, i, ctypes.c_float, i, p])


def attention_with_delta_reference(qkv, types, dout, heads: int, fusion_type: int):
    """Plain version of K6b's attention pass: (round(o), lse, D) with o the
    f32 head outputs (P = round(p) times V) and D = rowsum(dout * o) on the
    unrounded o (pallas_block_attn.py:160); [B, N, I], [B, H, N], [B, H,
    N]."""
    inner = qkv.shape[-1] // 3
    q, k, v = qkv.split(inner, dim=-1)
    s = cuda_attn._scores(q, k, heads, cuda_attn.zorro_allowed(types, fusion_type), (inner // heads) ** -0.5)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhij,bhjd->bhid", upcast(p.to(qkv.dtype)), upcast(cuda_attn.heads_view(v, heads)))
    delta = (upcast(cuda_attn.heads_view(dout, heads)) * o).sum(dim=-1)
    return cuda_attn.merge_heads(o).to(qkv.dtype), lse, delta


def attention_with_delta(qkv, types, dout, heads: int, fusion_type: int):
    """K6b's attention pass alone (K1's forward with its D epilogue), for
    holding it against K1 and its plain version: qkv [B, N, 3I], types
    [B, N], dout [B, N, I] -> (out [B, N, I], lse [B, H, N], delta [B, H,
    N])."""
    if qkv.device.type == "cpu":
        return attention_with_delta_reference(qkv, types, dout, heads, fusion_type)
    if qkv.dtype != torch.bfloat16:  # the f32 instance's backward reads D from the stored, unrounded o
        raise TypeError(f"attention_with_delta: K6b's attention pass is the bf16 instance's, got {qkv.dtype}")
    types = cuda_attn.check_qkv("attention_with_delta", qkv, heads, types, fusion_type)
    b, n, three_i = qkv.shape
    inner = three_i // 3
    cuda_attn._check_tensor("attention_with_delta", "dout", dout, (b, n, inner), torch.bfloat16, qkv.device)
    out = torch.empty((b, n, inner), dtype=qkv.dtype, device=qkv.device)
    lse, delta = (torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device) for _ in range(2))
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = _attend_fn()(qkv.data_ptr(), types.data_ptr(), dout.data_ptr(), out.data_ptr(), lse.data_ptr(),
                           delta.data_ptr(), b, n, heads, inner // heads, float((inner // heads) ** -0.5),
                           int(fusion_type), stream)
    cuda_build.check_launch(err, "attention_with_delta")
    LAUNCHES["attention_with_delta"] += 1
    return out, lse, delta


def _setup(ctx, inputs, output):
    *tensors, heads, fusion_type = inputs
    ctx.save_for_backward(*tensors)
    ctx.args = (heads, fusion_type)


def _grad(ctx, dy):
    x, types, g1, g2, wq, wkv, wo = ctx.saved_tensors
    dx, dg1, dg2, dwq, dwkv, dwo = fused_block_attn_backward(x, types, g1, g2, wq, wkv, wo, dy.contiguous(),
                                                             *ctx.args)
    return dx, None, dg1, dg2, dwq, dwkv, dwo, None, None


_BACKWARD = library.define(
    "fused_block_attn_backward",
    "(Tensor x, Tensor types, Tensor g1, Tensor g2, Tensor wq, Tensor wkv, Tensor wo, Tensor dy, int heads,"
    " int fusion_type) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    fused_block_attn_backward_reference, _backward_cuda,
    lambda x, types, g1, g2, wq, wkv, wo, dy, heads, fusion_type: tuple(
        torch.empty_like(t) for t in (x, g1, g2, wq, wkv, wo)))
_FORWARD = library.define(
    "fused_block_attn",
    "(Tensor x, Tensor types, Tensor g1, Tensor g2, Tensor wq, Tensor wkv, Tensor wo, int heads,"
    " int fusion_type) -> Tensor",
    fused_block_attn_reference, _forward_cuda,
    lambda x, types, g1, g2, wq, wkv, wo, heads, fusion_type: torch.empty_like(x), _grad, _setup)


def fused_block_attn(x, types, g1, g2, wq, wkv, wo, heads: int, fusion_type: int):
    """y [B, N, D] of the attention half-block; x [B, N, D], types [B, N].
    Differentiable: the operator's backward is K6b, which recomputes the
    rest from the inputs, as the TPU kernel does."""
    return _FORWARD(x, types, g1, g2, wq, wkv, wo, heads, fusion_type)


def fused_block_attn_backward(x, types, g1, g2, wq, wkv, wo, dy, heads: int, fusion_type: int):
    """(dx, dg1, dg2, dwq, dwkv, dwo) of ``fused_block_attn``, weights in
    nn.Linear layout."""
    return _BACKWARD(x, types, g1, g2, wq, wkv, wo, dy, heads, fusion_type)


class FusedBlockAttn:
    """``fused_block_attn`` with its gradient, called as an autograd
    Function is: ``FusedBlockAttn.apply(x, types, g1, g2, wq, wkv, wo,
    heads, fusion_type)``."""

    apply = staticmethod(fused_block_attn)
