"""Kernel K1, ``zorro_attention``: multi-head self-attention
(csrc/zorro_attention.cu), forward and backward, over the fused [B, N, 3I]
qkv projection (``zorro_attention_qkv``) or over separate q, k, v
[B, N, I] (``zorro_attention_packed``).

Counterpart of the JAX package's ops/pallas_attn.py (the zorro-masked
encoder attention: the fused-slab kernels and, for separate q, k, v,
``zorro_self_attention_packed``) and ops/pallas_small_attn.py (the decoder's
unmasked attention). With ``types`` the Zorro mask applies: a query attends a
key iff they have the same token type, or the query is a fusion token and the
key is not padding (``PAD_TYPE``). Without ``types`` nothing is masked.

The scale multiplies the f32 scores (q.k) * scale, then masked scores become
the finite ``NEG_INF`` of pallas_attn.py:37, in the kernels and the plain
versions alike. The forward can also return the f32 row log-sum-exp
``lse`` [B, H, N]; the backward recomputes the probabilities from it.

Each direction of each form is an operator of ops/library.py
(``zorro_attention_qkv``, ``zorro_attention_packed`` and their
``*_backward``): on a CPU tensor the plain version, on a CUDA tensor the
kernel (its bf16 instance or its f32 one, ``*_f32`` in the library, the
TPU kernels' f32 path), or an error on any other dtype. The public
functions below call the operators and are differentiable through them;
``ZorroAttentionQKV.apply`` and ``ZorroAttentionPacked.apply`` are the
same calls in an autograd Function's calling form. ``launch_attention``
and ``launch_attention_backward`` drive the kernel on any operand view,
with an optional tile-skip table (ops/cuda_zorro_sparse.py).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from . import cuda_build, library
from .attention import upcast, zorro_mask_from_padded_types

PAD_TYPE = 255
NEG_INF = -0.7 * torch.finfo(torch.float32).max
SUPPORTED_DH = (32, 64, 128)

# launches of the kernels, per mode and instance (``_f32``: the f32
# instance); only the wrappers' launches add to them
LAUNCHES = {"zorro": 0, "none": 0, "zorro_backward": 0, "none_backward": 0,
            "zorro_f32": 0, "none_f32": 0, "zorro_f32_backward": 0, "none_f32_backward": 0}
# the separate-q/k/v mode (zorro_attention_packed)
PACKED_LAUNCHES = {"zorro": 0, "zorro_backward": 0, "zorro_f32": 0, "zorro_f32_backward": 0}
# the dtypes the kernels take, and the suffix of each instance's C entries
KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def launch_key(mode: str, dtype: torch.dtype, backward: bool = False) -> str:
    """The launch counter of ``mode`` for the instance of ``dtype``:
    "zorro", "zorro_f32", "zorro_backward", "zorro_f32_backward"."""
    return mode + ("_f32" if dtype == torch.float32 else "") + ("_backward" if backward else "")


def heads_view(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, N, H*dh] -> [B, H, N, dh]."""
    b, n, inner = t.shape
    return t.reshape(b, n, heads, inner // heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[B, H, N, dh] -> [B, N, H*dh]."""
    b, h, n, dh = t.shape
    return t.transpose(1, 2).reshape(b, n, h * dh)


def zorro_allowed(types: Optional[torch.Tensor], fusion_type: Optional[int]) -> Optional[torch.Tensor]:
    """The zorro mask [B, N, N] (True = the query attends the key), or None
    without types."""
    if types is None:
        return None
    return zorro_mask_from_padded_types(types, fusion_type, PAD_TYPE)


def _scores(q, k, heads, allowed, scale):
    """The scaled, masked f32 scores [B, H, N, N]."""
    s = torch.einsum("bhid,bhjd->bhij", upcast(heads_view(q, heads)), upcast(heads_view(k, heads))) * scale
    if allowed is not None:
        s = torch.where(allowed[:, None], s, torch.full_like(s, NEG_INF))
    return s


def masked_attention_reference(q, k, v, heads: int, allowed: Optional[torch.Tensor], scale: float,
                               return_lse: bool = False):
    """The plain forward on q, k, v [B, N, I] under a [B, N, N] mask (None:
    unmasked): f32 scores and softmax, probabilities cast to the activation
    dtype for the value product. Returns [B, N, I] (and lse [B, H, N])."""
    s = _scores(q, k, heads, allowed, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhij,bhjd->bhid", upcast(p.to(q.dtype)), upcast(heads_view(v, heads)))
    out = merge_heads(out).to(q.dtype)
    return (out, lse) if return_lse else out


def masked_attention_backward_reference(q, k, v, allowed, o, lse, do, heads: int, scale: float):
    """The plain backward with the cast points of the Pallas bodies
    (pallas_attn.py:378-416 and :529-664 classic form,
    pallas_small_attn.py:70): P = exp(s - lse) in f32, D = rowsum(dO * O) in
    f32 on the stored O, dV = P(bf16)^T dO, dS = P * (dP - D) cast to the
    activation dtype, dQ = dS K * scale, dK = dS^T Q * scale. Returns
    (dq, dk, dv), each [B, N, I] in q's dtype."""
    dtype = q.dtype
    p = torch.exp(_scores(q, k, heads, allowed, scale) - lse[..., None])
    dof = upcast(heads_view(do, heads))
    d = (dof * upcast(heads_view(o, heads))).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhij,bhid->bhjd", upcast(p.to(dtype)), dof)
    dp = torch.einsum("bhid,bhjd->bhij", dof, upcast(heads_view(v, heads)))
    ds = upcast((p * (dp - d)).to(dtype))
    dq = torch.einsum("bhij,bhjd->bhid", ds, upcast(heads_view(k, heads))) * scale
    dk = torch.einsum("bhij,bhid->bhjd", ds, upcast(heads_view(q, heads))) * scale
    return tuple(merge_heads(t).to(dtype) for t in (dq, dk, dv))


def default_scale(inner: int, heads: int, scale: Optional[float]) -> float:
    return (inner // heads) ** -0.5 if scale is None else scale


def zorro_attention_qkv_reference(qkv: torch.Tensor, heads: int,
                                  types: Optional[torch.Tensor] = None,
                                  fusion_type: Optional[int] = None,
                                  scale: Optional[float] = None, return_lse: bool = False):
    """Plain PyTorch version, the JAX ``_packed_qkv_xla`` (pallas_attn.py:775)
    with types and ``small_attention_qkv_xla`` (pallas_small_attn.py:179)
    without. qkv [B, N, 3I] -> [B, N, I] (and lse)."""
    inner = qkv.shape[-1] // 3
    q, k, v = qkv.split(inner, dim=-1)
    return masked_attention_reference(q, k, v, heads, zorro_allowed(types, fusion_type),
                                      default_scale(inner, heads, scale), return_lse)


def zorro_attention_qkv_backward_reference(qkv, types, o, lse, do, heads: int,
                                           fusion_type: Optional[int] = None,
                                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain backward (``masked_attention_backward_reference``) on the fused
    slab. Returns dqkv [B, N, 3I] in qkv's dtype."""
    inner = qkv.shape[-1] // 3
    q, k, v = qkv.split(inner, dim=-1)
    grads = masked_attention_backward_reference(q, k, v, zorro_allowed(types, fusion_type), o, lse, do,
                                                heads, default_scale(inner, heads, scale))
    return torch.cat(grads, dim=-1)


def zorro_attention_packed_reference(q, k, v, types, heads: int, fusion_type: int,
                                     scale: Optional[float] = None, return_lse: bool = False):
    """Plain version of ``zorro_self_attention_packed`` (pallas_attn.py:861):
    q, k, v [B, N, H*dh] -> [B, N, H*dh] (and lse)."""
    return masked_attention_reference(q, k, v, heads, zorro_allowed(types, fusion_type),
                                      default_scale(q.shape[-1], heads, scale), return_lse)


def zorro_attention_packed_backward_reference(q, k, v, types, o, lse, do, heads: int, fusion_type: int,
                                              scale: Optional[float] = None):
    """Plain backward of the separate-q/k/v form (pallas_attn.py:378-416):
    (dq, dk, dv)."""
    return masked_attention_backward_reference(q, k, v, zorro_allowed(types, fusion_type), o, lse, do,
                                               heads, default_scale(q.shape[-1], heads, scale))


def _check_tensor(name, what, t, shape, dtype, device):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name}: {what} must be a contiguous, 16-byte aligned {dtype} tensor of shape "
                         f"{tuple(shape)} on {device}")


def check_kernel_dtype(name, t):
    """Raises unless ``t`` is a CUDA tensor of a dtype the kernels take
    (bfloat16 or float32)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    if t.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernel takes bfloat16 or float32, got {t.dtype}")


def _check_heads(name, inner, heads):
    if inner % heads or inner // heads not in SUPPORTED_DH:
        raise ValueError(f"{name}: head dim {inner / heads:g} ({inner} / {heads} heads) not in {SUPPORTED_DH}")


def _check_types(name, types, b, n, fusion_type, device):
    if types is None:
        return None
    if tuple(types.shape) != (b, n) or types.device != device:
        raise ValueError(f"{name}: types must be [B, N] = {(b, n)} on {device}")
    if fusion_type is None:
        raise ValueError(f"{name}: fusion_type is needed with types")
    return types.to(torch.int32).contiguous()  # no copy for the model's int32 types


def check_qkv(name, qkv, heads, types, fusion_type):
    check_kernel_dtype(name, qkv)
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"{name}: bad qkv shape {tuple(qkv.shape)}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be contiguous and 16-byte aligned")
    b, n, three_i = qkv.shape
    _check_heads(name, three_i // 3, heads)
    return _check_types(name, types, b, n, fusion_type, qkv.device)


def _check_separate(name, q, k, v, heads, types, fusion_type):
    check_kernel_dtype(name, q)
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be [B, N, H*dh], got {tuple(q.shape)}")
    for what, t in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, what, t, q.shape, q.dtype, q.device)
    b, n, inner = q.shape
    _check_heads(name, inner, heads)
    if types is None:
        raise ValueError(f"{name}: the separate-q/k/v form is zorro-masked and needs types")
    return _check_types(name, types, b, n, fusion_type, q.device)


def slab_view(qkv):
    """The (q, k, v) base pointers and token stride of a fused [B, N, 3I]
    slab."""
    inner = qkv.shape[-1] // 3
    step = inner * qkv.element_size()
    return qkv.data_ptr(), qkv.data_ptr() + step, qkv.data_ptr() + 2 * step, 3 * inner


@functools.cache
def _forward_entry(dtype: torch.dtype):
    """K1's C entry point for ``dtype`` (``zorro_attention_bf16`` or
    ``zorro_attention_f32``), bound once."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return cuda_build.bind("zorro_attention.cu", f"zorro_attention_{KERNEL_DTYPES[dtype]}",
                           [p, p, p, ll, ll, p, p, i, p, p, i, i, i, i, ll, ll, ll, ctypes.c_float, i, i, p])


@functools.cache
def _backward_entry(dtype: torch.dtype):
    """K1b's C entry point for ``dtype``, bound once."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return cuda_build.bind("zorro_attention.cu", f"zorro_attention_bwd_{KERNEL_DTYPES[dtype]}",
                           [p, p, p, ll, ll, p, p, i, p, p, p, p, p, p, ll, ll, p, i, i, i, i, ll,
                            ctypes.c_float, i, i, p])


def _on_device(device, launch):
    """Calls ``launch(stream)`` with the current stream of ``device``,
    entering the device's context only when it is not the current device."""
    if device.index is None or device.index == torch.cuda.current_device():
        return launch(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return launch(torch.cuda.current_stream(device).cuda_stream)


def launch_attention(view: Sequence[int], b: int, n: int, inner: int, heads: int, device,
                     types: Optional[torch.Tensor], fusion_type: Optional[int], scale: float,
                     return_lse: bool, active: Optional[torch.Tensor] = None, dtype=torch.bfloat16):
    """Launches K1's instance for ``dtype`` on the operand view (q, k, v
    base pointers and their token stride; batch rows lie n * stride apart)
    with checked int32 ``types`` [B, N] (or None) and an optional int32
    activity table ``active`` [B, 1, nt * nt] of 128-token tiles. Returns
    out [B, N, I] and the lse [B, H, N] or None. Counts nothing: the callers
    count."""
    out = torch.empty((b, n, inner), dtype=dtype, device=device)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=device) if return_lse else None
    nt = 0 if active is None else math.isqrt(active.shape[-1])
    q_ptr, k_ptr, v_ptr, rstride = view
    err = _on_device(device, lambda stream: _forward_entry(dtype)(
        q_ptr, k_ptr, v_ptr, n * rstride, rstride, 0 if types is None else types.data_ptr(),
        0 if active is None else active.data_ptr(), nt, out.data_ptr(), 0 if lse is None else lse.data_ptr(),
        b, n, heads, inner // heads, n * inner, inner, 0 if types is None else n, float(scale),
        -1 if fusion_type is None else int(fusion_type), int(types is not None), stream))
    cuda_build.check_launch(err, "zorro_attention")
    return out, lse


def launch_attention_backward(view: Sequence[int], grad_view: Sequence[int], b: int, n: int, inner: int,
                              heads: int, device, types: Optional[torch.Tensor],
                              fusion_type: Optional[int], o: torch.Tensor, lse: torch.Tensor,
                              do: torch.Tensor, scale: float, active: Optional[torch.Tensor] = None,
                              dtype=torch.bfloat16) -> None:
    """Launches K1b's instance for ``dtype``: the forward's operand view,
    its output ``o``, ``lse`` and the output gradient ``do`` (checked here)
    into the gradient view (dq, dk, dv base pointers and their token
    stride)."""
    for what, t, shape, t_dtype in (("o", o, (b, n, inner), dtype),
                                    ("do", do, (b, n, inner), dtype),
                                    ("lse", lse, (b, heads, n), torch.float32)):
        _check_tensor("zorro_attention_backward", what, t, shape, t_dtype, device)
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=device)  # rowsum(dO * O)
    nt = 0 if active is None else math.isqrt(active.shape[-1])
    q_ptr, k_ptr, v_ptr, rstride = view
    dq_ptr, dk_ptr, dv_ptr, g_rstride = grad_view
    err = _on_device(device, lambda stream: _backward_entry(dtype)(
        q_ptr, k_ptr, v_ptr, n * rstride, rstride, 0 if types is None else types.data_ptr(),
        0 if active is None else active.data_ptr(), nt, o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq_ptr,
        dk_ptr, dv_ptr, n * g_rstride, g_rstride, delta.data_ptr(), b, n, heads, inner // heads,
        0 if types is None else n, float(scale), -1 if fusion_type is None else int(fusion_type),
        int(types is not None), stream))
    cuda_build.check_launch(err, "zorro_attention_backward")




# ---------------------------------------------------------------------------
# The operators (ops/library.py): CUDA implementation the launcher, CPU
# implementation the plain version, fake implementation shapes only. The
# forward returns the f32 lse its backward needs, or an empty tensor where
# it keeps none (a forward without a gradient to compute: serving).
# ---------------------------------------------------------------------------

def _no_lse(t: torch.Tensor) -> torch.Tensor:
    """The lse of a forward that keeps none."""
    return t.new_empty((0,), dtype=torch.float32)


def _need_lse(name: str, lse: torch.Tensor) -> None:
    if lse.numel() == 0:
        raise RuntimeError(f"{name}: the forward kept no lse (it ran without a gradient to compute)")


def _qkv_cpu(qkv, types, heads, fusion_type, scale, return_lse):
    out, lse = zorro_attention_qkv_reference(qkv, heads, types, fusion_type, scale, return_lse=True)
    return out, (lse if return_lse else _no_lse(qkv))


def _qkv_cuda(qkv, types, heads, fusion_type, scale, return_lse):
    types = check_qkv("zorro_attention_qkv", qkv, heads, types, fusion_type)
    b, n, three_i = qkv.shape
    out, lse = launch_attention(slab_view(qkv), b, n, three_i // 3, heads, qkv.device, types, fusion_type, scale,
                                return_lse, dtype=qkv.dtype)
    LAUNCHES[launch_key("none" if types is None else "zorro", qkv.dtype)] += 1
    return out, (lse if return_lse else _no_lse(qkv))


def _qkv_fake(qkv, types, heads, fusion_type, scale, return_lse):
    b, n, three_i = qkv.shape
    lse = qkv.new_empty((b, heads, n) if return_lse else (0,), dtype=torch.float32)
    return qkv.new_empty((b, n, three_i // 3)), lse


def _qkv_backward_cpu(qkv, types, o, lse, do, heads, fusion_type, scale):
    return zorro_attention_qkv_backward_reference(qkv, types, o, lse, do, heads, fusion_type, scale)


def _qkv_backward_cuda(qkv, types, o, lse, do, heads, fusion_type, scale):
    _need_lse("zorro_attention_qkv_backward", lse)
    types = check_qkv("zorro_attention_qkv_backward", qkv, heads, types, fusion_type)
    b, n, three_i = qkv.shape
    dqkv = torch.empty_like(qkv)
    launch_attention_backward(slab_view(qkv), slab_view(dqkv), b, n, three_i // 3, heads, qkv.device, types,
                              fusion_type, o, lse, do, scale, dtype=qkv.dtype)
    LAUNCHES[launch_key("none" if types is None else "zorro", qkv.dtype, backward=True)] += 1
    return dqkv


def _qkv_backward_fake(qkv, types, o, lse, do, heads, fusion_type, scale):
    return torch.empty_like(qkv)


def _qkv_setup(ctx, inputs, output):
    qkv, types, heads, fusion_type, scale, _ = inputs
    ctx.save_for_backward(qkv, types, *output)
    ctx.args = (heads, fusion_type, scale)
    ctx.set_materialize_grads(False)  # no zero-filled gradient for the unused lse


def _qkv_grad(ctx, dout, _dlse):
    if dout is None:  # no gradient reaches the output (the lse is not differentiated)
        return (None,) * 6
    qkv, types, out, lse = ctx.saved_tensors
    _need_lse("zorro_attention_qkv", lse)
    return (zorro_attention_qkv_backward(qkv, types, out, lse, dout.contiguous(), *ctx.args),) + (None,) * 5


_QKV_BACKWARD = library.define(
    "zorro_attention_qkv_backward",
    "(Tensor qkv, Tensor? types, Tensor o, Tensor lse, Tensor do, int heads, int? fusion_type, float scale)"
    " -> Tensor", _qkv_backward_cpu, _qkv_backward_cuda, _qkv_backward_fake)
_QKV = library.define(
    "zorro_attention_qkv",
    "(Tensor qkv, Tensor? types, int heads, int? fusion_type, float scale, bool return_lse) -> (Tensor, Tensor)",
    _qkv_cpu, _qkv_cuda, _qkv_fake, _qkv_grad, _qkv_setup)


def _separate_cpu(q, k, v, types, heads, fusion_type, scale, return_lse):
    out, lse = zorro_attention_packed_reference(q, k, v, types, heads, fusion_type, scale, return_lse=True)
    return out, (lse if return_lse else _no_lse(q))


def _separate_cuda(q, k, v, types, heads, fusion_type, scale, return_lse):
    types = _check_separate("zorro_attention_packed", q, k, v, heads, types, fusion_type)
    b, n, inner = q.shape
    view = (q.data_ptr(), k.data_ptr(), v.data_ptr(), inner)
    out, lse = launch_attention(view, b, n, inner, heads, q.device, types, fusion_type, scale, return_lse,
                                dtype=q.dtype)
    PACKED_LAUNCHES[launch_key("zorro", q.dtype)] += 1
    return out, (lse if return_lse else _no_lse(q))


def _separate_fake(q, k, v, types, heads, fusion_type, scale, return_lse):
    b, n, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, heads, n) if return_lse else (0,), dtype=torch.float32)


def _separate_backward_cpu(q, k, v, types, o, lse, do, heads, fusion_type, scale):
    return zorro_attention_packed_backward_reference(q, k, v, types, o, lse, do, heads, fusion_type, scale)


def _separate_backward_cuda(q, k, v, types, o, lse, do, heads, fusion_type, scale):
    _need_lse("zorro_attention_packed_backward", lse)
    types = _check_separate("zorro_attention_packed_backward", q, k, v, heads, types, fusion_type)
    b, n, inner = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    launch_attention_backward((q.data_ptr(), k.data_ptr(), v.data_ptr(), inner),
                              (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), inner), b, n, inner, heads,
                              q.device, types, fusion_type, o, lse, do, scale, dtype=q.dtype)
    PACKED_LAUNCHES[launch_key("zorro", q.dtype, backward=True)] += 1
    return dq, dk, dv


def _separate_backward_fake(q, k, v, types, o, lse, do, heads, fusion_type, scale):
    return torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)


def _separate_setup(ctx, inputs, output):
    q, k, v, types, heads, fusion_type, scale, _ = inputs
    ctx.save_for_backward(q, k, v, types, *output)
    ctx.args = (heads, fusion_type, scale)
    ctx.set_materialize_grads(False)


def _separate_grad(ctx, dout, _dlse):
    if dout is None:
        return (None,) * 8
    q, k, v, types, out, lse = ctx.saved_tensors
    _need_lse("zorro_attention_packed", lse)
    return zorro_attention_packed_backward(q, k, v, types, out, lse, dout.contiguous(), *ctx.args) + (None,) * 5


_SEPARATE_BACKWARD = library.define(
    "zorro_attention_packed_backward",
    "(Tensor q, Tensor k, Tensor v, Tensor types, Tensor o, Tensor lse, Tensor do, int heads, int fusion_type,"
    " float scale) -> (Tensor, Tensor, Tensor)",
    _separate_backward_cpu, _separate_backward_cuda, _separate_backward_fake)
_SEPARATE = library.define(
    "zorro_attention_packed",
    "(Tensor q, Tensor k, Tensor v, Tensor types, int heads, int fusion_type, float scale, bool return_lse)"
    " -> (Tensor, Tensor)", _separate_cpu, _separate_cuda, _separate_fake, _separate_grad, _separate_setup)


def keeps_lse(t: torch.Tensor, return_lse: bool) -> bool:
    """Whether a forward keeps its lse: when asked, or when autograd will
    call its backward."""
    return return_lse or (t.requires_grad and torch.is_grad_enabled())


def zorro_attention_qkv(qkv: torch.Tensor, heads: int, types: Optional[torch.Tensor] = None,
                        fusion_type: Optional[int] = None,
                        scale: Optional[float] = None, return_lse: bool = False):
    """qkv [B, N, 3I] laid out [q | k | v], heads packed inside each;
    types [B, N] int (PAD_TYPE = padding) or None. Returns [B, N, I], and
    with ``return_lse`` also the f32 row log-sum-exp [B, H, N].
    Differentiable: the operator's backward is K1b."""
    out, lse = _QKV(qkv, types, heads, fusion_type, default_scale(qkv.shape[-1] // 3, heads, scale),
                    keeps_lse(qkv, return_lse))
    return (out, lse) if return_lse else out


def zorro_attention_qkv_backward(qkv: torch.Tensor, types: Optional[torch.Tensor],
                                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                                 heads: int, fusion_type: Optional[int] = None,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """dqkv [B, N, 3I] of ``zorro_attention_qkv`` from its input, its output
    ``o``, its ``lse`` and the output gradient ``do``."""
    return _QKV_BACKWARD(qkv, types, o, lse, do, heads, fusion_type,
                         default_scale(qkv.shape[-1] // 3, heads, scale))


def zorro_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, types: torch.Tensor,
                           heads: int, fusion_type: int, scale: Optional[float] = None,
                           return_lse: bool = False):
    """Zorro attention on separate q, k, v [B, N, H*dh] (the JAX
    ``zorro_self_attention_packed``); types [B, N] int (PAD_TYPE = padding).
    Returns [B, N, H*dh], and with ``return_lse`` also the f32 lse
    [B, H, N]. Differentiable."""
    need = return_lse or (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)))
    out, lse = _SEPARATE(q, k, v, types, heads, fusion_type, default_scale(q.shape[-1], heads, scale), need)
    return (out, lse) if return_lse else out


def zorro_attention_packed_backward(q, k, v, types, o, lse, do, heads: int, fusion_type: int,
                                    scale: Optional[float] = None):
    """(dq, dk, dv), each [B, N, H*dh], of ``zorro_attention_packed``."""
    return _SEPARATE_BACKWARD(q, k, v, types, o, lse, do, heads, fusion_type,
                              default_scale(q.shape[-1], heads, scale))


class ZorroAttentionQKV:
    """``zorro_attention_qkv`` with its gradient, called as an autograd
    Function is: ``ZorroAttentionQKV.apply(qkv, heads, types, fusion_type,
    scale)``."""

    @staticmethod
    def apply(qkv, heads, types=None, fusion_type=None, scale=None):
        return zorro_attention_qkv(qkv, heads, types, fusion_type, scale)


class ZorroAttentionPacked:
    """``zorro_attention_packed`` with its gradient:
    ``ZorroAttentionPacked.apply(q, k, v, types, heads, fusion_type, scale)``."""

    @staticmethod
    def apply(q, k, v, types, heads, fusion_type, scale=None):
        return zorro_attention_packed(q, k, v, types, heads, fusion_type, scale)
