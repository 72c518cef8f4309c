"""Kernels K4 and K4b, ``ms_deform_attn`` forward and backward
(csrc/ms_deform_attn.cu), counterparts of the JAX package's
ops/pallas_msda.py.

Multi-scale deformable attention over all levels in one launch: value
[B, S, M, D], sampling locations [B, Lq, M, L, P, 2] and attention weights
[B, Lq, M, L, P], all f32, give [B, Lq, M*D] f32; the backward gives dvalue,
dlocations and dweights in the operands' layouts. A CPU tensor goes to the
plain version (``ops.msda.ms_deform_attn_core`` and its vjp); a CUDA tensor
launches the kernel (contiguous f32 only) or raises.
``MSDeformAttnFunction`` is the autograd Function the model calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import cuda_build
from .msda import level_starts, ms_deform_attn_core

MAX_LEVELS = 16

# launches of the kernel; only the wrapper's launches add to it
LAUNCHES = {"forward": 0, "backward": 0}


def _check(value, spatial_shapes, locs, weights, dout=None):
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn: no kernel for device {value.device}")
    named = (("value", value), ("sampling_locations", locs), ("attention_weights", weights))
    if dout is not None:
        named += (("the output gradient", dout),)
    for name, t in named:
        if t.device != value.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"ms_deform_attn: {name} must be a contiguous float32 tensor on "
                             f"{value.device}, got {t.dtype} on {t.device}")
    b, s, m, d = value.shape
    l = len(spatial_shapes)
    if not 1 <= l <= MAX_LEVELS or level_starts(spatial_shapes)[-1] != s:
        raise ValueError(f"ms_deform_attn: spatial shapes {tuple(spatial_shapes)} do not cover "
                         f"the {s} positions of value (at most {MAX_LEVELS} levels)")
    if (locs.dim() != 6 or locs.shape[0] != b or locs.shape[2:4] != (m, l) or locs.shape[5] != 2
            or weights.shape != locs.shape[:5] or b < 1 or locs.shape[1] < 1):
        raise ValueError(f"ms_deform_attn: bad shapes value {tuple(value.shape)}, locations "
                         f"{tuple(locs.shape)}, weights {tuple(weights.shape)}")
    if dout is not None and dout.shape != (b, locs.shape[1], m * d):
        raise ValueError(f"ms_deform_attn: bad output gradient shape {tuple(dout.shape)}")


def _level_hw(spatial_shapes):
    return (ctypes.c_int * (2 * len(spatial_shapes)))(*[int(v) for hw in spatial_shapes for v in hw])


@functools.cache
def _fwd_fn():
    ptr, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("ms_deform_attn.cu", "ms_deform_attn_fwd_f32",
                           [ptr, ptr, ptr, ptr, i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int), ptr])


@functools.cache
def _bwd_fn():
    ptr, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("ms_deform_attn.cu", "ms_deform_attn_bwd_f32",
                           [ptr] * 8 + [i] * 7 + [ctypes.POINTER(ctypes.c_int), ptr])


@functools.cache
def _bwd_scratch_fn():
    fn = cuda_build.load("ms_deform_attn.cu").ms_deform_attn_bwd_scratch_floats
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_longlong
    return fn


def backward_kernels(batch: int, lq: int, heads: int, dim: int, spatial_shapes, points: int) -> int:
    """How many kernels one backward launches on the card for these shapes,
    as the library plans it: 2 where a (batch, head) slice's queries split
    over blocks (a scratch of partial slices, summed by a second kernel),
    else 1."""
    s = level_starts(spatial_shapes)[-1]
    floats = _bwd_scratch_fn()(batch, s, lq, heads, dim, len(spatial_shapes), points,
                               _level_hw(spatial_shapes))
    if floats < 0:
        raise ValueError(f"ms_deform_attn_backward: no kernel for spatial shapes {tuple(spatial_shapes)}")
    return 2 if floats > 0 else 1


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor, attention_weights: torch.Tensor) -> torch.Tensor:
    """value [B, S, M, D]; spatial_shapes [(H, W), ...] low -> high
    resolution; sampling_locations [B, Lq, M, L, P, 2] (x, y) in [0, 1];
    attention_weights [B, Lq, M, L, P]. Returns [B, Lq, M*D]."""
    if value.device.type == "cpu":
        return ms_deform_attn_core(value, spatial_shapes, sampling_locations, attention_weights)
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    b, s, m, d = value.shape
    _, lq, _, l, p, _ = sampling_locations.shape
    out = torch.empty((b, lq, m * d), dtype=torch.float32, device=value.device)
    fn = _fwd_fn()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = fn(value.data_ptr(), sampling_locations.data_ptr(), attention_weights.data_ptr(),
                 out.data_ptr(), b, s, lq, m, d, l, p, _level_hw(spatial_shapes), stream)
    cuda_build.check_launch(err, "ms_deform_attn")
    LAUNCHES["forward"] += 1
    return out


def ms_deform_attn_backward_reference(value, spatial_shapes, sampling_locations, attention_weights,
                                      dout):
    """Plain backward: the vjp of ``ms_deform_attn_core``. Returns (dvalue,
    dlocations, dweights)."""
    _, vjp = torch.func.vjp(lambda v, lc, a: ms_deform_attn_core(v, spatial_shapes, lc, a),
                            value.detach(), sampling_locations.detach(), attention_weights.detach())
    return vjp(dout)


def ms_deform_attn_backward(value, spatial_shapes, sampling_locations, attention_weights, dout):
    """(dvalue [B, S, M, D], dlocations [B, Lq, M, L, P, 2], dweights
    [B, Lq, M, L, P]) of ``ms_deform_attn`` given the output gradient
    ``dout`` [B, Lq, M*D]."""
    if value.device.type == "cpu":
        return ms_deform_attn_backward_reference(value, spatial_shapes, sampling_locations,
                                                 attention_weights, dout)
    _check(value, spatial_shapes, sampling_locations, attention_weights, dout)
    b, s, m, d = value.shape
    _, lq, _, l, p, _ = sampling_locations.shape
    dvalue = torch.empty_like(value)  # the kernel writes every element
    dloc = torch.empty_like(sampling_locations)
    dweights = torch.empty_like(attention_weights)
    level_hw = _level_hw(spatial_shapes)
    with torch.cuda.device(value.device):
        # the partial (batch, head) slices where a slice's queries are split
        # over blocks (fewer slices than SMs); none otherwise
        floats = _bwd_scratch_fn()(b, s, lq, m, d, l, p, level_hw)
        scratch = torch.empty((floats,), dtype=torch.float32, device=value.device) if floats > 0 else None
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = _bwd_fn()(value.data_ptr(), sampling_locations.data_ptr(), attention_weights.data_ptr(),
                        dout.data_ptr(), dvalue.data_ptr(), dloc.data_ptr(), dweights.data_ptr(),
                        None if scratch is None else scratch.data_ptr(), b, s, lq, m, d, l, p, level_hw, stream)
    cuda_build.check_launch(err, "ms_deform_attn_backward")
    LAUNCHES["backward"] += 1
    return dvalue, dloc, dweights


class MSDeformAttnFunction(torch.autograd.Function):
    """``ms_deform_attn`` with its backward:
    ``MSDeformAttnFunction.apply(value, spatial_shapes, locations, weights)``.
    The backward is kernel K4b for CUDA tensors and the plain core's vjp for
    CPU tensors."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes = tuple(spatial_shapes)
        return ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights)

    @staticmethod
    def backward(ctx, dout):
        value, locs, weights = ctx.saved_tensors
        dvalue, dloc, dweights = ms_deform_attn_backward(value, ctx.spatial_shapes, locs, weights,
                                                         dout.contiguous())
        need = ctx.needs_input_grad
        return (dvalue if need[0] else None, None, dloc if need[2] else None,
                dweights if need[3] else None)
