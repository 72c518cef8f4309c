"""Kernel K4, ``ms_deform_attn`` forward (csrc/ms_deform_attn.cu),
counterpart of the JAX package's ops/pallas_msda.py forward.

Multi-scale deformable attention over all levels in one launch: value
[B, S, M, D], sampling locations [B, Lq, M, L, P, 2] and attention weights
[B, Lq, M, L, P], all f32, give [B, Lq, M*D] f32. A CPU tensor goes to the
plain version (``ops.msda.ms_deform_attn_core``); a CUDA tensor launches the
kernel (contiguous f32 only) or raises. ``MSDeformAttnFunction`` is the
autograd Function the model calls. Its backward, the second half of
pallas_msda.py, belongs to the downstream training port and raises until
then.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import cuda_build
from .msda import level_starts, ms_deform_attn_core

MAX_LEVELS = 16

# launches of the kernel; only the wrapper's launches add to it
LAUNCHES = {"forward": 0}


def _check(value, spatial_shapes, locs, weights):
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn: no kernel for device {value.device}")
    for name, t in (("value", value), ("sampling_locations", locs), ("attention_weights", weights)):
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
    level_hw = (ctypes.c_int * (2 * l))(*[int(v) for hw in spatial_shapes for v in hw])
    ptr, i = ctypes.c_void_p, ctypes.c_int
    fn = cuda_build.bind("ms_deform_attn.cu", "ms_deform_attn_fwd_f32",
                         [ptr, ptr, ptr, ptr, i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int), ptr])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = fn(value.data_ptr(), sampling_locations.data_ptr(), attention_weights.data_ptr(),
                 out.data_ptr(), b, s, lq, m, d, l, p, level_hw, stream)
    cuda_build.check_launch(err, "ms_deform_attn")
    LAUNCHES["forward"] += 1
    return out


class MSDeformAttnFunction(torch.autograd.Function):
    """``ms_deform_attn`` as an autograd node:
    ``MSDeformAttnFunction.apply(value, spatial_shapes, locations, weights)``.
    A gradient through it raises: the backward kernel (pallas_msda.py:191)
    comes with the downstream training port."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        return ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights)

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            "ms_deform_attn has no backward yet: the deformable-attention backward kernel "
            "(pallas_msda.py:191) is ported with the downstream training step")
