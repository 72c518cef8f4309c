"""Kernels K5 / K5b, ``point_sample`` forward and backward
(csrc/point_sample.cu), counterparts of the JAX package's
ops/pallas_points.py.

masks [N, H, W] f32 sampled at coords [N / group, P, 2] f32 (x, y) in
[0, 1] -- mask i at coords row i // group, so the matcher's queries of one
image share their points without a broadcast copy -- give [N, P] f32. A CPU
tensor goes to the plain version (``ops.points.point_sample``); a CUDA
tensor launches the kernel (contiguous f32 only; coords that start off 8
bytes are copied to an aligned buffer first) or raises.
``PointSampleFunction`` is the autograd Function the criterion calls: its
backward gives dmasks always and dcoords when asked for, as the TPU
kernel's backward does (pallas_points.py:63-95).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .points import point_sample as point_sample_reference

# launches of the kernels; only the wrappers' launches add to them
LAUNCHES = {"forward": 0, "backward": 0}


@functools.cache
def _fwd_fn():
    ptr, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("point_sample.cu", "point_sample_fwd_f32", [ptr, ptr, ptr, i, i, i, i, i, ptr])


@functools.cache
def _bwd_fn():
    ptr, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("point_sample.cu", "point_sample_bwd_f32", [ptr, ptr, ptr, ptr, ptr, i, i, i, i, i, ptr])


@functools.cache
def _bwd_writes_all(p: int, h: int, w: int) -> bool:
    """Whether the backward kernel writes every element of dmasks at these
    sizes (else it adds into them, zeroed first)."""
    return bool(cuda_build.bind("point_sample.cu", "point_sample_bwd_writes_all", [ctypes.c_int] * 3)(p, h, w))


def _check(name, masks, coords, group, *more):
    if masks.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {masks.device}")
    for t in (masks, coords, *more):
        if t.device != masks.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous float32 tensors on "
                             f"{masks.device}, got {t.dtype} on {t.device}")
    if masks.dim() != 3 or coords.dim() != 3 or coords.shape[-1] != 2 or group < 1 \
            or coords.shape[0] * group != masks.shape[0] or min(masks.shape) < 1 or coords.shape[1] < 1:
        raise ValueError(f"{name}: bad shapes masks {tuple(masks.shape)}, coords "
                         f"{tuple(coords.shape)} in groups of {group}")
    n, h, w = masks.shape
    p = coords.shape[1]
    if any(t.shape != (n, p) for t in more):
        raise ValueError(f"{name}: the output gradient must be [{n}, {p}]")
    return n, h, w, p


def _aligned(coords: torch.Tensor) -> torch.Tensor:
    """coords as the kernels read them, a point's (x, y) as one 8-byte load:
    a view that starts off 8 bytes is copied into a fresh buffer (which the
    allocator starts on 512 bytes), any other is passed as it is."""
    return coords if coords.data_ptr() % 8 == 0 else coords.clone()


def point_sample_backward_reference(masks, coords, ds, group: int = 1, coords_grad: bool = False):
    """Plain backward: the vjp of the plain forward. Returns (dmasks,
    dcoords or None), dcoords in the layout of ``coords``."""
    masks = masks.detach()
    coords = coords.detach()
    if coords_grad:
        _, vjp = torch.func.vjp(lambda m, c: point_sample_reference(m, c, group), masks, coords)
        return vjp(ds)
    _, vjp = torch.func.vjp(lambda m: point_sample_reference(m, coords, group), masks)
    return vjp(ds)[0], None


def point_sample(masks: torch.Tensor, coords: torch.Tensor, group: int = 1) -> torch.Tensor:
    """masks [N, H, W]; coords [N / group, P, 2]. Returns [N, P]."""
    if masks.device.type == "cpu":
        return point_sample_reference(masks, coords, group)
    n, h, w, p = _check("point_sample", masks, coords, group)
    coords = _aligned(coords)
    out = torch.empty((n, p), dtype=torch.float32, device=masks.device)
    fn = _fwd_fn()
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        err = fn(masks.data_ptr(), coords.data_ptr(), out.data_ptr(), n, p, h, w, group, stream)
    cuda_build.check_launch(err, "point_sample")
    LAUNCHES["forward"] += 1
    return out


def point_sample_backward(masks, coords, ds, group: int = 1, coords_grad: bool = False):
    """(dmasks [N, H, W], dcoords [N / group, P, 2] or None) of
    ``point_sample`` given the output gradient ``ds`` [N, P]."""
    if masks.device.type == "cpu":
        return point_sample_backward_reference(masks, coords, ds, group, coords_grad)
    n, h, w, p = _check("point_sample_backward", masks, coords, group, ds)
    coords = _aligned(coords)
    # the fixed-point path writes every element; the global one adds
    dmasks = (torch.empty_like if _bwd_writes_all(p, h, w) else torch.zeros_like)(masks)
    dcoords = torch.empty((n, p, 2), dtype=torch.float32, device=masks.device) if coords_grad else None
    fn = _bwd_fn()
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        err = fn(masks.data_ptr(), coords.data_ptr(), ds.data_ptr(), dmasks.data_ptr(),
                 dcoords.data_ptr() if coords_grad else None, n, p, h, w, group, stream)
    cuda_build.check_launch(err, "point_sample_backward")
    LAUNCHES["backward"] += 1
    if coords_grad and group > 1:
        dcoords = dcoords.reshape(n // group, group, p, 2).sum(dim=1)
    return dmasks, dcoords


class PointSampleFunction(torch.autograd.Function):
    """``point_sample`` with its backward:
    ``PointSampleFunction.apply(masks, coords, group)``."""

    @staticmethod
    def forward(ctx, masks, coords, group=1):
        ctx.save_for_backward(masks, coords)
        ctx.group = group
        return point_sample(masks, coords, group)

    @staticmethod
    def backward(ctx, ds):
        masks, coords = ctx.saved_tensors
        dmasks, dcoords = point_sample_backward(masks, coords, ds.contiguous(), ctx.group,
                                                coords_grad=ctx.needs_input_grad[1])
        return (dmasks if ctx.needs_input_grad[0] else None), dcoords, None
