"""PointRend point sampling, plain PyTorch (JAX package
losses/set_criterion.py ``point_sample``, its XLA branch :54-63).

detectron2's ``point_sample`` with ``align_corners=False``: masks [N, H, W]
sampled bilinearly at coords [N, P, 2] in [0, 1] as (x, y), zero padding
past the border. Built on ``ops.msda.bilinear_sample``. Kernels K5 / K5b
(``ops/cuda_points.py``) compute the same function and its gradient on the
card; this is their plain version, the one the CPU runs.
"""
from __future__ import annotations

import torch

from .msda import bilinear_sample


def point_sample(masks: torch.Tensor, coords: torch.Tensor, group: int = 1) -> torch.Tensor:
    """masks [N, H, W], coords [N / group, P, 2] (mask i takes coords row
    i // group) -> [N, P] in f32 (f64 for f64 operands)."""
    n, h, w = masks.shape
    if coords.dim() != 3 or coords.shape[-1] != 2 or coords.shape[0] * group != n:
        raise ValueError(f"point_sample: coords {tuple(coords.shape)} do not fit masks "
                         f"{tuple(masks.shape)} in groups of {group}")
    if group > 1:
        coords = coords.repeat_interleave(group, dim=0)
    # grid_sample's align_corners=False pixel mapping, as the JAX code writes it
    gx = 2.0 * coords[..., 0] - 1.0
    gy = 2.0 * coords[..., 1] - 1.0
    px = ((gx + 1.0) * w - 1.0) / 2.0
    py = ((gy + 1.0) * h - 1.0) / 2.0
    out = bilinear_sample(masks[..., None], px, py)[..., 0]
    return out.to(torch.promote_types(masks.dtype, torch.float32))
