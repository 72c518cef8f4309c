"""Bilinear resizes of the downstream path, as ``jax.image.resize(...,
method='bilinear')`` computes them (half-pixel centres, the weights of taps
past the border dropped and the rest renormalized, a triangle filter
widened by the scale when shrinking with ``antialias``)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int], antialias: bool = True) -> torch.Tensor:
    """Resize the last two axes of ``x`` [..., H, W] to ``size``.

    Growing, this is ``F.interpolate(mode='bilinear', align_corners=False)``:
    clamping the source coordinate at the border gives the renormalized
    weights of JAX. Shrinking with ``antialias`` uses PyTorch's antialiased
    bilinear filter, JAX's scaled triangle; without it, plain bilinear taps
    (the Mask2Former mask downsample, mask2former_decoder.py:157-160)."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(size):
        return x
    shrink = size[0] < h or size[1] < w
    flat = x.reshape(-1, 1, h, w) if x.dim() != 4 else x
    out = F.interpolate(flat, size=tuple(size), mode="bilinear", align_corners=False,
                        antialias=antialias and shrink)
    return out.reshape(*x.shape[:-2], *size)


def resize_bilinear_nhwc(x: torch.Tensor, size: Tuple[int, int], antialias: bool = True) -> torch.Tensor:
    """``resize_bilinear`` of an NHWC map's spatial axes."""
    return resize_bilinear(x.permute(0, 3, 1, 2), size, antialias).permute(0, 2, 3, 1)
