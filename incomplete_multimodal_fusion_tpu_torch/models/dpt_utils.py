"""DPT / ConvNeXt dense-prediction head utilities (JAX package
models/dpt_utils.py; reference pretraining/multimae/output_adapter_utils.py:
ConvNeXtBlock :19-57, ResidualConvUnit_custom :60-123, make_scratch
:125-180, FeatureFusionBlock_custom :182-243, Interpolate :245-276).

No entry point builds them, in the reference or here: they are part of the
published surface, with ``DPTHead`` as the standard DPT wiring of the
parts. NHWC maps; the convolutions run on NCHW views. The bilinear resizes
are the JAX module's explicit interpolation matrices (torch semantics,
``align_corners`` as at each call site), applied as two products.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Dense, LayerNorm
from .vit_adapter import conv_nhwc


def interp_matrix(n_out: int, n_in: int, align_corners: bool) -> torch.Tensor:
    """[n_out, n_in] f32 1-D linear interpolation matrix (dpt_utils.py:34-45)."""
    if n_in == 1 or n_out == 1:
        src = np.zeros(n_out)
    elif align_corners:
        src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    else:
        src = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0, n_in - 1)
    w = np.maximum(0.0, 1.0 - np.abs(src[:, None] - np.arange(n_in)[None, :]))
    return torch.from_numpy((w / w.sum(axis=1, keepdims=True)).astype(np.float32))


def resize_bilinear(x: torch.Tensor, nh: int, nw: int, align_corners: bool = True) -> torch.Tensor:
    """NHWC bilinear resize as two interpolation-matrix products."""
    _, h, w, _ = x.shape
    ah = interp_matrix(nh, h, align_corners).to(device=x.device, dtype=x.dtype)
    aw = interp_matrix(nw, w, align_corners).to(device=x.device, dtype=x.dtype)
    return torch.einsum("pw,bowc->bopc", aw, torch.einsum("oh,bhwc->bowc", ah, x))


class Interpolate(nn.Module):
    """Bilinear resampling by a fixed scale factor (:255-276); the fusion
    blocks pass ``align_corners=True``."""

    def __init__(self, scale_factor: float = 2.0, align_corners: bool = False):
        super().__init__()
        self.scale_factor = scale_factor
        self.align_corners = align_corners

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        return resize_bilinear(x, int(round(h * self.scale_factor)), int(round(w * self.scale_factor)),
                               self.align_corners)


class ConvNeXtBlock(nn.Module):
    """Depthwise 7x7 conv -> LayerNorm (1e-6) -> 4x pointwise MLP (exact
    GELU) -> layer scale ``gamma`` where ``layer_scale_init_value`` > 0 ->
    residual (:19-57)."""

    def __init__(self, dim: int, layer_scale_init_value: float = 0.0):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.pwconv2 = Dense(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), float(layer_scale_init_value)))
                      if layer_scale_init_value > 0 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(conv_nhwc(self.dwconv, x)))))
        if self.gamma is not None:
            y = self.gamma * y
        return x + y


class ResidualConvUnit(nn.Module):
    """ReLU -> 3x3 conv -> ReLU -> 3x3 conv, plus the input (:60-123,
    bn=False)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1)
        self.conv2 = Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv_nhwc(self.conv1, F.relu(x))
        return conv_nhwc(self.conv2, F.relu(out)) + x


class FeatureFusionBlock(nn.Module):
    """DPT refinement: the lateral's residual unit added, a residual unit,
    a 2x align-corners upsample, a 1x1 output conv (:182-243). A block built
    with ``lateral=False`` (the coarsest, which flax never gives a lateral)
    has no ``res_unit1``."""

    def __init__(self, features: int, lateral: bool = True):
        super().__init__()
        if lateral:
            self.res_unit1 = ResidualConvUnit(features)
        self.res_unit2 = ResidualConvUnit(features)
        self.up = Interpolate(2.0, align_corners=True)
        self.out_conv = Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, lateral: Optional[torch.Tensor] = None) -> torch.Tensor:
        if lateral is not None:
            x = x + self.res_unit1(lateral)
        return conv_nhwc(self.out_conv, self.up(self.res_unit2(x)))


class Scratch(nn.Module):
    """Per-level 3x3 projections (no bias) into a common width (:125-180,
    expand=False)."""

    def __init__(self, in_channels: Sequence[int], out_features: int):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"layer{i + 1}_rn", Conv2d(c, out_features, 3, padding=1, bias=False))

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return tuple(conv_nhwc(getattr(self, f"layer{i + 1}_rn"), f) for i, f in enumerate(feats))


def _match(lateral: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``lateral`` resized to ``x``'s spatial shape where they differ."""
    if lateral.shape[1:3] == x.shape[1:3]:
        return lateral
    return resize_bilinear(lateral, x.shape[1], x.shape[2], align_corners=True)


class DPTHead(nn.Module):
    """The standard DPT composition: project a 4-level pyramid (finest
    first) to ``features``, refine coarse to fine, regress a dense map
    with ``out_channels`` channels at twice the finest level's size."""

    def __init__(self, in_channels: Sequence[int], features: int = 256, out_channels: int = 1):
        super().__init__()
        if len(in_channels) != 4:
            raise ValueError("DPTHead takes 4 feature levels")
        self.scratch = Scratch(in_channels, features)
        for name in ("refine4", "refine3", "refine2", "refine1"):
            self.add_module(name, FeatureFusionBlock(features, lateral=name != "refine4"))
        self.head_conv1 = Conv2d(features, features // 2, 3, padding=1)
        self.head_up = Interpolate(2.0, align_corners=True)
        self.head_conv2 = Conv2d(features // 2, 32, 3, padding=1)
        self.head_out = Conv2d(32, out_channels, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        l1, l2, l3, l4 = self.scratch(feats)
        x = self.refine4(l4)
        x = self.refine3(x, _match(l3, x))
        x = self.refine2(x, _match(l2, x))
        x = self.refine1(x, _match(l1, x))
        x = self.head_up(conv_nhwc(self.head_conv1, x))
        return conv_nhwc(self.head_out, F.relu(conv_nhwc(self.head_conv2, x)))
