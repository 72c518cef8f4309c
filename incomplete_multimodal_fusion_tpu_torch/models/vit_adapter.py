"""ViT-Adapter building blocks (JAX package models/vit_adapter.py;
reference multimae_big_adapter.py and adapter_modules.py:94-436): a
convolutional SpatialPriorModule gives multi-scale spatial priors, and
injector / extractor pairs exchange information between the ViT's fusion
stream and the priors through multi-scale deformable attention (kernel K4,
``models.msda_module.MSDeformAttn``). ``ViTBaseline(adapter=True)`` wraps
each of its block groups with one pair, so the injected priors shape every
later encoder block.

NHWC maps; the convolutions run on NCHW views of them. Submodules carry the
flax names (``stem1``, ``stem1_gn``, ``fc1``, ``query_norm``, ``attn``,
``ffn``, ...) and the Injector its own ``gamma``.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, GroupNorm, LayerNorm, Mlp, trunc_normal_
from .msda_module import MSDeformAttn


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An NCHW convolution applied to an NHWC map, NHWC out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel initializer (``lecun_normal``): a normal cut at
    +-2 standard deviations with variance 1 / fan_in, on an [out, in] or
    [out, in / groups, kh, kw] weight."""
    fan_in = weight[0].numel()
    trunc_normal_(weight, generator, std=math.sqrt(1.0 / fan_in))


class SpatialPriorModule(nn.Module):
    """Conv stem, then priors at strides 4 / 8 / 16 / 32 projected to
    ``dim`` by 1x1 convolutions (adapter_modules.py SpatialPriorModule).
    The 3x3 convolutions pad (1, 1) explicitly, as torch's Conv2d(k=3, p=1)
    does; each GroupNorm takes min(32, channels) groups (epsilon 1e-6)."""

    def __init__(self, in_channels: int, dim: int, stem_dim: int = 64):
        super().__init__()
        plan = (("stem1", in_channels, stem_dim, 2), ("stem2", stem_dim, stem_dim, 1),
                ("conv2", stem_dim, 2 * stem_dim, 2), ("conv3", 2 * stem_dim, 4 * stem_dim, 2),
                ("conv4", 4 * stem_dim, 4 * stem_dim, 2))
        for name, cin, cout, stride in plan:
            self.add_module(name, Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False))
            self.add_module(f"{name}_gn", GroupNorm(cout, min(32, cout), eps=1e-6))
        for i, cin in enumerate((stem_dim, 2 * stem_dim, 4 * stem_dim, 4 * stem_dim)):
            self.add_module(f"fc{i + 1}", Conv2d(cin, dim, 1))

    def _conv_gn_relu(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.relu(getattr(self, f"{name}_gn")(conv_nhwc(getattr(self, name), x)))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [B, H, W, C] -> 4 maps [B, H/s, W/s, dim], s = 4, 8, 16, 32."""
        y = self._conv_gn_relu("stem2", self._conv_gn_relu("stem1", x))
        c1 = F.max_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)  # flax nn.max_pool, VALID
        c2 = self._conv_gn_relu("conv2", c1)
        c3 = self._conv_gn_relu("conv3", c2)
        c4 = self._conv_gn_relu("conv4", c3)
        return [conv_nhwc(getattr(self, f"fc{i + 1}"), c) for i, c in enumerate((c1, c2, c3, c4))]

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun-normal kernels, zero biases, unit norms."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)


def deform_heads(dim: int, preferred: int = 6) -> int:
    """The interactions' head count (vit_adapter.py:52-56): the first of
    6, 8, 4, 3, 2 that divides ``dim``, else 1."""
    for h in (preferred, 8, 4, 3, 2, 1):
        if dim % h == 0:
            return h
    return 1


N_POINTS = 4  # sampling points a head and level of the interactions


class Injector(nn.Module):
    """tokens + gamma * MSDeformAttn(LN(tokens), ref, LN(priors))
    (adapter_modules.py Injector); ``gamma`` is zero at init."""

    def __init__(self, dim: int, n_levels: int = 3):
        super().__init__()
        self.query_norm = LayerNorm(dim)
        self.feat_norm = LayerNorm(dim)
        self.attn = MSDeformAttn(dim, n_levels, deform_heads(dim), N_POINTS)
        self.gamma = nn.Parameter(torch.zeros(dim))

    def forward(self, tokens, token_ref, priors_flat, prior_shapes: Sequence[Tuple[int, int]]):
        attn = self.attn(self.query_norm(tokens), token_ref, self.feat_norm(priors_flat), prior_shapes)
        return tokens + self.gamma * attn


class Extractor(nn.Module):
    """priors + MSDeformAttn(LN(priors), ref, LN(tokens as one map)), then
    an Mlp of width dim / 4 on ``ffn_norm`` (adapter_modules.py Extractor)."""

    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = LayerNorm(dim)
        self.feat_norm = LayerNorm(dim)
        self.attn = MSDeformAttn(dim, 1, deform_heads(dim), N_POINTS)
        self.ffn_norm = LayerNorm(dim)
        self.ffn = Mlp(dim, int(dim * 0.25))

    def forward(self, priors_flat, prior_ref, tokens, token_shape: Tuple[int, int]):
        priors = priors_flat + self.attn(self.query_norm(priors_flat), prior_ref, self.feat_norm(tokens),
                                         [token_shape])
        return priors + self.ffn(self.ffn_norm(priors))
