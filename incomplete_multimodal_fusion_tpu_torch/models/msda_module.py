"""MSDeformAttn module (JAX package models/msda_module.py; reference
pixel_decoder/ops/modules/ms_deform_attn.py:34-120): the offset and weight
projections around the deformable sampling core, with the directional-grid
offset-bias init (:66-80). Flattened [B, S, C] layout.

``impl``: 'auto' or 'pallas' run the core through kernel K4's autograd
Function (the kernel for a CUDA tensor, the plain core for a CPU one);
'xla' runs the plain core (``ops.msda.ms_deform_attn_core``) everywhere.
K4 takes f32 operands. A bf16 call (the ViT-Adapter's interactions inside
the bf16 backbone) casts value, locations and weights up to f32 before the
kernel and the result back to value's dtype, as the TPU kernel reads its
operands as f32 and casts its output (pallas_msda.py:83, :239-241, :251):
the up-cast is exact, so the one rounding is the output's, and autograd
carries K4b's gradients back through the casts.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.cuda_msda import MSDeformAttnFunction
from ..ops.msda import ms_deform_attn_core
from .layers import Dense

IMPLS = ("auto", "pallas", "xla")


def offset_bias(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """The sampling-offset bias at init (ms_deform_attn.py:66-74): head h
    points along the angle 2*pi*h/H, point i at (i + 1) times the unit step.
    Flat [H * L * P * 2] f32, computed as the JAX initializer computes it."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # [H, 2]
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return torch.from_numpy(grid.reshape(-1).astype(np.float32))


class MSDeformAttn(nn.Module):
    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8, n_points: int = 4,
                 impl: str = "auto"):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of n_heads {n_heads}")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.impl = impl
        self.value_proj = Dense(d_model, d_model)
        self.sampling_offsets = Dense(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Dense(d_model, n_heads * n_levels * n_points)
        self.output_proj = Dense(d_model, d_model)

    def reset_offsets(self) -> None:
        """The JAX initializers of the two sampling projections: zero
        kernels, the directional-grid offset bias, zero weight bias."""
        with torch.no_grad():
            nn.init.zeros_(self.sampling_offsets.weight)
            self.sampling_offsets.bias.copy_(offset_bias(self.n_heads, self.n_levels, self.n_points))
            nn.init.zeros_(self.attention_weights.weight)
            nn.init.zeros_(self.attention_weights.bias)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                input_flatten: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query [B, Lq, C]; reference_points [B, Lq, L, 2] in [0, 1];
        input_flatten [B, S, C]; spatial_shapes [(H, W), ...]."""
        b, lq, _ = query.shape
        m, l, p = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(input_flatten)
        value = value.reshape(b, value.shape[1], m, value.shape[2] // m)
        offsets = self.sampling_offsets(query).reshape(b, lq, m, l, p, 2)
        weights = self.attention_weights(query).reshape(b, lq, m, l * p)
        weights = torch.softmax(weights, dim=-1).reshape(b, lq, m, l, p)
        # offsets are normalized by each level's (w, h) (ms_deform_attn.py:108-110)
        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                                  device=query.device)
        locs = (reference_points[:, :, None, :, None, :]
                + offsets / normalizer[None, None, None, :, None, :])
        shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
        if self.impl == "xla":
            out = ms_deform_attn_core(value, shapes, locs, weights)
        else:
            out = MSDeformAttnFunction.apply(value.float(), shapes, locs.float(), weights.float()).to(value.dtype)
        return self.output_proj(out)
