"""MSDeformAttn pixel decoder (JAX package models/pixel_decoder.py;
reference pixel_decoder/msdeformattn_vit.py): a deformable-DETR encoder over
the three lowest-resolution backbone features, then FPN steps down to the
highest resolution, giving (mask_features, the transformer decoder's
multi-scale features).

NHWC throughout, f32 (the features are cast on entry, pixel_decoder.py:90),
no padding masks: valid ratios are 1 and the reference points are the
static per-level centre grid. Submodules carry the flax names
(``input_proj{i}``, ``enc_layer{i}``, ``fpn_lateral2_gn``, ...), so
``utils.jax_params.params_from_jax`` maps a flax tree by renaming alone.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear_nhwc
from .layers import GroupNorm, LayerNorm
from .msda_module import MSDeformAttn
from .position_encoding import position_embedding_sine


def reference_points_for(spatial_shapes: Sequence[Tuple[int, int]], device=None) -> torch.Tensor:
    """Per-level pixel-centre grids in [0, 1] as (x, y), tiled to all
    levels: [S, L, 2] (msdeformattn_vit.py:76-88 with valid ratios 1)."""
    pts = []
    for h, w in spatial_shapes:
        ry = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        rx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = torch.cat(pts, 0)
    return ref[:, None, :].expand(ref.shape[0], len(spatial_shapes), 2)


class MSDeformAttnEncoderLayer(nn.Module):
    """Deformable self-attention + ReLU FFN, post-norm (msdeformattn_vit.py:27-67)."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024, n_levels: int = 3,
                 n_heads: int = 8, n_points: int = 4, dropout: float = 0.1):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.drop = nn.Dropout(dropout)

    def forward(self, src, pos, reference_points, spatial_shapes):
        src2 = self.self_attn(src + pos, reference_points, src, spatial_shapes)
        src = self.norm1(src + self.drop(src2))
        h = self.drop(F.relu(self.linear1(src)))
        return self.norm2(src + self.drop(self.linear2(h)))


class MSDeformAttnPixelDecoder(nn.Module):
    """(msdeformattn_vit.py:169-315). Input: 4 NHWC features res2..res5
    (high -> low resolution) with ``in_channels`` channels. Output:
    (mask_features [B, H2, W2, mask_dim], 3 NHWC maps low -> high
    resolution).

    ``num_fpn_levels`` = 2 is the reference full model's double FPN step
    (its backbone strides are labelled 8..64, so log2(min stride) - log2(4)
    = 2): the first step laterals res3 (``fpn_lateral2`` / ``fpn_output2``),
    the second res2 (unsuffixed names); 1 is the single step."""

    def __init__(self, in_channels: Sequence[int], conv_dim: int = 256, mask_dim: int = 256,
                 transformer_enc_layers: int = 2, n_heads: int = 8, dim_feedforward: int = 1024,
                 n_points: int = 4, dropout: float = 0.1, num_fpn_levels: int = 2):
        super().__init__()
        if len(in_channels) != 4:
            raise ValueError("the pixel decoder takes 4 feature levels (res2..res5)")
        self.conv_dim = conv_dim
        self.num_fpn_levels = num_fpn_levels
        self.transformer_enc_layers = transformer_enc_layers
        n_levels = 3
        # input projections low -> high resolution: res5, res4, res3
        for idx, ch in enumerate(in_channels[1:][::-1]):
            self.add_module(f"input_proj{idx}", nn.Linear(ch, conv_dim))
            self.add_module(f"input_gn{idx}", GroupNorm(conv_dim, 32, eps=1e-5))
        self.level_embed = nn.Parameter(torch.zeros(n_levels, conv_dim))
        for i in range(transformer_enc_layers):
            self.add_module(f"enc_layer{i}", MSDeformAttnEncoderLayer(
                conv_dim, dim_feedforward, n_levels, n_heads, n_points, dropout))
        for adapter_num in range(num_fpn_levels, 0, -1):
            sfx = self._suffix(adapter_num)
            self.add_module(f"fpn_lateral{sfx}", nn.Linear(in_channels[adapter_num - 1], conv_dim))
            self.add_module(f"fpn_lateral{sfx}_gn", GroupNorm(conv_dim, 32, eps=1e-5))
            self.add_module(f"fpn_output{sfx}", nn.Conv2d(conv_dim, conv_dim, 3, padding=1))
            self.add_module(f"fpn_output{sfx}_gn", GroupNorm(conv_dim, 32, eps=1e-5))
        self.mask_features = nn.Linear(conv_dim, mask_dim)

    @staticmethod
    def _suffix(adapter_num: int) -> str:
        return "" if adapter_num == 1 else str(adapter_num)

    def forward(self, features: List[torch.Tensor]):
        b = features[0].shape[0]
        c = self.conv_dim
        srcs, poss, shapes = [], [], []
        for idx, x in enumerate(features[1:][::-1]):
            x = x.float()  # deformable attention runs in f32 (msdeformattn_vit.py:278)
            h, w = x.shape[1], x.shape[2]
            s = getattr(self, f"input_gn{idx}")(getattr(self, f"input_proj{idx}")(x))
            srcs.append(s.reshape(b, h * w, c))
            poss.append(position_embedding_sine(h, w, c // 2, device=x.device).reshape(1, h * w, c))
            shapes.append((h, w))
        src = torch.cat(srcs, dim=1)
        pos = torch.cat([p + self.level_embed[i][None, None, :] for i, p in enumerate(poss)], dim=1)
        ref = reference_points_for(shapes, device=src.device)[None].expand(b, -1, -1, -1)
        for i in range(self.transformer_enc_layers):
            src = getattr(self, f"enc_layer{i}")(src, pos, ref, shapes)

        out, start = [], 0
        for h, w in shapes:  # back to maps, low -> high resolution
            out.append(src[:, start:start + h * w].reshape(b, h, w, c))
            start += h * w

        # FPN steps down to res2 (msdeformattn_vit.py:244-308)
        for j, xf in enumerate(features[:self.num_fpn_levels][::-1]):
            sfx = self._suffix(self.num_fpn_levels - j)
            xf = xf.float()
            lat = F.relu(getattr(self, f"fpn_lateral{sfx}_gn")(getattr(self, f"fpn_lateral{sfx}")(xf)))
            y = lat + resize_bilinear_nhwc(out[-1], tuple(xf.shape[1:3]))
            y = getattr(self, f"fpn_output{sfx}")(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            out.append(F.relu(getattr(self, f"fpn_output{sfx}_gn")(y)))
        # the first 3 maps (low -> high resolution) feed the transformer decoder
        return self.mask_features(out[-1]), out[:3]
