"""Sine position embedding for dense feature maps (JAX package
models/position_encoding.py; reference transformer_decoder/
position_encoding.py:12-52, the normalized DETR variant with no padding
masks, so the cumulative sums reduce to row and column indices)."""
from __future__ import annotations

import math

import torch


def position_embedding_sine(h: int, w: int, num_pos_feats: int, temperature: float = 10000.0,
                            normalize: bool = True, scale: float = 2 * math.pi,
                            device=None) -> torch.Tensor:
    """Returns [h, w, 2*num_pos_feats] f32, channels [pos_y, pos_x], each
    with sin on even and cos on odd channels."""
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    if normalize:
        eps = 1e-6
        y = y / (h + eps) * scale
        x = x / (w + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    px = x[..., None] / dim_t
    py = y[..., None] / dim_t
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()], dim=-1).reshape(h, w, -1)
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()], dim=-1).reshape(h, w, -1)
    return torch.cat([py, px], dim=-1)
