"""2D sine-cosine positional embeddings (JAX package ops/posemb.py).

Numerically the reference ``build_2d_sincos_posemb``
(pretraining/multimae/multimae_utils.py:29-45, MoCo-v3 style): channels are
[sin(w), cos(w), sin(h), cos(h)] blocks of dim/4 each, with
omega = 1/temperature**(i/(dim/4)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def build_2d_sincos_posemb(h: int, w: int, embed_dim: int, temperature: float = 10000.0,
                           device=None) -> torch.Tensor:
    """Returns the [h*w, embed_dim] float32 posemb in the reference's flat
    order: torch.meshgrid(grid_w, grid_h) puts the w axis outer."""
    if embed_dim % 4 != 0:
        raise ValueError("embed_dim must be divisible by 4")
    gw = torch.arange(w, dtype=torch.float32, device=device)
    gh = torch.arange(h, dtype=torch.float32, device=device)
    grid_w = gw.repeat_interleave(h)
    grid_h = gh.repeat(w)
    pos_dim = embed_dim // 4
    omega = torch.arange(pos_dim, dtype=torch.float32, device=device) / pos_dim
    omega = 1.0 / (temperature ** omega)
    out_w = grid_w[:, None] * omega[None, :]
    out_h = grid_h[:, None] * omega[None, :]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], dim=1)


def resize_posemb(pos: torch.Tensor, src_hw, dst_hw) -> torch.Tensor:
    """Bicubic resize of a [h*w, d] posemb grid, as ``jax.image.resize``
    with method 'bicubic' does it (Keys cubic a = -0.5, antialiased when
    shrinking). Identity when the sizes match, the common case."""
    sh, sw = src_hw
    dh, dw = dst_hw
    if (sh, sw) == (dh, dw):
        return pos
    d = pos.shape[-1]
    img = pos.reshape(sh, sw, d).permute(2, 0, 1)[None].float()
    out = F.interpolate(img, size=(dh, dw), mode="bicubic", align_corners=False,
                        antialias=True)
    return out[0].permute(1, 2, 0).reshape(dh * dw, d).to(pos.dtype)
