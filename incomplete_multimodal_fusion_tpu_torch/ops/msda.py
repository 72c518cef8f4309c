"""Multi-scale deformable attention core, plain PyTorch (JAX package
ops/msda.py).

Semantics of the reference's ``ms_deform_attn_core_pytorch``
(ms_deform_attn_func.py:52-77): per (query, head, level, point) a bilinear
sample with zero padding and ``align_corners=False`` (pixel
``x = loc_x * W - 0.5``, ``loc[..., 0]`` is x), weighted-summed over
(level, point). Kernel K4 (``ops/cuda_msda.py``) computes the same function
on the card; this is its plain version, the one the CPU runs.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` [N, H, W, C] at continuous pixel coordinates ``x``,
    ``y`` [N, K] with zero padding, as ``F.grid_sample(mode='bilinear',
    padding_mode='zeros', align_corners=False)`` does after the grid is
    mapped to pixels. Returns [N, K, C]."""
    n, h, w, c = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    flat = img.reshape(n, h * w, c)

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return v * inb[..., None]

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    return (v00 * (1 - dy) * (1 - dx) + v01 * (1 - dy) * dx + v10 * dy * (1 - dx)
            + v11 * dy * dx)


def level_starts(spatial_shapes: Sequence[Tuple[int, int]]) -> list:
    """Offsets of each level in the flattened sequence, and the total last."""
    starts = [0]
    for h, w in spatial_shapes:
        starts.append(starts[-1] + h * w)
    return starts


def ms_deform_attn_core(
    value: torch.Tensor,  # [B, S, M, D] flattened levels
    spatial_shapes: Sequence[Tuple[int, int]],  # [(H, W), ...], low -> high resolution
    sampling_locations: torch.Tensor,  # [B, Lq, M, L, P, 2] in [0, 1], (x, y)
    attention_weights: torch.Tensor,  # [B, Lq, M, L, P]
) -> torch.Tensor:
    """Returns [B, Lq, M*D] in ``value``'s dtype, summed in at least f32."""
    b, s, m, d = value.shape
    _, lq, _, l, p, _ = sampling_locations.shape
    if l != len(spatial_shapes):
        raise ValueError(f"{l} levels of locations for {len(spatial_shapes)} spatial shapes")
    starts = level_starts(spatial_shapes)
    if starts[-1] != s:
        raise ValueError(f"spatial shapes cover {starts[-1]} positions, value has {s}")
    acc = torch.promote_types(value.dtype, torch.float32)
    out = torch.zeros((b, m, lq, d), dtype=acc, device=value.device)
    for lid, (h, w) in enumerate(spatial_shapes):
        val_l = value[:, starts[lid]:starts[lid + 1]].reshape(b, h, w, m, d)
        val_l = val_l.permute(0, 3, 1, 2, 4).reshape(b * m, h, w, d)
        loc = sampling_locations[:, :, :, lid].permute(0, 2, 1, 3, 4)  # [B, M, Lq, P, 2]
        # grid_sample's align_corners=False pixel mapping, as the JAX core
        # writes it
        gx = 2.0 * loc[..., 0] - 1.0
        gy = 2.0 * loc[..., 1] - 1.0
        px = ((gx + 1.0) * w - 1.0) / 2.0
        py = ((gy + 1.0) * h - 1.0) / 2.0
        sampled = bilinear_sample(val_l, px.reshape(b * m, lq * p), py.reshape(b * m, lq * p))
        sampled = sampled.reshape(b, m, lq, p, d).to(acc)
        wts = attention_weights[:, :, :, lid].permute(0, 2, 1, 3).to(acc)  # [B, M, Lq, P]
        out = out + torch.einsum("bmqpd,bmqp->bmqd", sampled, wts)
    return out.permute(0, 2, 1, 3).reshape(b, lq, m * d).to(value.dtype)
