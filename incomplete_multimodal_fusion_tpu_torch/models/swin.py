"""Swin Transformer backbone (JAX package models/swin.py; reference
backbone/swin.py): window attention with a relative position bias, shifted
windows with the cross-boundary mask, patch merging; the res2..res5
pyramid. Swin-T by default (depths 2 / 2 / 6 / 2, widths 96..768, window
7).

NHWC throughout. A map whose sides are not a multiple of the window (64 x
64 at 256^2) is padded at the bottom and right before the partition and
cropped after, as JAX does. The scores take the bias in the activation
dtype and the softmax runs in f32. Submodules carry the flax names
(``patch_embed``, ``stage{s}_block{i}``, ``attn.qkv``,
``relative_position_bias_table``, ``merge{s}.reduction``, ...). No TPU
kernel computes any of it: plain PyTorch.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Dense, LayerNorm, Mlp, trunc_normal_
from .vit_adapter import conv_nhwc, lecun_normal_


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, w * w, C] (H, W multiples of w)."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    b = windows.shape[0] // ((h // w) * (wd // w))
    x = windows.reshape(b, h // w, wd // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, -1)


@functools.lru_cache(maxsize=None)
def relative_position_index(w: int, table_w: int) -> np.ndarray:
    """The relative-position index [w^2, w^2] of a window of side ``w`` into
    a bias table built for ``table_w`` >= w (swin.py:36-43)."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (table_w - 1)
    return (rel[..., 0] * (2 * table_w - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(hp: int, wp: int, w: int, shift: int, device=None) -> torch.Tensor:
    """[nW, w^2, w^2] additive f32 mask of a shifted partition on
    ``device``: 0 between positions of one region of the rolled map, -100
    across regions (swin.py:96-104). Built once for each shape."""
    img = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    mw = window_partition(torch.from_numpy(img), w)[..., 0]
    return torch.where(mw[:, :, None] == mw[:, None, :], 0.0, -100.0).to(device)


@functools.lru_cache(maxsize=None)
def _bias_index(w: int, table_w: int, device) -> torch.Tensor:
    return torch.from_numpy(relative_position_index(w, table_w)).reshape(-1).to(device)


class WindowAttention(nn.Module):
    """Multi-head self-attention within each window, with the relative
    position bias (swin.py:45-76)."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.qkv = Dense(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, num_heads))
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x [nW * B, N, C]; mask [nW, N, N] additive or None."""
        bnw, n, c = x.shape
        h = self.num_heads
        hd = c // h
        q, k, v = self.qkv(x).reshape(bnw, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        w_rt = int(round(n ** 0.5))  # the window at run time (<= the table's)
        bias = self.relative_position_bias_table[_bias_index(w_rt, self.window, x.device)]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            # the mask is a weak-typed constant in JAX: it takes the scores' dtype
            attn = attn.reshape(bnw // nw, nw, h, n, n) + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(bnw, h, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(bnw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    """(Shifted) window attention and an MLP, pre-norm (swin.py:78-121)."""

    def __init__(self, dim: int, num_heads: int, window: int = 7, shift: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.window = window
        self.shift = shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, wd, c = x.shape
        w = min(self.window, h, wd)
        shift = self.shift if w == self.window else 0
        pad_b, pad_r = (w - h % w) % w, (w - wd % w) % w
        y = F.pad(self.norm1(x), (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, wd + pad_r
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = shifted_window_mask(hp, wp, w, shift, x.device)
        y = window_reverse(self.attn(window_partition(y, w), mask), w, hp, wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :h, :wd]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 neighbours stacked on the channels, normed, projected to 2C
    (swin.py:123-131)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """[res2, res3, res4, res5] NHWC at strides 4 / 8 / 16 / 32
    (swin.py:133-158)."""

    def __init__(self, embed_dim: int = 96, depths: Tuple[int, ...] = (2, 2, 6, 2),
                 num_heads: Tuple[int, ...] = (3, 6, 12, 24), window: int = 7, in_channels: int = 3):
        super().__init__()
        self.depths = tuple(depths)
        self.patch_embed = Conv2d(in_channels, embed_dim, 4, stride=4)
        self.embed_norm = LayerNorm(embed_dim)
        dim = embed_dim
        widths = []
        for s, (depth, heads) in enumerate(zip(depths, num_heads)):
            for i in range(depth):
                self.add_module(f"stage{s}_block{i}",
                                SwinBlock(dim, heads, window, shift=0 if i % 2 == 0 else window // 2))
            self.add_module(f"out_norm{s}", LayerNorm(dim))
            widths.append(dim)
            if s < len(depths) - 1:
                self.add_module(f"merge{s}", PatchMerging(dim))
                dim *= 2
        self.out_channels: Tuple[int, ...] = tuple(widths)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        y = self.embed_norm(conv_nhwc(self.patch_embed, x.to(self.patch_embed.weight.dtype)))
        feats = []
        for s, depth in enumerate(self.depths):
            for i in range(depth):
                y = getattr(self, f"stage{s}_block{i}")(y)
            feats.append(getattr(self, f"out_norm{s}")(y))
            if s < len(self.depths) - 1:
                y = getattr(self, f"merge{s}")(y)
        return feats

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX initializers: lecun-normal for the patch embedding, the
        qkv, output and merge projections (flax's default), xavier-uniform
        for the MLPs (already drawn by the caller), zero biases, unit norms,
        truncated normal 0.02 for the bias tables."""
        for m in self.modules():
            if isinstance(m, (Conv2d, Dense)):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, WindowAttention):
                trunc_normal_(m.relative_position_bias_table, generator)
