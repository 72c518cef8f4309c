"""Patchify / unpatchify and the patch embedding as one matrix product.

Images are NHWC and the pixel order inside a patch is (ph, pw, c), as in the
JAX package (ops/patches.py) and the reference loss patchify
(criterion.py:75-78 'b c (nh p1) (nw p2) -> b (nh nw) (p1 p2 c)').
"""
from __future__ import annotations

import torch


def patchify(imgs: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p * W/p), p*p*C] patch pixels."""
    b, h, w, c = imgs.shape
    nh, nw = h // p, w // p
    x = imgs.reshape(b, nh, p, nw, p, c).permute(0, 1, 3, 2, 4, 5)  # b nh nw p1 p2 c
    return x.reshape(b, nh * nw, p * p * c)


def unpatchify(x: torch.Tensor, p: int, nh: int, nw: int, c: int) -> torch.Tensor:
    """[B, nh*nw, p*p*C] -> [B, nh*p, nw*p, C]."""
    b = x.shape[0]
    x = x.reshape(b, nh, nw, p, p, c).permute(0, 1, 3, 2, 4, 5)  # b nh p1 nw p2 c
    return x.reshape(b, nh * p, nw * p, c)


def conv_patch_embed(imgs: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                     p: int) -> torch.Tensor:
    """Strided-conv patch embedding as one product.

    kernel: [p*p*C, D] (pixel order (ph, pw, c)), bias: [D] -- the JAX
    layout, equal to nn.Conv2d(C, D, kernel_size=p, stride=p) on NCHW input
    (reference input_adapters.py:88-91) up to weight layout.
    """
    return patchify(imgs, p) @ kernel + bias
