"""Input / output adapters (JAX package models/adapters.py; reference
pretraining/multimae/input_adapters.py and output_adapters_simple.py).

Images are NHWC. The patch embedding is the strided convolution written as
one product over (ph, pw, c)-ordered patch pixels.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.patches import conv_patch_embed, unpatchify
from ..ops.posemb import build_2d_sincos_posemb, resize_posemb
from .layers import ViTBlock


class PatchedInputAdapter(nn.Module):
    """Patchify + fixed 2D sin-cos posemb (input_adapters.py:27-119).

    Input [B, H, W, C], or patch-major [B, N, p*p*C] (``data.patchify_batch``,
    a square grid), -> tokens [B, N_H*N_W, dim], in the dtype of the
    adapter's weights.
    """

    def __init__(self, num_channels: int, dim_tokens: int, patch_size: int = 16,
                 image_size: int = 256, stride_level: int = 1):
        super().__init__()
        self.num_channels = num_channels
        self.dim_tokens = dim_tokens
        self.patch_size = patch_size
        self.image_size = image_size
        self.stride_level = stride_level
        p = self.p
        self.proj = nn.Linear(p * p * num_channels, dim_tokens)

    @property
    def p(self) -> int:
        return max(1, self.patch_size // self.stride_level)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.p
        x = x.to(self.proj.weight.dtype)
        if x.dim() == 3:  # patch-major: the embedding is one product (adapters.py:51-60)
            _, n, pc = x.shape
            if pc != p * p * self.num_channels:
                raise ValueError(f"adapter expects patch dim {p * p * self.num_channels}, got {pc} "
                                 f"(input {tuple(x.shape)})")
            n_h = n_w = int(round(n ** 0.5))
            if n_h * n_w != n:
                raise ValueError(f"patch-major input needs a square grid, got N={n}")
            tokens = x @ self.proj.weight.t() + self.proj.bias
        else:
            _, h, w, c = x.shape
            if c != self.num_channels:
                raise ValueError(f"adapter expects {self.num_channels} channels, got {c} "
                                 f"(input {tuple(x.shape)})")
            n_h, n_w = h // p, w // p
            tokens = conv_patch_embed(x, self.proj.weight.t(), self.proj.bias, p)
        hp = self.image_size // (self.stride_level * p)
        pos = build_2d_sincos_posemb(hp, hp, self.dim_tokens, device=x.device)
        pos = resize_posemb(pos, (hp, hp), (n_h, n_w)).to(tokens.dtype)
        return tokens + pos[None]


class SpatialOutputAdapter(nn.Module):
    """Per-task reconstruction decoder over the fusion-token grid
    (output_adapters_simple.py:33-188):

      proj_context -> + task embedding -> depth x ViT blocks -> out_proj ->
      unpatchify (NHWC).
    """

    def __init__(self, num_channels: int, dim_tokens_enc: int, patch_size: int = 16,
                 image_size: int = 256, stride_level: int = 1, dim_tokens: int = 256,
                 depth: int = 2, num_heads: int = 8, qkv_bias: bool = True):
        super().__init__()
        self.num_channels = num_channels
        self.patch_size = patch_size
        self.image_size = image_size
        self.stride_level = stride_level
        p = self.p
        self.proj_context = nn.Linear(dim_tokens_enc, dim_tokens)
        self.task_emb = nn.Parameter(torch.zeros(1, 1, dim_tokens))
        self.blocks = nn.ModuleList(
            ViTBlock(dim_tokens, num_heads, qkv_bias=qkv_bias, norm_eps=1e-6) for _ in range(depth))
        self.out_proj = nn.Linear(dim_tokens, num_channels * p * p)

    @property
    def p(self) -> int:
        return max(1, self.patch_size // self.stride_level)

    def forward(self, encoder_tokens: torch.Tensor, use_kernel: bool = False,
                patch_output: bool = False) -> torch.Tensor:
        p = self.p
        n_hw = self.image_size // (self.stride_level * p)
        x = self.proj_context(encoder_tokens) + self.task_emb
        for blk in self.blocks:
            x = blk(x, use_kernel=use_kernel)
        x = self.out_proj(x)
        if patch_output:
            return x
        return unpatchify(x, p, n_hw, n_hw, self.num_channels)
