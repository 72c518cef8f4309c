"""Input / output adapters (JAX package models/adapters.py; reference
pretraining/multimae/input_adapters.py and output_adapters_simple.py).

Images are NHWC. The patch embedding is the strided convolution written as
one product over (ph, pw, c)-ordered patch pixels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cuda_attn, cuda_ffn
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
        self.trunk_signature = (patch_size, image_size, stride_level, dim_tokens, depth, num_heads, qkv_bias)
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
                patch_output: bool = False, trunk_only: bool = False) -> torch.Tensor:
        """``trunk_only``: the task-generic part alone (proj_context, the
        task embedding and the blocks, JAX adapters.py:264-268), [B, F,
        dim_tokens]."""
        p = self.p
        n_hw = self.image_size // (self.stride_level * p)
        x = self.proj_context(encoder_tokens) + self.task_emb
        for blk in self.blocks:
            x = blk(x, use_kernel=use_kernel)
        if trunk_only:
            return x
        x = self.out_proj(x)
        if patch_output:
            return x
        return unpatchify(x, p, n_hw, n_hw, self.num_channels)


def _stacked(modules, name: str):
    """The parameter ``name`` of each module, stacked on a leading task axis
    (None where the modules have none)."""
    params = [getattr(m, name) for m in modules]
    return None if params[0] is None else torch.stack(params)


def _linear(x, modules):
    """Each task's nn.Linear on its rows: x [T, M, in] -> [T, M, out], one
    batched product over the stacked weights (the bias added in it, as
    nn.Linear's addmm does)."""
    w = _stacked(modules, "weight").transpose(1, 2)
    b = _stacked(modules, "bias")
    return torch.bmm(x, w) if b is None else torch.baddbmm(b[:, None, :], x, w)


def _layer_norm(x, modules):
    """Each task's LayerNorm (layers.LayerNorm, f32 statistics) on its rows
    [T, M, D]."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + modules[0].eps) * _stacked(modules, "weight").float()[:, None, :]
    if modules[0].bias is not None:
        y = y + _stacked(modules, "bias").float()[:, None, :]
    return y.to(x.dtype)


def batched_trunks(adapters, encoder_tokens: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """The trunks of T output adapters with equal ``trunk_signature`` (what
    JAX multimae.py:257-263 compares: the grid, the width, the depth, the
    heads and the qkv bias) as one
    chain over a task axis (JAX multimae.py:237-296, ``jax.vmap`` over the
    stacked trunk parameters): each Linear a batched product over the
    stacked weights, the decoder attention over the T * B rows in one
    launch of K1 (unmasked mode), each MLP as K2's MLP with its task axis
    (``mlp_ffn_tasks``), one launch for all T. The same parameters and
    arithmetic as T calls of ``forward(trunk_only=True)``. encoder_tokens
    [B, F, D_enc] -> [T, B, F, dim_tokens]."""
    t = len(adapters)
    b, f, d_enc = encoder_tokens.shape
    rows = encoder_tokens.reshape(1, b * f, d_enc).expand(t, -1, -1)
    x = _linear(rows, [a.proj_context for a in adapters]) + _stacked(adapters, "task_emb").reshape(t, 1, -1)
    for i in range(len(adapters[0].blocks)):
        blocks = [a.blocks[i] for a in adapters]
        qkv = _linear(_layer_norm(x, [blk.norm1 for blk in blocks]), [blk.attn.qkv for blk in blocks])
        qkv = qkv.reshape(t * b, f, qkv.shape[-1])
        fn = cuda_attn.zorro_attention_qkv if use_kernel else cuda_attn.zorro_attention_qkv_reference
        out = fn(qkv, blocks[0].attn.num_heads).reshape(t, b * f, -1)
        x = x + _linear(out, [blk.attn.proj for blk in blocks])
        h = _layer_norm(x, [blk.norm2 for blk in blocks])
        fc1, fc2 = [blk.mlp.fc1 for blk in blocks], [blk.mlp.fc2 for blk in blocks]
        if use_kernel:
            y = cuda_ffn.mlp_ffn_tasks(h.contiguous(), _stacked(fc1, "weight"), _stacked(fc1, "bias"),
                                       _stacked(fc2, "weight"), _stacked(fc2, "bias"))
        else:
            y = _linear(F.gelu(_linear(h, fc1)), fc2)
        x = x + y
    return x.reshape(t, b, f, -1)
