"""Transformer building blocks (JAX package models/layers.py).

Semantics of the reference zorro utilities
(downstream/instance_segmentation/modeling/multimae/zorro_utils.py) and the
ViT primitives of pretraining/multimae/multimae_utils.py, quirks kept:

  * ``ZorroAttention`` layer-norms its *query* input itself
    (zorro_utils.py:176), so a block applies LayerNorm twice before
    attention; a cross-attention context is not normed.
  * ``GEGLUFeedForward`` begins with its own LayerNorm (zorro_utils.py:121-128).
  * Bias-less LayerNorm: learned weight (the reference's gamma) only.
  * GELU is the exact (erf) form.

Module and parameter names follow the flax tree one to one (a Dense
``kernel`` [in, out] is an ``nn.Linear`` ``weight`` [out, in], a ``gamma``
is a LayerNorm ``weight``), so ``utils.jax_params.params_from_jax`` maps a
flax checkpoint by renaming alone.

``use_kernel`` routes the four hot computations through the hand-written
kernels' operators (ops/library.py, defined in ops/cuda_*.py), which launch
the forward and backward kernels for CUDA tensors and run the plain forward
and backward for CPU tensors; without it the plain forwards run and
autograd differentiates them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cuda_attn, cuda_block_attn, cuda_ffn, cuda_fusion_attn
from ..ops.attention import multihead_attention
from ..parallel.comm import collective


class LayerNorm(nn.Module):
    """LayerNorm computed in f32, with a learned bias unless ``bias=False``."""

    def __init__(self, dim: int, eps: float = 1e-5, bias: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if bias else None
        self.tp = None  # parallel.sharding.TPLink: normed on a token shard (sequence parallelism)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.weight, self.bias
        if self.tp is not None:  # each rank's gradient covers its tokens alone
            weight = self.tp.weight(weight)
            bias = None if bias is None else self.tp.weight(bias)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * weight.float()
        if bias is not None:
            y = y + bias.float()
        return y.to(x.dtype)


class Dense(nn.Linear):
    """flax ``nn.Dense``'s dtype rule on an ``nn.Linear``: the product runs
    in the promoted dtype of input and weight, so bf16 weights meet an f32
    input (the downstream head, pixel_decoder.py:90) in f32, bf16-rounded,
    and a bf16 input with bf16 weights stays bf16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax ``nn.Conv``'s dtype rule (see ``Dense``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class BiaslessLayerNorm(LayerNorm):
    """LayerNorm with a learned weight only (zorro_utils.py:103-110)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps, bias=False)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 (multimae_utils.py:138-155). With ``use_kernel``
    the pair runs as kernel K2 in MLP mode. Tensor-parallel (``tp``, a
    parallel.sharding.TPLink): this rank's hidden units, fc2's bias added
    after the output's all-reduce."""

    def __init__(self, dim: int, hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None):
        super().__init__()
        hidden = hidden_features or dim
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out_features or dim)
        self.tp = None

    def forward(self, x: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.into(x)
        b2 = self.fc2.bias if self.tp is None or not self.tp.sharded else torch.zeros_like(self.fc2.bias)
        if use_kernel:
            y = cuda_ffn.mlp_ffn(_rows(x), self.fc1.weight, self.fc1.bias, self.fc2.weight, b2)
            y = y.reshape(*x.shape[:-1], y.shape[-1])
        else:
            y = F.linear(F.gelu(self.fc1(x)), self.fc2.weight, b2)
        if self.tp is None:
            return y
        y = self.tp.out(y)
        return y + self.fc2.bias if self.tp.sharded else y


class GEGLUFeedForward(nn.Module):
    """LayerNorm -> Linear(2*inner, no bias) -> GEGLU -> Linear(dim, no bias),
    inner = int(dim * mult * 2/3) (zorro_utils.py:115-128). Runs as kernel K2
    in GEGLU mode with ``use_kernel``; the [M, 2*inner] activation stays on
    chip."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult * 2 / 3)
        self.norm = BiaslessLayerNorm(dim)
        self.proj_in = nn.Linear(dim, inner * 2, bias=False)
        self.proj_out = nn.Linear(inner, dim, bias=False)
        self.tp = None  # parallel.sharding.TPLink: this rank's inner units

    def forward(self, x: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
        fn = cuda_ffn.geglu_ffn if use_kernel else cuda_ffn.geglu_ffn_reference
        gamma = self.norm.weight
        if self.tp is not None:
            x = self.tp.into(x)
            if self.tp.sharded:  # the kernel's LayerNorm: each rank's dgamma is its units' part
                gamma = self.tp.weight(gamma)
        y = fn(_rows(x), gamma, self.proj_in.weight, self.proj_out.weight).reshape(x.shape)
        return y if self.tp is None else self.tp.out(y)


class ZorroAttention(nn.Module):
    """Masked MHA with its own query-side LayerNorm (zorro_utils.py:152-194).

    Self-attention with ``packed_types`` projects q/k/v with one product
    against the stacked [to_q; to_kv] weights -- the same columns as the two
    separate projections -- and runs kernel K1 (zorro mode) on the fused
    slab; without types or a mask, and with ``use_kernel``, it runs K1's
    unmasked mode on that slab (the 'sup' backbone's full attention, which
    JAX computes plain). Cross-attention (``context``) or an explicit
    ``attn_mask`` runs the plain masked attention.
    """

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.dim_head = dim_head
        self.norm = BiaslessLayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)
        self.tp = None  # parallel.sharding.TPLink (self-attention): this rank's heads

    def forward(self, x, context=None, attn_mask=None, packed_types=None, fusion_type=None,
                use_kernel: bool = False, empty_rows_uniform_over=None):
        x = self.norm(x)
        if context is None and (packed_types is not None or (use_kernel and attn_mask is None)):
            if self.tp is not None:
                x = self.tp.into(x)
            qkv = F.linear(x, torch.cat([self.to_q.weight, self.to_kv.weight], dim=0))
            fn = cuda_attn.zorro_attention_qkv if use_kernel else cuda_attn.zorro_attention_qkv_reference
            y = self.to_out(fn(qkv, self.heads, packed_types, fusion_type))
            return y if self.tp is None else self.tp.out(y)
        kv_x = context if context is not None else x
        b, n = x.shape[:2]
        m = kv_x.shape[1]
        q = self.to_q(x).reshape(b, n, self.heads, self.dim_head)
        k, v = self.to_kv(kv_x).chunk(2, dim=-1)
        out = multihead_attention(q, k.reshape(b, m, self.heads, self.dim_head),
                                  v.reshape(b, m, self.heads, self.dim_head), mask=attn_mask,
                                  empty_rows_uniform_over=empty_rows_uniform_over)
        return self.to_out(out.reshape(b, n, -1))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over the last (channel) axis of an NHWC map:
    statistics in f32 over the spatial axes and the group's channels, a
    learned weight and bias; the result in the input's dtype."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {num_channels} channels")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        xf = x.float().reshape(x.shape[0], -1, self.num_groups, c // self.num_groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = xf.var(dim=(1, 3), unbiased=False, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth (zorro_utils.py:69-99); identity in eval
    mode and at rate 0 (the pretraining default)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = torch.floor(keep + torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                                             dtype=x.dtype, device=x.device))
        return x / keep * mask


class Dropout(nn.Module):
    """``nn.Dropout`` whose mask can be the global batch's: with ``share`` =
    (i, k) (data parallelism: this rank holds the i-th of k equal shares of
    the batch) the mask is ``F.dropout``'s over k times the rows (a draw
    that depends on the generator, the element count and the dtype, not on
    the values) and share i's rows are kept, so under one seed a rank drops
    what ``nn.Dropout`` on the global batch drops for its rows. Without a
    share it is ``F.dropout`` itself. ``set_dropout_share`` sets ``share``
    on a model's dropouts."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.share: Optional[Tuple[int, int]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if self.share is None:
            return F.dropout(x, self.rate, training=True)
        i, k = self.share
        n = x.shape[0]
        keep = F.dropout(x.new_ones((k * n,) + tuple(x.shape[1:])), self.rate, training=True)
        return x * keep[i * n:(i + 1) * n]


def set_dropout_share(model: nn.Module, share: Optional[Tuple[int, int]]) -> None:
    """``share`` on every ``Dropout`` of ``model``; None, or a share of one,
    where the batch is the whole batch."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.share = share if share is not None and share[1] > 1 else None


class EncoderBlock(nn.Module):
    """Zorro-masked encoder block (zorro_utils.py:227-240).

    ``fused_block`` routes the whole attention half (norm1, the attention's
    own norm, the q/kv projections, zorro attention, the out projection and
    the residual add) through kernel K6 (ops/cuda_block_attn.py), reading the
    same parameters. As in the JAX block (layers.py:327-330) the route is
    taken only with ``use_kernel``, packed types, no active drop path and
    shapes that ``block_attn_supported`` admits; otherwise the block runs
    composed."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, ff_mult: int = 4,
                 drop_path: float = 0.0, fused_block: bool = False):
        super().__init__()
        self.norm1 = BiaslessLayerNorm(dim)
        self.attn = ZorroAttention(dim, dim_head, heads)
        self.norm2 = BiaslessLayerNorm(dim)
        self.mlp = GEGLUFeedForward(dim, ff_mult)
        self.dp1 = DropPath(drop_path)
        self.dp2 = DropPath(drop_path)
        self.fused_block = fused_block
        # sequence parallelism: the model group; the stream leaves the
        # attention half as this rank's token shard (parallel/sharding.py)
        self.sp = None

    def forward(self, x, packed_types, fusion_type: int, use_kernel: bool = False):
        b, n, d = x.shape
        attn = self.attn
        if (self.fused_block and use_kernel and packed_types is not None
                and (self.dp1.rate == 0.0 or not self.training)
                and cuda_block_attn.block_attn_supported(n, d, attn.heads * attn.dim_head)):
            x = cuda_block_attn.fused_block_attn(
                x, packed_types, self.norm1.weight, attn.norm.weight, attn.to_q.weight, attn.to_kv.weight,
                attn.to_out.weight, attn.heads, fusion_type)
            if self.sp is not None:
                x = collective(x, "split", self.sp)
        else:
            h = attn(self.norm1(x), packed_types=packed_types, fusion_type=fusion_type, use_kernel=use_kernel)
            if self.sp is not None:
                x = collective(x, "split", self.sp)
            x = x + self.dp1(h)
        return x + self.dp2(self.mlp(self.norm2(x), use_kernel=use_kernel))


class FusionBlockFast(nn.Module):
    """Per-position cross-modal fusion (zorro_utils.py:243-258) in the JAX
    package's restructured form: the LayerNorms and the fused KV projection
    run once on the flat sources (packed tokens, the mask-embedding table,
    fusion tokens), and each fusion position's modality stack is assembled as
    a t-major KV grid by a gather: grid slot g takes the packed token
    ``slot[g]`` where ``use[g]``, and the mask embedding's KV elsewhere --
    the values the JAX one-hot product gives. Kernel K3 then attends each
    fusion position over its T slots plus itself.

      fus = fusion + to_out(attn)
      fus = fus + ff(norm2(fus))
    """

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, ff_mult: int = 4):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.dim_head = dim_head
        self.norm1 = BiaslessLayerNorm(dim)
        self.attn_norm = BiaslessLayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)
        self.norm2 = BiaslessLayerNorm(dim)
        self.mlp = GEGLUFeedForward(dim, ff_mult)
        self.tp = None  # parallel.sharding.TPLink: this rank's heads

    def forward(self, packed, fusion, mask_emb, slot, use, plane_valid=None,
                use_kernel: bool = False):
        """packed [B, E, D]; fusion [B, F, D]; mask_emb [1, F, D];
        slot [B, T*F] (mask_info.ids_restore); use [B, T*F] bool;
        plane_valid [T+1] bool or None. With ``plane_valid`` the slots of the
        excluded planes (absent modalities) get no attention; that runs the
        plain slot attention, as the JAX block does (layers.py:478-502)."""
        e = packed.shape[1]
        f = fusion.shape[1]
        t = slot.shape[1] // f
        h_packed = self.attn_norm(self.norm1(packed))
        h_mask = self.attn_norm(self.norm1(mask_emb))
        h_fus = self.attn_norm(self.norm1(fusion))
        if self.tp is not None:
            h_packed, h_mask, h_fus = (self.tp.into(h) for h in (h_packed, h_mask, h_fus))

        q = self.to_q(h_fus)  # [B, F, I]
        kv_p = self.to_kv(h_packed)  # [B, E, 2I]
        kv_m = self.to_kv(h_mask)  # [1, F, 2I]
        kv_f = self.to_kv(h_fus)  # [B, F, 2I]

        idx = slot.clamp(max=e - 1)[..., None].expand(-1, -1, kv_p.shape[-1])
        kv_grid = torch.where(use[..., None], torch.gather(kv_p, 1, idx), kv_m.repeat(1, t, 1))

        if use_kernel and plane_valid is None:
            out = cuda_fusion_attn.fusion_row_attention(q, kv_grid.contiguous(), kv_f, self.heads, self.dim_head)
        else:
            out = cuda_fusion_attn.fusion_row_attention_reference(
                q, kv_grid, kv_f, self.heads, self.dim_head, plane_valid=plane_valid)
        out = self.to_out(out)
        if self.tp is not None:
            out = self.tp.out(out)
        fus = fusion + out
        return fus + self.mlp(self.norm2(fus), use_kernel=use_kernel)


def stack_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each query [B, N, H, dh] over its own short stack of keys and values
    [B, N, M, H, dh] as elementwise products and sums (JAX layers.py:389-398,
    :655-661): logits of the scaled query and softmax over M in f32, the
    probabilities cast to v's dtype; ``key_valid`` [B, N, M] keys entries out
    (finite -0.7 * f32 max, as JAX). -> [B, N, H * dh]."""
    sim = ((q[:, :, None] * q.shape[-1] ** -0.5).float() * k.float()).sum(-1)  # [B, N, M, H]
    if key_valid is not None:
        sim = torch.where(key_valid[..., None], sim, torch.full_like(sim, -0.7 * torch.finfo(torch.float32).max))
    attn = torch.softmax(sim, dim=2)
    return (attn[..., None].to(v.dtype) * v).sum(2).flatten(2)


class FusionBlock(nn.Module):
    """The reference form of ``FusionBlockFast`` (JAX layers.py:362-410,
    zorro_utils.py:243-258), with the same parameter names: each fusion
    position's stack [B, N, M, D] of (modalities..., fusion) is normed and
    projected whole, and the fusion row alone queries it.

      fus = stack[:, :, -1] + to_out(attn(norm1(stack))[fusion row])
      fus = fus + ff(norm2(fus))

    ``key_valid`` [B, N, M] bool keys out stack entries."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, ff_mult: int = 4):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.dim_head = dim_head
        self.norm1 = BiaslessLayerNorm(dim)
        self.attn_norm = BiaslessLayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)
        self.norm2 = BiaslessLayerNorm(dim)
        self.mlp = GEGLUFeedForward(dim, ff_mult)

    def forward(self, stack: torch.Tensor, key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, m, _ = stack.shape
        h = self.attn_norm(self.norm1(stack))
        q = self.to_q(h[:, :, -1]).reshape(b, n, self.heads, self.dim_head)
        k, v = (t.reshape(b, n, m, self.heads, self.dim_head) for t in self.to_kv(h).chunk(2, dim=-1))
        fus = stack[:, :, -1] + self.to_out(stack_attention(q, k, v, key_valid))
        return fus + self.mlp(self.norm2(fus))


class ViTSelfAttention(nn.Module):
    """Fused-QKV self-attention (multimae_utils.py:158-182) of the decoder;
    kernel K1 in its unmasked mode with ``use_kernel``."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.tp = None  # parallel.sharding.TPLink: this rank's heads, proj's bias after the all-reduce

    def forward(self, x: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
        fn = cuda_attn.zorro_attention_qkv if use_kernel else cuda_attn.zorro_attention_qkv_reference
        if self.tp is None:
            return self.proj(fn(self.qkv(x), self.num_heads))
        out = F.linear(fn(self.qkv(self.tp.into(x)), self.num_heads), self.proj.weight)
        return self.tp.out(out) + self.proj.bias


class ViTBlock(nn.Module):
    """Standard pre-norm ViT block (multimae_utils.py:217-232)."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, norm_eps: float = 1e-6):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=norm_eps)
        self.attn = ViTSelfAttention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim, eps=norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), use_kernel=use_kernel)
        return x + self.mlp(self.norm2(x), use_kernel=use_kernel)


class ViTCrossAttention(nn.Module):
    """Cross-attention (multimae_utils.py:185-214, JAX layers.py:584-605):
    q from ``x``, packed kv from ``context``, a biased output projection;
    ``attn_mask`` (True = may attend, broadcastable to [B, H, Nq, Nk]) keys
    out context slots. Plain masked attention, as in JAX."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, dim * 2, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor, attn_mask=None) -> torch.Tensor:
        b, n, c = x.shape
        m, h = context.shape[1], self.num_heads
        k, v = self.kv(context).chunk(2, dim=-1)
        out = multihead_attention(self.q(x).reshape(b, n, h, c // h), k.reshape(b, m, h, c // h),
                                  v.reshape(b, m, h, c // h), mask=attn_mask)
        return self.proj(out.reshape(b, n, c))


class ViTDecoderBlock(nn.Module):
    """Self-attention, cross-attention and MLP (multimae_utils.py:235-253,
    JAX layers.py:608-628)."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 norm_eps: float = 1e-6):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=norm_eps)
        self.self_attn = ViTSelfAttention(dim, num_heads, qkv_bias)
        self.query_norm = LayerNorm(dim, eps=norm_eps)
        self.context_norm = LayerNorm(dim, eps=norm_eps)
        self.cross_attn = ViTCrossAttention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim, eps=norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, context: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x), use_kernel=use_kernel)
        x = x + self.cross_attn(self.query_norm(x), self.context_norm(context))
        return x + self.mlp(self.norm2(x), use_kernel=use_kernel)


class SnapshotCrossAttention(nn.Module):
    """Per-position cross-attention over a short stack axis
    (zorro_utils.py:198-224 as the 20231203 snapshot's
    ``attn_pool_modalities`` uses it; JAX layers.py:631-663): each query
    token attends over its own T-entry stack (``stack_attention``); q and
    kv bias-free, ``proj`` biased. [B, E, D], [B, E, T, D] -> [B, E, D]."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim, bias=False)
        self.kv = nn.Linear(dim, dim * 2, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q_tokens: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        b, e, d = q_tokens.shape
        t, h = ctx.shape[2], self.num_heads
        qh = self.q(q_tokens).reshape(b, e, h, d // h)
        k, v = (s.reshape(b, e, t, h, d // h) for s in self.kv(ctx).chunk(2, dim=-1))
        return self.proj(stack_attention(qh, k, v))


LSTM_GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """flax ``nn.LSTMCell`` as plain tensor ops, with its parameter tree:
    input kernels ``ii`` / ``if`` / ``ig`` / ``io`` without bias, recurrent
    kernels ``hi`` / ``hf`` / ``hg`` / ``ho`` with bias (the modules named
    so, ``if`` as ``if_``: a keyword is no attribute torch.export's code can
    read; utils.jax_params maps it). Gates sigmoid i, f, o and tanh g; ``c = f c + i g``,
    ``h = o tanh(c)``. The projections follow flax's dtype rule (``Dense``):
    the carry starts as f32 zeros, as flax's ``initialize_carry`` makes it,
    so the state stays f32 under bf16 weights."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.ii, self.if_, self.ig, self.io = (Dense(in_features, features, bias=False) for _ in LSTM_GATES)
        self.hi, self.hf, self.hg, self.ho = (Dense(features, features) for _ in LSTM_GATES)

    def forward(self, carry, x: torch.Tensor):
        c, h = carry
        pre = {gate: inp(x) + rec(h) for gate, inp, rec in zip(
            LSTM_GATES, (self.ii, self.if_, self.ig, self.io), (self.hi, self.hf, self.hg, self.ho))}
        c = torch.sigmoid(pre["f"]) * c + torch.sigmoid(pre["i"]) * torch.tanh(pre["g"])
        h = torch.sigmoid(pre["o"]) * torch.tanh(c)
        return (c, h), h


class AttentionBiLSTM(nn.Module):
    """BiLSTM and attention pooling over a short axis (zorro_utils.py:276-299,
    JAX layers.py:666-701): an LSTM each way over the M axis from a zero
    carry, the two directions' outputs summed, each position scored by
    ``attention`` (Linear(D, 1)) on their tanh, a softmax in f32, the
    weighted sum. [N, M, D] -> [N, D] in the input's dtype (in a bf16 run
    the JAX package lets the f32 result promote the encoder trunk to f32;
    the port keeps the trunk in the compute dtype). No TPU kernel computes
    it: it stays plain PyTorch."""

    def __init__(self, dim: int):
        super().__init__()
        self.lstm_fwd = LSTMCell(dim, dim)
        self.lstm_bwd = LSTMCell(dim, dim)
        self.attention = Dense(dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, m, d = x.shape
        zeros = x.new_zeros((n, d), dtype=torch.float32)
        ys = [[None] * m, [None] * m]
        for direction, (cell, steps) in enumerate(((self.lstm_fwd, range(m)), (self.lstm_bwd, reversed(range(m))))):
            carry = (zeros, zeros)
            for t in steps:
                carry, ys[direction][t] = cell(carry, x[:, t])
        y = torch.stack(ys[0], dim=1) + torch.stack(ys[1], dim=1)
        scores = self.attention(torch.tanh(y))[..., 0]
        alpha = torch.softmax(scores.float(), dim=-1).to(y.dtype)
        return torch.einsum("nm,nmd->nd", alpha, y).to(x.dtype)


# ---------------------------------------------------------------------------
# Seeded initialization with the JAX package's distributions
# ---------------------------------------------------------------------------

def xavier_uniform_(weight: torch.Tensor, generator: torch.Generator, n_split: int = 1):
    """Xavier-uniform on an [out, in] weight. ``n_split`` > 1 treats a fused
    projection (packed kv or qkv) as that many separate matrices
    (reference multimae_crossattn.py:141-150, JAX layers.xavier_uniform_fused)."""
    fan_out, fan_in = weight.shape
    val = math.sqrt(6.0 / float(fan_out / n_split + fan_in))
    with torch.no_grad():
        weight.uniform_(-val, val, generator=generator)


def trunc_normal_(t: torch.Tensor, generator: torch.Generator, std: float = 0.02):
    """flax ``truncated_normal(stddev=std)``: a standard normal cut at +-2,
    scaled so the cut distribution has standard deviation ``std``."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    with torch.no_grad():
        t.uniform_(lo, hi, generator=generator)
        t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        t.mul_(std / 0.87962566103423978)
