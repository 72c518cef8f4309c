"""Input / output adapters (JAX package models/adapters.py; reference
pretraining/multimae/input_adapters.py, output_adapters_simple.py and
output_adapters.py).

Images are NHWC, class maps [B, H, W] integers. The patch embedding is the
strided convolution written as one product over (ph, pw, c)-ordered patch
pixels. The full decoder's unshuffle into the grid and its re-gather to the
packed slots are gathers, not the JAX one-hot products: each product sums
one term, so the values are the same (config.py's rule for the KV grid).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cuda_attn, cuda_ffn
from ..ops.patches import conv_patch_embed, unpatchify
from ..ops.posemb import build_2d_sincos_posemb, resize_posemb
from .layers import LayerNorm, Mlp, ViTBlock, ViTCrossAttention


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


class SemSegInputAdapter(nn.Module):
    """Class embedding + patchify for a class-map modality such as the
    Dynamic-World ``dnw`` input (input_adapters.py:209-328, JAX
    adapters.py:82-117): an integer map [B, H, W] gathers ``class_emb``
    [num_classes, dim_class_emb] rows, the patch product runs over
    p * p * dim_class_emb, and the resized sin-cos posemb is added."""

    def __init__(self, num_classes: int, dim_tokens: int, patch_size: int = 16, image_size: int = 256,
                 stride_level: int = 1, dim_class_emb: int = 64):
        super().__init__()
        self.num_classes = num_classes
        self.dim_tokens = dim_tokens
        self.patch_size = patch_size
        self.image_size = image_size
        self.stride_level = stride_level
        p = self.p
        self.class_emb = nn.Parameter(torch.zeros(num_classes, dim_class_emb))
        self.proj = nn.Linear(p * p * dim_class_emb, dim_tokens)

    @property
    def p(self) -> int:
        return max(1, self.patch_size // self.stride_level)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.p
        _, h, w = x.shape
        emb = F.embedding(x.long(), self.class_emb)  # [B, H, W, dim_class_emb]
        tokens = conv_patch_embed(emb, self.proj.weight.t(), self.proj.bias, p)
        hp = self.image_size // (self.stride_level * p)
        pos = build_2d_sincos_posemb(hp, hp, self.dim_tokens, device=x.device)
        pos = resize_posemb(pos, (hp, hp), (h // p, w // p)).to(tokens.dtype)
        return tokens + pos[None]


def input_adapter(spec, dim_tokens: int, patch_size: int, image_size: int) -> nn.Module:
    """The input adapter of a registry entry (modalities.py): the class-map
    adapter for ``semseg`` modalities, the patch adapter otherwise."""
    if spec.adapter == "semseg":
        return SemSegInputAdapter(spec.num_classes, dim_tokens, patch_size, image_size, spec.stride_level,
                                  spec.dim_class_emb)
    return PatchedInputAdapter(spec.num_channels, dim_tokens, patch_size, image_size, spec.stride_level)


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


class SpatialOutputAdapterFull(nn.Module):
    """The full MAE decoder (reference output_adapters.py:60-282, JAX
    adapters.py:128-226) over the packed encoder tokens [B, E, D_enc]:

      * ``proj_context``, then the unshuffle into the T * F grid: grid
        position g takes packed slot ``ids_restore[g]`` where that slot holds
        a visible token, else ``mask_token``;
      * per context task ``task_emb_<task>`` plus the 2D sin-cos posemb;
      * the queries: this task's section of the grid, or ``mask_token`` plus
        the posemb without ``use_task_queries`` (or when the task is no
        context task);
      * with ``use_xattn``: the cross-attention (``decoder``) from the
        normed queries to the normed grid gathered back to the packed slots,
        the padded slots keyed out, then ``x + mlp(out_norm(x))``;
      * ``depth`` ViT blocks and ``out_proj``.

    ``use_kernel`` runs the blocks' attention as K1 (unmasked) and every
    Mlp as K2's MLP, the same function the JAX package computes there with
    its plain attention and Dense layers; the cross-attention stays plain,
    as in JAX."""

    def __init__(self, num_channels: int, task: str, context_tasks, dim_tokens_enc: int, patch_size: int = 16,
                 image_size: int = 256, stride_level: int = 1, dim_tokens: int = 256, depth: int = 2,
                 num_heads: int = 8, use_task_queries: bool = True, use_xattn: bool = True):
        super().__init__()
        self.num_channels = num_channels
        self.task = task
        self.context_tasks = tuple(context_tasks)
        self.patch_size = patch_size
        self.image_size = image_size
        self.stride_level = stride_level
        self.use_task_queries = use_task_queries
        self.use_xattn = use_xattn
        p = self.p
        self.proj_context = nn.Linear(dim_tokens_enc, dim_tokens)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dim_tokens))
        for tk in self.context_tasks:
            self.register_parameter(f"task_emb_{tk}", nn.Parameter(torch.zeros(1, 1, dim_tokens)))
        if use_xattn:
            self.decoder = ViTCrossAttention(dim_tokens, num_heads, qkv_bias=True)
            self.query_norm = LayerNorm(dim_tokens, eps=1e-6)
            self.context_norm = LayerNorm(dim_tokens, eps=1e-6)
            self.out_norm = LayerNorm(dim_tokens, eps=1e-6)
            self.mlp = Mlp(dim_tokens, dim_tokens * 4)
        self.blocks = nn.ModuleList(
            ViTBlock(dim_tokens, num_heads, qkv_bias=True, norm_eps=1e-6) for _ in range(depth))
        self.out_proj = nn.Linear(dim_tokens, num_channels * p * p)

    @property
    def p(self) -> int:
        return max(1, self.patch_size // self.stride_level)

    def forward(self, encoder_tokens: torch.Tensor, mask_info, num_encoded_tokens: int, use_kernel: bool = False,
                patch_output: bool = False) -> torch.Tensor:
        b, e, _ = encoder_tokens.shape
        p = self.p
        n_hw = self.image_size // (self.stride_level * p)
        f = n_hw * n_hw
        ctx = self.proj_context(encoder_tokens)  # [B, E, d]
        d = ctx.shape[-1]
        dtype = ctx.dtype
        mask_token = self.mask_token.to(dtype)
        slot = mask_info.ids_restore
        use = (slot < num_encoded_tokens) & (slot < mask_info.num_visible[:, None])
        gathered = torch.gather(ctx, 1, slot.clamp(max=e - 1)[..., None].expand(-1, -1, d))
        grid = torch.where(use[..., None], gathered, mask_token)

        pos = build_2d_sincos_posemb(n_hw, n_hw, d, device=ctx.device)
        emb = torch.cat([getattr(self, f"task_emb_{tk}") + pos[None] for tk in self.context_tasks], dim=1)
        grid = grid + emb.to(dtype)

        if self.use_task_queries and self.task in self.context_tasks:
            ti = self.context_tasks.index(self.task)
            queries = grid[:, ti * f:(ti + 1) * f]
        else:
            queries = (self.mask_token + pos[None]).to(dtype).expand(b, -1, -1)

        if self.use_xattn:
            # the embedded grid back at the packed slots: slot s < num_visible
            # sits at grid position order[s]; the padded slots are zeros and
            # keyed out
            key_valid = torch.arange(e, device=ctx.device)[None] < mask_info.num_visible[:, None]
            context = torch.gather(grid, 1, mask_info.order[:, :e, None].expand(-1, -1, d))
            context = torch.where(key_valid[..., None], context, torch.zeros_like(context))
            x = self.decoder(self.query_norm(queries), self.context_norm(context),
                             attn_mask=key_valid[:, None, None, :])
            x = x + self.mlp(self.out_norm(x), use_kernel=use_kernel)
        else:
            x = queries
        for blk in self.blocks:
            x = blk(x, use_kernel=use_kernel)
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
        # tensor parallelism (each module's ``tp``): this rank's heads and
        # hidden units, the row-parallel biases after the all-reduce
        attn_tp, mlp_tp = blocks[0].attn.tp, blocks[0].mlp.tp
        h = _layer_norm(x, [blk.norm1 for blk in blocks])
        qkv = _linear(h if attn_tp is None else attn_tp.into(h), [blk.attn.qkv for blk in blocks])
        qkv = qkv.reshape(t * b, f, qkv.shape[-1])
        fn = cuda_attn.zorro_attention_qkv if use_kernel else cuda_attn.zorro_attention_qkv_reference
        out = fn(qkv, blocks[0].attn.num_heads).reshape(t, b * f, -1)
        proj = [blk.attn.proj for blk in blocks]
        if attn_tp is None:
            x = x + _linear(out, proj)
        else:
            x = x + attn_tp.out(torch.bmm(out, _stacked(proj, "weight").transpose(1, 2))) \
                + _stacked(proj, "bias")[:, None, :]
        h = _layer_norm(x, [blk.norm2 for blk in blocks])
        fc1, fc2 = [blk.mlp.fc1 for blk in blocks], [blk.mlp.fc2 for blk in blocks]
        b2 = _stacked(fc2, "bias")
        if mlp_tp is not None:
            h, b2 = mlp_tp.into(h), torch.zeros_like(b2)
        if use_kernel:
            y = cuda_ffn.mlp_ffn_tasks(h.contiguous(), _stacked(fc1, "weight"), _stacked(fc1, "bias"),
                                       _stacked(fc2, "weight"), b2)
        else:
            y = torch.baddbmm(b2[:, None, :], F.gelu(_linear(h, fc1)), _stacked(fc2, "weight").transpose(1, 2))
        if mlp_tp is not None:
            y = mlp_tp.out(y) + _stacked(fc2, "bias")[:, None, :]
        x = x + y
    return x.reshape(t, b, f, -1)
