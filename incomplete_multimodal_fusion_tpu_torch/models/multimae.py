"""MultiMAE incomplete-multimodal fusion encoder, ``crossattn`` mode (JAX
package models/multimae.py; reference pretraining/multimae/
multimae_crossattn.py:37-545).

Learned fusion tokens, modality-typed Zorro-masked self-attention and a
per-layer cross-modal fusion block. The forward uses the JAX package's fixed
packed layout of ``num_encoded_tokens`` slots: visible tokens first in
ascending global index, padding slots after them, the fusion tokens last.
Padding slots are excluded everywhere by the PAD token type and the
``use``/``valid`` masks, so any modality-dropout pattern, a fully missing
modality included, runs the same shapes.

The pack and the per-layer KV grid are gathers (``torch.gather``) that write
zeros (the pack) or the mask embedding (the grid) where the slot is not in
use -- the values the JAX one-hot products give.

``attn_impl``: 'auto' (or 'pallas') routes the encoder attention, the FFs,
the fusion-row attention and the decoder's attention and MLP through the
hand-written kernels' wrappers, which launch the kernels for CUDA tensors
and run the plain versions for CPU tensors; 'xla' runs the plain versions
everywhere.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .. import modalities as modreg
from ..ops.attention import packed_token_types, packed_valid, zorro_mask_from_types
from ..ops.cuda_attn import PAD_TYPE
from ..ops.masking import MaskInfo
from ..ops.patches import unpatchify
from ..ops.posemb import build_2d_sincos_posemb
from .adapters import PatchedInputAdapter, SpatialOutputAdapter, batched_trunks
from .layers import (BiaslessLayerNorm, EncoderBlock, FusionBlockFast, LayerNorm, Mlp,
                     ZorroAttention, trunc_normal_, xavier_uniform_)


class PackedLayout(NamedTuple):
    tokens: torch.Tensor  # [B, E+F, D]: visible tokens, zero padding slots, fusion tokens
    types: torch.Tensor  # [B, E+F] token type of each slot
    valid: torch.Tensor  # [B, E+F] bool, False at padding slots
    kernel_types: torch.Tensor  # int32 types with PAD_TYPE at padding slots: K1's mask input
    slot: torch.Tensor  # [B, T*F] packed slot of each grid position (mask_info.ids_restore)
    use: torch.Tensor  # [B, T*F] bool: the grid position holds a packed token


def pack_tokens(tokens_in, fusion_tokens: torch.Tensor, mask_info: MaskInfo, e: int,
                num_patches: int) -> PackedLayout:
    """The packed layout of ``e`` slots plus the fusion tokens: slot s holds
    token ``order[s]`` while s < num_visible, else zeros. ``tokens_in``: one
    [B, num_patches, D] tensor per modality, in domain order."""
    full = torch.cat(tokens_in, dim=1)
    keep = mask_info.order[:, :e]
    packed = torch.gather(full, 1, keep[..., None].expand(-1, -1, full.shape[-1]))
    slot_real = torch.arange(e, device=full.device)[None, :] < mask_info.num_visible[:, None]
    packed = torch.where(slot_real[..., None], packed, torch.zeros_like(packed))
    tokens = torch.cat([packed, fusion_tokens], dim=1)

    n_dom, f = len(tokens_in), fusion_tokens.shape[1]
    types = packed_token_types(mask_info.order, (num_patches,) * n_dom, e, f, n_dom)
    valid = packed_valid(mask_info.num_visible, e, f)
    kernel_types = torch.where(valid, types, torch.full_like(types, PAD_TYPE)).to(torch.int32)
    slot = mask_info.ids_restore
    use = (slot < e) & (slot < mask_info.num_visible[:, None])
    return PackedLayout(tokens, types, valid, kernel_types, slot, use)


class MultiMAE(nn.Module):
    def __init__(
        self,
        in_domains: Tuple[str, ...] = ("s1", "s2", "dem"),
        out_domains: Tuple[str, ...] = ("s1", "s2", "dem"),
        image_size: int = 256,
        patch_size: int = 16,
        dim_tokens: int = 192,
        depth: int = 12,
        dim_head: int = 64,
        heads: int = 3,
        ff_mult: int = 4,
        num_fusion_tokens: int = 256,
        drop_path_rate: float = 0.0,
        fusion_mode: str = "crossattn",
        attn_impl: str = "auto",
        decoder_dim: int = 256,
        decoder_depth: int = 2,
        decoder_num_heads: int = 8,
        decoder_style: str = "simple",
        decoder_batch_tasks: bool = False,
    ):
        super().__init__()
        if fusion_mode != "crossattn":
            raise NotImplementedError(f"fusion_mode={fusion_mode!r} is not ported yet")
        if decoder_style != "simple":
            raise NotImplementedError("only the 'simple' decoder is ported yet")
        if attn_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"attn_impl must be 'auto', 'pallas' or 'xla', got {attn_impl!r}")
        self.in_domains = tuple(in_domains)
        self.out_domains = tuple(out_domains)
        self.image_size = image_size
        self.patch_size = patch_size
        self.dim_tokens = dim_tokens
        self.num_fusion_tokens = num_fusion_tokens
        self.attn_impl = attn_impl
        self.decoder_batch_tasks = decoder_batch_tasks
        if num_fusion_tokens != self.num_patches:  # reference multimae_crossattn.py:87
            raise ValueError("num_fusion_tokens must equal the number of patches")

        self.input_adapters = nn.ModuleDict()
        for d in self.in_domains:
            spec = modreg.get(d)
            if spec.adapter != "patched":
                raise NotImplementedError(f"the {spec.adapter!r} input adapter is not ported yet")
            self.input_adapters[d] = PatchedInputAdapter(
                spec.num_channels, dim_tokens, patch_size, image_size, spec.stride_level)
        self.output_adapters = nn.ModuleDict()
        for d in self.out_domains:
            spec = modreg.get(d)
            out_ch = spec.num_classes if spec.loss == "cross_entropy" else spec.num_channels
            self.output_adapters[d] = SpatialOutputAdapter(
                out_ch, dim_tokens, patch_size, image_size, spec.stride_level, decoder_dim,
                decoder_depth, decoder_num_heads)

        self.fusion_tokens = nn.Parameter(torch.zeros(1, num_fusion_tokens, dim_tokens))
        # one return token per (modality..., fusion) type (multimae_crossattn.py:93-99)
        self.return_tokens = nn.Parameter(torch.zeros(1, len(self.in_domains) + 1, dim_tokens))
        for d in self.in_domains:
            self.register_parameter(f"return_token_{d}", nn.Parameter(torch.zeros(1, 1, dim_tokens)))
        self.mask_embedding = nn.Parameter(torch.zeros(1, num_fusion_tokens, dim_tokens))

        self.attn_pool = ZorroAttention(dim_tokens, dim_head, heads)
        self.mlp = Mlp(dim_tokens, int(dim_tokens * 4.0))
        dpr = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = nn.ModuleList(
            EncoderBlock(dim_tokens, dim_head, heads, ff_mult, dpr[i]) for i in range(depth))
        self.fus_blocks = nn.ModuleList(
            FusionBlockFast(dim_tokens, dim_head, heads, ff_mult) for _ in range(depth))
        self.norm = BiaslessLayerNorm(dim_tokens)

    @property
    def num_patches(self) -> int:
        n = self.image_size // self.patch_size
        return n * n

    @property
    def fusion_type(self) -> int:
        return len(self.in_domains)

    def init_weights(self, generator: torch.Generator) -> "MultiMAE":
        """The JAX package's initializers, drawn from ``generator``:
        xavier-uniform for every projection (fused xavier for packed kv/qkv),
        zero biases, unit LayerNorm weights, truncated normal 0.02 for the
        fusion/return tokens and task embeddings, normal(1.0) for the
        per-modality pool tokens (multimae_crossattn.py:105-109) and a zero
        mask embedding."""
        for name, module in self.named_modules():
            if isinstance(module, nn.Linear):
                split = 2 if name.endswith("to_kv") else 3 if name.endswith("attn.qkv") else 1
                xavier_uniform_(module.weight, generator, split)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
            elif isinstance(module, LayerNorm):
                nn.init.ones_(module.weight)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
        trunc_normal_(self.fusion_tokens, generator)
        trunc_normal_(self.return_tokens, generator)
        for d in self.in_domains:
            with torch.no_grad():
                getattr(self, f"return_token_{d}").normal_(0.0, 1.0, generator=generator)
        for ad in self.output_adapters.values():
            trunc_normal_(ad.task_emb, generator)
        nn.init.zeros_(self.mask_embedding)
        return self

    def _decode_simple(self, grid: torch.Tensor, use_kernel: bool) -> Dict[str, torch.Tensor]:
        """Per-task reconstructions {d: [B, F, p*p*C]} from the fusion-token
        grid (JAX multimae.py:237-296). With ``decoder_batch_tasks`` and at
        least two tasks whose trunks agree in shape, the trunks run as one
        chain over a task axis (``adapters.batched_trunks``: K1 over the
        T * B rows and K2's MLP with its task axis, one launch each a
        layer), and each task's out_proj is applied on its own; else one
        adapter call a task. The parameters are the same either way."""
        doms = self.out_domains
        ads = [self.output_adapters[d] for d in doms]
        if (not self.decoder_batch_tasks or len(doms) < 2
                or any(a.trunk_signature != ads[0].trunk_signature for a in ads)):
            return {d: a(grid, use_kernel=use_kernel, patch_output=True) for d, a in zip(doms, ads)}
        feats = batched_trunks(ads, grid, use_kernel)
        return {d: a.out_proj(feats[i]) for i, (d, a) in enumerate(zip(doms, ads))}

    def _unpatchify_preds(self, preds_patch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for d, x in preds_patch.items():
            ad = self.output_adapters[d]
            n_h = ad.image_size // (ad.stride_level * ad.p)
            out[d] = unpatchify(x, ad.p, n_h, n_h, ad.num_channels)
        return out

    def forward(self, x: Dict[str, torch.Tensor], mask_info: MaskInfo, num_encoded_tokens: int):
        """x: {domain: [B, H, W, C]} NHWC. A dropped modality still needs an
        input (zeros will do): its tokens are computed and fully masked out.
        Returns the JAX package's output dict."""
        e = num_encoded_tokens
        b = x[self.in_domains[0]].shape[0]
        use_kernel = self.attn_impl != "xla"

        tokens_in = [self.input_adapters[d](x[d]) for d in self.in_domains]
        dtype = tokens_in[0].dtype
        device = tokens_in[0].device

        # fusion tokens + posemb (FusionInputAdapter, input_adapters.py:185-206)
        hp = self.image_size // self.patch_size
        fus_pos = build_2d_sincos_posemb(hp, hp, self.dim_tokens, device=device)
        fusion_tokens = (self.fusion_tokens + fus_pos[None]).to(dtype).expand(b, -1, -1)

        tokens, types, valid, kernel_types, slot, use = pack_tokens(
            tokens_in, fusion_tokens, mask_info, e, self.num_patches)
        mask_emb = self.mask_embedding.to(dtype)
        for blk, fus_blk in zip(self.blocks, self.fus_blocks):
            fusion_new = fus_blk(tokens[:, :e], tokens[:, e:], mask_emb, slot, use,
                                 use_kernel=use_kernel)
            tokens = torch.cat([tokens[:, :e], fusion_new], dim=1)
            tokens = blk(tokens, kernel_types, self.fusion_type, use_kernel=use_kernel)

        tokens = self.norm(tokens)

        # attention pooling: each return token sees its own modality's packed
        # slots, the fusion return token everything valid; a modality with no
        # visible slot attends uniformly over the valid keys
        # (multimae_crossattn.py:474-497, ops/attention.multihead_attention)
        ret_types = torch.arange(len(self.in_domains) + 1, device=device)
        pool_mask = zorro_mask_from_types(ret_types[None].expand(b, -1), types, self.fusion_type,
                                          valid_k=valid)[:, None]
        ret = self.return_tokens.to(dtype).expand(b, -1, -1)
        ret = self.attn_pool(ret, context=tokens, attn_mask=pool_mask,
                             empty_rows_uniform_over=valid[:, None, None, :])
        ret = ret + self.mlp(self.norm(ret))

        encoder_fusion_tokens = tokens[:, e:]
        preds_patch = self._decode_simple(encoder_fusion_tokens, use_kernel)

        # contrastive pools over the fusion tokens at each modality's visible
        # positions (multimae_crossattn.py:529-543)
        pooled_mod = {}
        for d in self.in_domains:
            key_mask = (mask_info.task_masks[d] == 0)[:, None, None, :]
            p = getattr(self, f"return_token_{d}").to(dtype).expand(b, -1, -1)
            p = self.attn_pool(p, context=encoder_fusion_tokens, attn_mask=key_mask)
            p = p + self.mlp(self.norm(p))
            pooled_mod[d] = p[:, 0]

        return {
            "preds": self._unpatchify_preds(preds_patch),
            "preds_patch": preds_patch,  # [B, F, p*p*C] per task
            "task_masks": mask_info.task_masks,
            "pooled": ret,  # [B, T+1, D]: per-modality + fusion pools
            "ori_tokens": tokens[:, :e],
            "fusion_tokens": encoder_fusion_tokens,
            "pooled_mod": pooled_mod,  # {domain: [B, D]}
        }


def build_multimae(cfg, device="cuda", generator: Optional[torch.Generator] = None) -> MultiMAE:
    """Build from a PretrainConfig (factories multimae_crossattn.py:548-599).

    The module is built and initialized on the CPU with the JAX package's
    initializers, drawn from ``generator`` (seed 0 when None), so the weights
    do not depend on the device; then it moves to ``device``, the card unless
    the caller asks for the CPU. Raises when the device is CUDA and there is
    none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_multimae: no CUDA device; pass device='cpu' to build on the CPU")
    model = MultiMAE(
        in_domains=tuple(cfg.data.in_domains),
        out_domains=tuple(cfg.data.out_domains),
        image_size=cfg.data.input_size,
        patch_size=cfg.data.patch_size,
        dim_tokens=cfg.model.dim_tokens,
        depth=cfg.model.depth,
        dim_head=cfg.model.dim_head,
        heads=cfg.model.heads,
        ff_mult=cfg.model.ff_mult,
        num_fusion_tokens=cfg.model.num_fusion_tokens,
        drop_path_rate=cfg.model.drop_path_rate,
        fusion_mode=cfg.model.fusion_mode,
        attn_impl=cfg.model.attn_impl,
        decoder_dim=cfg.decoder.dim,
        decoder_depth=cfg.decoder.depth,
        decoder_num_heads=cfg.decoder.num_heads,
        decoder_style=cfg.decoder.style,
        decoder_batch_tasks=cfg.decoder.batch_tasks,
    )
    model.init_weights(generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(device)
