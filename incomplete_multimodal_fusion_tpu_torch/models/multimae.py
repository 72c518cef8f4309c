"""MultiMAE incomplete-multimodal fusion encoder (JAX package
models/multimae.py; reference pretraining/multimae/multimae_crossattn.py:37-545
and its variants).

Learned fusion tokens and modality-typed Zorro-masked self-attention, with
the fusion modes of the JAX package:

  * ``crossattn`` (the flagship): a per-layer cross-modal fusion block
    (kernel K3) before each encoder block, over ``[packed | fusion]`` with
    N = E + F;
  * ``zorro``: the same loop without the fusion blocks; the fusion tokens
    join through the masked self-attention alone (JAX multimae.py:472-521);
  * ``lstm`` (multimae_lstm.py): the fusion stream is the fusion token at
    each packed slot's grid position (``order % F``); one BiLSTM fuses each
    (token, fusion token) pair before the encoder blocks run over the 2E
    "gathered" layout ``[packed | gathered fusion]``; the fusion tokens are
    scattered back to the grid for the decoder (JAX :568-611);
  * ``crossattn_v1`` (the dated 20231203 snapshot): the gathered 2E layout,
    and each layer first scatters the current visible tokens into
    mask-embedded per-modality grids, lets each fusion token attend over its
    slot's T-stack (``attn_pool_modalities``) and adds
    ``mlp_modalities(norm(.))``; its pools have their own attention and MLP
    per modality (JAX :614-690).

Decoders: ``simple`` decodes the fusion-token grid (output_adapters_simple.py);
``full`` is the MAE decoder over the packed encoder tokens
(output_adapters.py), for ``crossattn``, ``zorro`` and ``crossattn_v1``. A
``semseg`` domain (the quadruplet's ``dnw`` class map) takes the class-map
adapter and raises the fusion type to the number of input domains.

The forward uses the JAX package's fixed packed layout of
``num_encoded_tokens`` slots: visible tokens first in ascending global index,
padding slots after them. Padding slots are excluded everywhere by the PAD
token type and the ``use``/``valid`` masks, so any modality-dropout pattern, a
fully missing modality included, runs the same shapes; in the 2E layout the
padding sits at ``[num_visible, E)`` and again at ``[E + num_visible, 2E)``.

The pack, the grids and the scatter-back are gathers (``torch.gather``) that
write zeros, the mask embedding or the fusion tokens where a slot is not in
use -- the values the JAX one-hot products give.

``attn_impl``: 'auto' (or 'pallas') routes the encoder attention, the
encoder FFs, the fusion-row attention and the decoders' attention and MLPs
through the hand-written kernels' wrappers, which launch the kernels for
CUDA tensors and run the plain versions for CPU tensors; 'xla' runs the
plain versions everywhere. The JAX package decodes the ``lstm`` and
``crossattn_v1`` grids and runs the full decoder without its Pallas
kernels; the port runs its kernels there too, the same function. The BiLSTM,
the snapshot's cross-attention and MLPs, the pools and the full decoder's
cross-attention run plain, as in JAX.
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
from ..parallel.comm import collective
from .adapters import SpatialOutputAdapter, SpatialOutputAdapterFull, batched_trunks, input_adapter
from .layers import (AttentionBiLSTM, BiaslessLayerNorm, EncoderBlock, FusionBlockFast, LayerNorm, Mlp,
                     SnapshotCrossAttention, ZorroAttention, trunc_normal_, xavier_uniform_)

FUSION_MODES = ("crossattn", "zorro", "lstm", "crossattn_v1")
GATHERED_MODES = ("lstm", "crossattn_v1")  # the fusion stream gathered at the packed slots: N = 2E
DECODER_STYLES = ("simple", "full")


class PackedLayout(NamedTuple):
    tokens: torch.Tensor  # [B, E+F, D]: visible tokens, zero padding slots, fusion tokens
    types: torch.Tensor  # [B, E+F] token type of each slot
    valid: torch.Tensor  # [B, E+F] bool, False at padding slots
    kernel_types: torch.Tensor  # int32 types with PAD_TYPE at padding slots: K1's mask input
    slot: torch.Tensor  # [B, T*F] packed slot of each grid position (mask_info.ids_restore)
    use: torch.Tensor  # [B, T*F] bool: the grid position holds a packed token


def pack_visible(tokens_in, mask_info: MaskInfo, e: int) -> torch.Tensor:
    """[B, e, D]: slot s holds token ``order[s]`` while s < num_visible,
    else zeros. ``tokens_in``: one [B, num_patches, D] tensor per modality,
    in domain order."""
    full = torch.cat(tokens_in, dim=1)
    keep = mask_info.order[:, :e]
    packed = torch.gather(full, 1, keep[..., None].expand(-1, -1, full.shape[-1]))
    slot_real = torch.arange(e, device=full.device)[None, :] < mask_info.num_visible[:, None]
    return torch.where(slot_real[..., None], packed, torch.zeros_like(packed))


def slot_use(mask_info: MaskInfo, e: int) -> torch.Tensor:
    """[B, T*F] bool: the grid position's packed slot holds a visible token."""
    slot = mask_info.ids_restore
    return (slot < e) & (slot < mask_info.num_visible[:, None])


def kernel_types_of(types: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """K1's mask input: int32 types with PAD_TYPE where the slot is padding."""
    return torch.where(valid, types, torch.full_like(types, PAD_TYPE)).to(torch.int32)


def pack_tokens(tokens_in, fusion_tokens: torch.Tensor, mask_info: MaskInfo, e: int,
                num_patches: int) -> PackedLayout:
    """The packed layout of ``e`` slots (``pack_visible``) plus the fusion
    tokens."""
    tokens = torch.cat([pack_visible(tokens_in, mask_info, e), fusion_tokens], dim=1)
    n_dom, f = len(tokens_in), fusion_tokens.shape[1]
    types = packed_token_types(mask_info.order, (num_patches,) * n_dom, e, f, n_dom)
    valid = packed_valid(mask_info.num_visible, e, f)
    return PackedLayout(tokens, types, valid, kernel_types_of(types, valid), mask_info.ids_restore,
                        slot_use(mask_info, e))


class GatheredLayout(NamedTuple):
    mod_types: torch.Tensor  # [B, E] modality type of each packed slot
    slot_valid: torch.Tensor  # [B, E] bool, False at padding slots
    types: torch.Tensor  # [B, 2E]: the packed slots' types, then the fusion type E times
    valid: torch.Tensor  # [B, 2E]: slot_valid twice
    kernel_types: torch.Tensor  # int32 types with PAD_TYPE at both halves' padding slots


def gathered_layout(mask_info: MaskInfo, e: int, num_patches: int, n_dom: int) -> GatheredLayout:
    """Types and validity of the ``[packed | gathered fusion]`` 2E layout
    (JAX multimae.py:328-337): the fusion half takes the fusion type, and
    both halves are PAD past ``num_visible``."""
    mod_types = packed_token_types(mask_info.order, (num_patches,) * n_dom, e, 0, n_dom)
    slot_valid = packed_valid(mask_info.num_visible, e, 0)
    types = torch.cat([mod_types, torch.full_like(mod_types, n_dom)], dim=1)
    valid = torch.cat([slot_valid, slot_valid], dim=1)
    return GatheredLayout(mod_types, slot_valid, types, valid, kernel_types_of(types, valid))


def run_block(blk, tokens: torch.Tensor, kernel_types: torch.Tensor, fusion_type: int,
              use_kernel: bool) -> torch.Tensor:
    """An encoder block on the whole stream; under sequence parallelism
    (``blk.sp``) its token shards are all-gathered back into the stream."""
    tokens = blk(tokens, kernel_types, fusion_type, use_kernel=use_kernel)
    return tokens if blk.sp is None else collective(tokens, "unsplit", blk.sp)


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
        decoder_use_task_queries: bool = True,
        decoder_use_xattn: bool = True,
    ):
        super().__init__()
        if fusion_mode == "sup":
            raise NotImplementedError(
                "fusion_mode='sup' is a downstream backbone variant with no pretraining script "
                "(JAX multimae.py:410-415): use ViTBaseline(fusion_mode='sup') / "
                "MaskFormerConfig(fusion_mode='sup') instead")
        if fusion_mode not in FUSION_MODES:
            raise ValueError(f"fusion_mode must be one of {FUSION_MODES}, got {fusion_mode!r}")
        if decoder_style not in DECODER_STYLES:
            raise ValueError(f"decoder_style must be one of {DECODER_STYLES}, got {decoder_style!r}")
        if decoder_style == "full" and fusion_mode == "lstm":
            # JAX multimae.py:600 decodes the lstm grid with the simple
            # decoder's call, which the full decoder does not take
            raise ValueError("fusion_mode='lstm' decodes the fusion grid: decoder_style must be 'simple'")
        if attn_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"attn_impl must be 'auto', 'pallas' or 'xla', got {attn_impl!r}")
        self.in_domains = tuple(in_domains)
        self.out_domains = tuple(out_domains)
        self.image_size = image_size
        self.patch_size = patch_size
        self.dim_tokens = dim_tokens
        self.num_fusion_tokens = num_fusion_tokens
        self.fusion_mode = fusion_mode
        self.attn_impl = attn_impl
        self.decoder_style = decoder_style
        self.decoder_batch_tasks = decoder_batch_tasks
        if num_fusion_tokens != self.num_patches:  # reference multimae_crossattn.py:87
            raise ValueError("num_fusion_tokens must equal the number of patches")

        self.input_adapters = nn.ModuleDict(
            {d: input_adapter(modreg.get(d), dim_tokens, patch_size, image_size) for d in self.in_domains})
        self.output_adapters = nn.ModuleDict()
        for d in self.out_domains:
            spec = modreg.get(d)
            out_ch = spec.num_classes if spec.loss == "cross_entropy" else spec.num_channels
            if decoder_style == "full":
                self.output_adapters[d] = SpatialOutputAdapterFull(
                    out_ch, d, self.in_domains, dim_tokens, patch_size, image_size, spec.stride_level, decoder_dim,
                    decoder_depth, decoder_num_heads, decoder_use_task_queries, decoder_use_xattn)
            else:
                self.output_adapters[d] = SpatialOutputAdapter(
                    out_ch, dim_tokens, patch_size, image_size, spec.stride_level, decoder_dim, decoder_depth,
                    decoder_num_heads)

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
        if fusion_mode == "crossattn":
            self.fus_blocks = nn.ModuleList(
                FusionBlockFast(dim_tokens, dim_head, heads, ff_mult) for _ in range(depth))
        if fusion_mode == "lstm":
            self.attn_lstm = AttentionBiLSTM(dim_tokens)
        if fusion_mode == "crossattn_v1":
            # one shared per-position cross-attention over the mask-embedded
            # modality grids and its MLP (multimae_crossattn_20231203.py:106,
            # :115), and a pool attention and MLP per modality (:107-118)
            self.attn_pool_modalities = SnapshotCrossAttention(dim_tokens, heads)
            self.mlp_modalities = Mlp(dim_tokens, int(dim_tokens * 4.0))
            for d in self.in_domains:
                self.add_module(f"attn_{d}", ZorroAttention(dim_tokens, dim_head, heads))
                self.add_module(f"mlp_{d}", Mlp(dim_tokens, int(dim_tokens * 4.0)))
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
        fusion/return tokens, task embeddings and class embeddings,
        normal(1.0) for the per-modality pool tokens
        (multimae_crossattn.py:105-109), a zero mask embedding and mask
        token, and flax LSTMCell's lecun-normal input and orthogonal
        recurrent kernels."""
        for name, module in self.named_modules():
            if isinstance(module, nn.Linear):
                split = 2 if name.endswith(("to_kv", ".kv")) else 3 if name.endswith("attn.qkv") else 1
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
            ad = self.input_adapters[d]
            if hasattr(ad, "class_emb"):
                trunc_normal_(ad.class_emb, generator)
        for ad in self.output_adapters.values():
            if isinstance(ad, SpatialOutputAdapterFull):
                nn.init.zeros_(ad.mask_token)
                for tk in ad.context_tasks:
                    trunc_normal_(getattr(ad, f"task_emb_{tk}"), generator)
            else:
                trunc_normal_(ad.task_emb, generator)
        if self.fusion_mode == "lstm":
            for cell in (self.attn_lstm.lstm_fwd, self.attn_lstm.lstm_bwd):
                for name, lin in cell.named_children():
                    if name.startswith("i"):
                        trunc_normal_(lin.weight, generator, std=lin.weight.shape[1] ** -0.5)
                    else:
                        with torch.no_grad():
                            nn.init.orthogonal_(lin.weight, generator=generator)
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

    def _decode(self, grid: torch.Tensor, packed_tokens: torch.Tensor, mask_info: MaskInfo, e: int,
                use_kernel: bool) -> Dict[str, torch.Tensor]:
        """The decoder of ``decoder_style``: the simple one over the fusion
        grid, or the full one over the packed encoder tokens."""
        if self.decoder_style == "full":
            return {d: self.output_adapters[d](packed_tokens, mask_info, e, use_kernel=use_kernel,
                                               patch_output=True) for d in self.out_domains}
        return self._decode_simple(grid, use_kernel)

    def _unpatchify_preds(self, preds_patch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for d, x in preds_patch.items():
            ad = self.output_adapters[d]
            n_h = ad.image_size // (ad.stride_level * ad.p)
            out[d] = unpatchify(x, ad.p, n_h, n_h, ad.num_channels)
        return out

    def _pool_returns(self, tokens: torch.Tensor, types: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """Attention pooling (multimae_crossattn.py:474-497, JAX :339-357):
        each return token sees its own modality's slots, the fusion return
        token everything valid; a modality with no visible slot attends
        uniformly over the valid keys (ops/attention.multihead_attention)."""
        b = tokens.shape[0]
        ret_types = torch.arange(len(self.in_domains) + 1, device=tokens.device)
        pool_mask = zorro_mask_from_types(ret_types[None].expand(b, -1), types, self.fusion_type,
                                          valid_k=valid)[:, None]
        ret = self.return_tokens.to(tokens.dtype).expand(b, -1, -1)
        ret = self.attn_pool(ret, context=tokens, attn_mask=pool_mask,
                             empty_rows_uniform_over=valid[:, None, None, :])
        return ret + self.mlp(self.norm(ret))

    def _modality_pool(self, d: str, context: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        """The contrastive pool of modality ``d`` over ``context`` [B, N, D]
        with ``key_mask`` [B, N]: the shared pool modules, or crossattn_v1's
        own per modality."""
        b = context.shape[0]
        attn, mlp = ((getattr(self, f"attn_{d}"), getattr(self, f"mlp_{d}")) if self.fusion_mode == "crossattn_v1"
                     else (self.attn_pool, self.mlp))
        p = getattr(self, f"return_token_{d}").to(context.dtype).expand(b, -1, -1)
        p = attn(p, context=context, attn_mask=key_mask[:, None, None, :])
        return (p + mlp(self.norm(p)))[:, 0]

    def _scatter_back(self, fusion_part: torch.Tensor, fusion_full: torch.Tensor, mask_info: MaskInfo,
                      e: int) -> torch.Tensor:
        """The packed fusion tokens back on the F-grid (multimae_lstm.py:484-494,
        JAX :359-374): grid position ``index % F`` takes the fusion token of
        the slot holding token ``index``; modality after modality, so a later
        modality overwrites an earlier one, as the reference's sequential
        scatter over cat(s1_idx, s2_idx, dem_idx) does. Positions no visible
        token reaches keep ``fusion_full``."""
        f = self.num_fusion_tokens
        slot = mask_info.ids_restore
        gathered = torch.gather(fusion_part, 1, slot.clamp(max=e - 1)[..., None].expand(-1, -1, fusion_part.shape[-1]))
        use = slot_use(mask_info, e)
        grid = fusion_full
        for m in range(len(self.in_domains)):
            grid = torch.where(use[:, m * f:(m + 1) * f, None], gathered[:, m * f:(m + 1) * f], grid)
        return grid

    def forward(self, x: Dict[str, torch.Tensor], mask_info: MaskInfo, num_encoded_tokens: int, trunk_fn=None):
        """x: {domain: [B, H, W, C]} NHWC ([B, H, W] integer class map for a
        semseg domain). A dropped modality still needs an input (zeros will
        do): its tokens are computed and fully masked out. Returns the JAX
        package's output dict.

        ``trunk_fn(tokens, aux)`` (pipeline parallelism,
        parallel/pp_multimae.py; ``crossattn`` only) replaces the loop over
        the (fusion block, encoder block) pairs (JAX multimae.py:480-497);
        ``aux`` is the layer-constant per-example context: ``slot``, ``use``,
        ``types`` (K1's) and ``mask_emb`` (the mask embedding in the compute
        dtype, whose gradient comes back through the trunk)."""
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
        if self.fusion_mode in GATHERED_MODES:
            return self._forward_gathered(tokens_in, fusion_tokens, mask_info, e, use_kernel)

        tokens, types, valid, kernel_types, slot, use = pack_tokens(
            tokens_in, fusion_tokens, mask_info, e, self.num_patches)
        mask_emb = self.mask_embedding.to(dtype)
        if trunk_fn is not None:
            if self.fusion_mode != "crossattn":
                raise ValueError("pp trunk supports fusion_mode='crossattn' only")
            tokens = trunk_fn(tokens, {"slot": slot, "use": use, "types": kernel_types, "mask_emb": mask_emb})
        for i, blk in enumerate(self.blocks if trunk_fn is None else ()):
            if self.fusion_mode == "crossattn":
                fusion_new = self.fus_blocks[i](tokens[:, :e], tokens[:, e:], mask_emb, slot, use,
                                                use_kernel=use_kernel)
                tokens = torch.cat([tokens[:, :e], fusion_new], dim=1)
            tokens = run_block(blk, tokens, kernel_types, self.fusion_type, use_kernel)
        tokens = self.norm(tokens)
        ret = self._pool_returns(tokens, types, valid)

        encoder_fusion_tokens = tokens[:, e:]
        preds_patch = self._decode(encoder_fusion_tokens, tokens[:, :e], mask_info, e, use_kernel)
        # contrastive pools over the fusion tokens at each modality's visible
        # positions (multimae_crossattn.py:529-543)
        pooled_mod = {d: self._modality_pool(d, encoder_fusion_tokens, mask_info.task_masks[d] == 0)
                      for d in self.in_domains}
        return {
            "preds": self._unpatchify_preds(preds_patch),
            "preds_patch": preds_patch,  # [B, F, p*p*C] per task
            "task_masks": mask_info.task_masks,
            "pooled": ret,  # [B, T+1, D]: per-modality + fusion pools
            "ori_tokens": tokens[:, :e],
            "fusion_tokens": encoder_fusion_tokens,
            "pooled_mod": pooled_mod,  # {domain: [B, D]}
        }

    def _forward_gathered(self, tokens_in, fusion_full: torch.Tensor, mask_info: MaskInfo, e: int,
                          use_kernel: bool):
        """``lstm`` and ``crossattn_v1`` (JAX multimae.py:568-690) over the
        2E layout ``[packed | fusion stream]``, the fusion stream the fusion
        token at each slot's grid position ``order % F``."""
        b, f, d = fusion_full.shape
        t_mod = len(self.in_domains)
        packed = pack_visible(tokens_in, mask_info, e)
        keep = mask_info.order[:, :e] % f
        fusion_stream = torch.gather(fusion_full, 1, keep[..., None].expand(-1, -1, d))
        layout = gathered_layout(mask_info, e, self.num_patches, t_mod)

        if self.fusion_mode == "lstm":
            # one BiLSTM fusion of each (modality token, fusion token) pair
            # (multimae_lstm.py:437-442)
            pairs = torch.stack([packed, fusion_stream], dim=2).reshape(b * e, 2, d)
            tokens = torch.cat([packed, self.attn_lstm(pairs).reshape(b, e, d)], dim=1)
            for blk in self.blocks:
                tokens = run_block(blk, tokens, layout.kernel_types, self.fusion_type, use_kernel)
        else:
            slot, use = mask_info.ids_restore, slot_use(mask_info, e)
            idx = slot.clamp(max=e - 1)[..., None].expand(-1, -1, d)
            mask_emb = self.mask_embedding.to(packed.dtype).repeat(1, t_mod, 1)
            pick = keep[:, :, None, None].expand(-1, -1, t_mod, d)  # each slot's grid position, every plane
            tokens = torch.cat([packed, fusion_stream], dim=1)
            for blk in self.blocks:
                cur, fus = tokens[:, :e], tokens[:, e:]
                # the visible tokens in mask-embedded per-modality grids, and
                # each slot's T-stack at its grid position
                # (multimae_crossattn_20231203.py:458-475)
                grid = torch.where(use[..., None], torch.gather(cur, 1, idx), mask_emb)
                grid = grid.reshape(b, t_mod, f, d).transpose(1, 2)  # [B, F, T, D]
                ctx = torch.gather(grid, 1, pick)  # [B, E, T, D]
                crossed = self.attn_pool_modalities(fus, ctx)
                fus = fus + self.mlp_modalities(self.norm(crossed))
                tokens = run_block(blk, torch.cat([cur, fus], dim=1), layout.kernel_types, self.fusion_type,
                                   use_kernel)
        tokens = self.norm(tokens)

        ret = self._pool_returns(tokens, layout.types, layout.valid)
        fusion_part = tokens[:, e:]  # aligned with the packed slots
        grid_complete = self._scatter_back(fusion_part, fusion_full, mask_info, e)
        preds_patch = self._decode(grid_complete, tokens[:, :e], mask_info, e, use_kernel)
        pooled_mod = {dm: self._modality_pool(dm, fusion_part, (layout.mod_types == i) & layout.slot_valid)
                      for i, dm in enumerate(self.in_domains)}
        return {
            "preds": self._unpatchify_preds(preds_patch),
            "preds_patch": preds_patch,
            "task_masks": mask_info.task_masks,
            "pooled": ret,
            "ori_tokens": tokens[:, :e],
            "fusion_tokens": grid_complete,
            "pooled_mod": pooled_mod,
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
        decoder_use_task_queries=cfg.decoder.use_task_queries,
        decoder_use_xattn=cfg.decoder.use_xattn,
    )
    model.init_weights(generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(device)
