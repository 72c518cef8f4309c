"""Downstream incomplete-fusion ViT backbone (JAX package
models/vit_baseline.py; reference multimae/multimae_big_imcomplete.py,
multimae_sup.py and multimae_big_adapter.py).

``fusion_mode='crossattn'``: the pretraining fusion-token encoder with the
packed layout of ``models.multimae``, plus:
  * ``present`` [T] bool: the planes of absent modalities are left out of
    every fusion block's slot attention (the reference does not stack them,
    :645-655), which runs the plain slot attention, not kernel K3;
  * the fusion stream tapped at 4 depths (``tap_layers``, every depth // 4,
    :428), layer-normed, laid out on the fusion grid and expanded into a
    4-level pyramid: 4x (ConvT-GN-GELU-ConvT), 2x ConvT, identity, 0.5x
    max-pool (:432-445, :666-680);
  * with ``adapter`` the ViT-Adapter (models/vit_adapter.py): a spatial
    prior module on s2's pixels, an injector before
    the first block of each of ``interaction_groups`` (it replaces the
    fusion tokens) and an extractor after its last block (it updates the
    priors), both deformable attention (kernel K4); the priors' maps are
    added to the ViT pyramid (multimae_big_adapter.py:296-330).

``fusion_mode='sup'``: the supervised baseline (multimae_sup.py): the
blocks attend over all modalities' tokens unmasked, posemb'd return
tokens pool the last stream (``attn_pool``), and that one map feeds all
four pyramid taps. ``mask_info`` and ``present`` do not reach it, as in
JAX.

The encoder attention runs kernel K1 (zorro mode; unmasked mode in 'sup',
where JAX runs the same function plain) and the feed-forwards kernel K2
unless ``attn_impl`` is 'xla'. Parameter names follow the flax tree.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import modalities as modreg
from ..ops.masking import MaskInfo
from ..ops.posemb import build_2d_sincos_posemb
from .adapters import PatchedInputAdapter
from .layers import BiaslessLayerNorm, EncoderBlock, FusionBlockFast, GroupNorm, Mlp, ZorroAttention
from .multimae import pack_tokens
from .pixel_decoder import reference_points_for
from .vit_adapter import Extractor, Injector, SpatialPriorModule

ADAPTER_PRIOR_INPUT = "s2"  # the modality whose pixels the ViT-Adapter's prior module reads


class ConvTranspose2x2(nn.Module):
    """flax ``nn.ConvTranspose(out, (2, 2), strides=(2, 2))`` on NHWC maps:
    each input pixel spreads over a 2x2 block of the output. ``weight`` is
    in ``F.conv_transpose2d``'s layout [in, out, 2, 2]."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(in_channels, out_channels, 2, 2))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        y = torch.einsum("bhwc,coij->bhiwjo", x, self.weight)
        return y.reshape(b, 2 * h, 2 * w, -1) + self.bias


class FeaturePyramid(nn.Module):
    """up1..up4 pyramid (multimae_big_imcomplete.py:432-445). ``up1_gn``
    has flax's default GroupNorm epsilon, 1e-6."""

    def __init__(self, dim: int):
        super().__init__()
        self.up1_conv1 = ConvTranspose2x2(dim, dim)
        self.up1_gn = GroupNorm(dim, 32, eps=1e-6)
        self.up1_conv2 = ConvTranspose2x2(dim, dim)
        self.up2_conv = ConvTranspose2x2(dim, dim)

    def forward(self, f1, f2, f3, f4):
        x1 = self.up1_conv2(F.gelu(self.up1_gn(self.up1_conv1(f1))))
        x2 = self.up2_conv(f2)
        b, h, w, c = f4.shape
        x4 = f4[:, :h // 2 * 2, :w // 2 * 2].reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
        return [x1, x2, f3, x4]


def tap_layers(depth: int):
    """[i for i in range(-1, depth, depth // 4)][1:]
    (multimae_big_imcomplete.py:428), the first repeated for nets shallower
    than 4 taps."""
    step = max(depth // 4, 1)
    taps = [i for i in range(-1, depth, step)][1:][-4:]
    return [taps[0]] * (4 - len(taps)) + taps


def interaction_groups(depth: int):
    """The block slices [(first, last)] each wrapped by one injector /
    extractor pair: from one tap to the next (multimae_big_adapter.py
    interaction_indexes, :311-314)."""
    out, prev = [], -1
    for last in sorted(set(tap_layers(depth))):
        out.append((prev + 1, last))
        prev = last
    return out


class ViTBaseline(nn.Module):
    def __init__(
        self,
        in_domains: Tuple[str, ...] = ("s1", "s2", "dem"),
        image_size: int = 256,
        patch_size: int = 16,
        dim_tokens: int = 192,
        depth: int = 12,
        dim_head: int = 64,
        heads: int = 3,
        ff_mult: int = 4,
        num_fusion_tokens: int = 256,
        attn_impl: str = "auto",
        fusion_mode: str = "crossattn",
        adapter: bool = False,
    ):
        super().__init__()
        if fusion_mode not in ("crossattn", "sup"):
            raise ValueError(f"fusion_mode must be 'crossattn' or 'sup', got {fusion_mode!r}")
        if attn_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"attn_impl must be 'auto', 'pallas' or 'xla', got {attn_impl!r}")
        self.in_domains = tuple(in_domains)
        self.image_size = image_size
        self.patch_size = patch_size
        self.dim_tokens = dim_tokens
        self.depth = depth
        self.num_fusion_tokens = num_fusion_tokens
        self.attn_impl = attn_impl
        self.fusion_mode = fusion_mode
        # the 'sup' forward never reaches the adapter, so it has none
        self.adapter = adapter and fusion_mode == "crossattn"
        if num_fusion_tokens != self.num_patches:
            raise ValueError("num_fusion_tokens must equal the number of patches (the fusion grid)")

        self.input_adapters = nn.ModuleDict()
        for d in self.in_domains:
            spec = modreg.get(d)
            if spec.adapter != "patched":
                raise NotImplementedError(f"the {spec.adapter!r} input adapter is not ported yet")
            self.input_adapters[d] = PatchedInputAdapter(
                spec.num_channels, dim_tokens, patch_size, image_size, spec.stride_level)
        self.blocks = nn.ModuleList(
            EncoderBlock(dim_tokens, dim_head, heads, ff_mult) for _ in range(depth))
        if fusion_mode == "crossattn":
            self.fusion_tokens = nn.Parameter(torch.zeros(1, num_fusion_tokens, dim_tokens))
            self.mask_embedding = nn.Parameter(torch.zeros(1, num_fusion_tokens, dim_tokens))
            self.fus_blocks = nn.ModuleList(
                FusionBlockFast(dim_tokens, dim_head, heads, ff_mult) for _ in range(depth))
        else:  # 'sup' (multimae_sup.py:78-85)
            self.return_tokens = nn.Parameter(torch.zeros(1, num_fusion_tokens, dim_tokens))
            self.attn_pool = ZorroAttention(dim_tokens, dim_head, heads)
            self.mlp = Mlp(dim_tokens, dim_tokens * 4)
        self.norm = BiaslessLayerNorm(dim_tokens)
        self.pyramid = FeaturePyramid(dim_tokens)
        if self.adapter:
            # priors, 3-level embedding and the c1 top-up
            # (multimae_big_adapter.py:250, :262)
            self.spm = SpatialPriorModule(modreg.get(ADAPTER_PRIOR_INPUT).num_channels, dim_tokens)
            for i in range(len(self.interaction_groups)):
                self.add_module(f"injector{i}", Injector(dim_tokens, 3))
                self.add_module(f"extractor{i}", Extractor(dim_tokens))
            self.adapter_level_embed = nn.Parameter(torch.zeros(3, dim_tokens))
            self.adapter_up = ConvTranspose2x2(dim_tokens, dim_tokens)

    @property
    def num_patches(self) -> int:
        n = self.image_size // self.patch_size
        return n * n

    @property
    def tap_layers(self):
        return tap_layers(self.depth)

    @property
    def interaction_groups(self):
        return interaction_groups(self.depth)

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return (self.dim_tokens,) * 4

    def forward(self, x: Dict[str, torch.Tensor], mask_info: MaskInfo, num_encoded_tokens: int,
                present: Optional[torch.Tensor] = None):
        """x: {domain: [B, H, W, C]} NHWC; present [T] bool (default all).
        Returns the 4 pyramid maps, NHWC, high -> low resolution."""
        e = num_encoded_tokens
        b = x[self.in_domains[0]].shape[0]
        use_kernel = self.attn_impl != "xla"
        tokens_in = [self.input_adapters[d](x[d]) for d in self.in_domains]
        dtype, device = tokens_in[0].dtype, tokens_in[0].device
        if self.fusion_mode == "sup":
            return self._forward_sup(tokens_in, b, use_kernel)
        if present is None:
            present = torch.ones(len(self.in_domains), dtype=torch.bool, device=device)

        hp = self.image_size // self.patch_size
        fus_pos = build_2d_sincos_posemb(hp, hp, self.dim_tokens, device=device)
        fusion_tokens = (self.fusion_tokens + fus_pos[None]).to(dtype).expand(b, -1, -1)
        tokens, _, _, kernel_types, slot, use = pack_tokens(
            tokens_in, fusion_tokens, mask_info, e, self.num_patches)
        # fusion-stack plane validity: absent modalities' planes are left out
        plane_valid = torch.cat([present.to(device=device, dtype=torch.bool),
                                 torch.ones(1, dtype=torch.bool, device=device)])

        if self.adapter:
            # the priors (multimae_big_adapter.py:296-302); the prior module
            # reads its input's pixels whatever ``present`` says
            priors = self.spm(x[ADAPTER_PRIOR_INPUT].to(dtype))
            c1 = priors[0]  # stride 4
            cs = [p + self.adapter_level_embed[i].to(dtype) for i, p in enumerate(priors[1:])]
            prior_shapes = [(p.shape[1], p.shape[2]) for p in cs]
            priors_flat = torch.cat([p.reshape(b, -1, self.dim_tokens) for p in cs], dim=1)
            token_shape = (hp, hp)
            # one reference point a token, the same on every prior level; one
            # a prior position on the token map
            tok_ref = reference_points_for([token_shape], device=device)[None, :, :1]
            tok_ref = tok_ref.expand(b, -1, len(prior_shapes), -1)
            prior_ref = reference_points_for(prior_shapes, device=device)[None, :, :1].expand(b, -1, -1, -1)
            first = {s: g for g, (s, _) in enumerate(self.interaction_groups)}
            last = {l: g for g, (_, l) in enumerate(self.interaction_groups)}

        mask_emb = self.mask_embedding.to(dtype)
        taps = set(self.tap_layers)
        fusion_outs = {}
        for i, (blk, fus_blk) in enumerate(zip(self.blocks, self.fus_blocks)):
            if self.adapter and i in first:  # inject the priors before the group's first block
                fus = getattr(self, f"injector{first[i]}")(tokens[:, e:], tok_ref, priors_flat, prior_shapes)
                tokens = torch.cat([tokens[:, :e], fus], dim=1)
            fusion_new = fus_blk(tokens[:, :e], tokens[:, e:], mask_emb, slot, use,
                                 plane_valid=plane_valid, use_kernel=use_kernel)
            tokens = torch.cat([tokens[:, :e], fusion_new], dim=1)
            tokens = blk(tokens, kernel_types, len(self.in_domains), use_kernel=use_kernel)
            if i in taps:
                fusion_outs[i] = tokens[:, e:]
            if self.adapter and i in last:  # extract after the group's last block
                priors_flat = getattr(self, f"extractor{last[i]}")(priors_flat, prior_ref, tokens[:, e:],
                                                                   token_shape)
        feats = [self.norm(fusion_outs[t]).reshape(b, hp, hp, self.dim_tokens)
                 for t in self.tap_layers]
        vit_pyr = self.pyramid(*feats)
        if not self.adapter:
            return vit_pyr
        # the enriched priors back to maps, c1 = up(c2) + c1, plus the ViT
        # pyramid (add_vit_feature, multimae_big_adapter.py:318-330)
        c_maps, start = [], 0
        for h, w in prior_shapes:
            c_maps.append(priors_flat[:, start:start + h * w].reshape(b, h, w, -1))
            start += h * w
        outs = [self.adapter_up(c_maps[0]) + c1] + c_maps
        return [o + v for o, v in zip(outs, vit_pyr)]

    def _forward_sup(self, tokens_in, b: int, use_kernel: bool):
        """The supervised baseline (multimae_sup.py:315-357): unmasked blocks
        over every modality's tokens, the posemb'd return tokens pool the
        last stream, and that map feeds all 4 pyramid taps."""
        hp = self.image_size // self.patch_size
        tokens = torch.cat(tokens_in, dim=1)
        for blk in self.blocks:
            tokens = blk(tokens, None, None, use_kernel=use_kernel)
        pos = build_2d_sincos_posemb(hp, hp, self.dim_tokens, device=tokens.device)
        ret = (self.return_tokens + pos[None]).to(tokens.dtype).expand(b, -1, -1)
        ret = self.attn_pool(ret, context=tokens)
        ret = ret + self.mlp(self.norm(ret))
        feat = self.norm(ret).reshape(b, hp, hp, self.dim_tokens)
        return self.pyramid(feat, feat, feat, feat)
