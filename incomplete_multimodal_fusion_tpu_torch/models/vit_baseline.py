"""Downstream incomplete-fusion ViT backbone, ``crossattn`` mode (JAX
package models/vit_baseline.py; reference multimae/
multimae_big_imcomplete.py).

The pretraining fusion-token encoder with the packed layout of
``models.multimae``, plus:
  * ``present`` [T] bool: the planes of absent modalities are left out of
    every fusion block's slot attention (the reference does not stack them,
    :645-655), which runs the plain slot attention, not kernel K3;
  * the fusion stream tapped at 4 depths (``tap_layers``, every depth // 4,
    :428), layer-normed, laid out on the fusion grid and expanded into a
    4-level pyramid: 4x (ConvT-GN-GELU-ConvT), 2x ConvT, identity, 0.5x
    max-pool (:432-445, :666-680).

The encoder attention runs kernel K1 and the feed-forwards kernel K2 unless
``attn_impl`` is 'xla'. Parameter names follow the flax tree. The 'sup'
fusion mode and the ViT-Adapter are not ported yet and raise.
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
from .layers import BiaslessLayerNorm, EncoderBlock, FusionBlockFast, GroupNorm
from .multimae import pack_tokens


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
        if fusion_mode != "crossattn":
            raise NotImplementedError(f"fusion_mode={fusion_mode!r} is not ported yet")
        if adapter:
            raise NotImplementedError("the ViT-Adapter backbone is not ported yet")
        if attn_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"attn_impl must be 'auto', 'pallas' or 'xla', got {attn_impl!r}")
        self.in_domains = tuple(in_domains)
        self.image_size = image_size
        self.patch_size = patch_size
        self.dim_tokens = dim_tokens
        self.depth = depth
        self.num_fusion_tokens = num_fusion_tokens
        self.attn_impl = attn_impl
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
        self.fusion_tokens = nn.Parameter(torch.zeros(1, num_fusion_tokens, dim_tokens))
        self.mask_embedding = nn.Parameter(torch.zeros(1, num_fusion_tokens, dim_tokens))
        self.fus_blocks = nn.ModuleList(
            FusionBlockFast(dim_tokens, dim_head, heads, ff_mult) for _ in range(depth))
        self.norm = BiaslessLayerNorm(dim_tokens)
        self.pyramid = FeaturePyramid(dim_tokens)

    @property
    def num_patches(self) -> int:
        n = self.image_size // self.patch_size
        return n * n

    @property
    def tap_layers(self):
        """[i for i in range(-1, depth, depth // 4)][1:]
        (multimae_big_imcomplete.py:428), the first repeated for nets
        shallower than 4 taps."""
        step = max(self.depth // 4, 1)
        taps = [i for i in range(-1, self.depth, step)][1:][-4:]
        return [taps[0]] * (4 - len(taps)) + taps

    def forward(self, x: Dict[str, torch.Tensor], mask_info: MaskInfo, num_encoded_tokens: int,
                present: Optional[torch.Tensor] = None):
        """x: {domain: [B, H, W, C]} NHWC; present [T] bool (default all).
        Returns the 4 pyramid maps, NHWC, high -> low resolution."""
        e = num_encoded_tokens
        b = x[self.in_domains[0]].shape[0]
        use_kernel = self.attn_impl != "xla"
        tokens_in = [self.input_adapters[d](x[d]) for d in self.in_domains]
        dtype, device = tokens_in[0].dtype, tokens_in[0].device
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

        mask_emb = self.mask_embedding.to(dtype)
        taps = set(self.tap_layers)
        fusion_outs = {}
        for i, (blk, fus_blk) in enumerate(zip(self.blocks, self.fus_blocks)):
            fusion_new = fus_blk(tokens[:, :e], tokens[:, e:], mask_emb, slot, use,
                                 plane_valid=plane_valid, use_kernel=use_kernel)
            tokens = torch.cat([tokens[:, :e], fusion_new], dim=1)
            tokens = blk(tokens, kernel_types, len(self.in_domains), use_kernel=use_kernel)
            if i in taps:
                fusion_outs[i] = tokens[:, e:]
        feats = [self.norm(fusion_outs[t]).reshape(b, hp, hp, self.dim_tokens)
                 for t in self.tap_layers]
        return self.pyramid(*feats)
