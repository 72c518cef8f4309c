"""MaskFormer segmentation model (JAX package models/maskformer.py;
reference MaskFormerModel_vit.py:22-105): the incomplete-fusion ViT
backbone -> 4-level pyramid -> MSDeformAttn pixel decoder -> Mask2Former
query decoder -> {'pred_logits', 'pred_masks', 'aux_outputs'}.

Every backbone of the JAX package: 'vit' ('crossattn' or 'sup' fusion),
'vit_adapter', 'resnet18' / '34' / '50' / '101' / '152' and 'swin' (the
last two on ``x[cfg.resnet_input]`` alone, with no masks); the pixel
decoder's widths follow the backbone's. Either decoder: 'mask2former'
(multi-scale, masked) or 'standard' (DETR-style, on the lowest-resolution
map).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import modalities as modreg
from ..ops.masking import MaskInfo, full_visible_mask_info
from .layers import GroupNorm, LayerNorm, trunc_normal_, xavier_uniform_
from .mask2former_decoder import MultiScaleMaskedTransformerDecoder
from .maskformer_decoder import StandardTransformerDecoder
from .msda_module import MSDeformAttn
from .pixel_decoder import MSDeformAttnPixelDecoder
from .resnet import RESNET_SPEC, ResNet
from .swin import SwinTransformer
from .vit_adapter import Injector, SpatialPriorModule
from .vit_baseline import ConvTranspose2x2, ViTBaseline

BACKBONES = ("vit", "vit_adapter", "swin") + tuple(f"resnet{d}" for d in RESNET_SPEC)
DECODERS = ("mask2former", "standard")


@dataclass(frozen=True)
class MaskFormerConfig:
    """Downstream model config (reference configs/maskformer_ake150.yaml +
    Base-segmention.yaml schema), the JAX package's fields and defaults."""

    in_domains: Tuple[str, ...] = ("s1", "s2", "dem")
    image_size: int = 256
    patch_size: int = 16
    num_classes: int = 1  # instance: building-only; semantic: land-cover K
    # backbone (tiny, MaskFormerModel_vit.py:756-795 factory)
    dim_tokens: int = 192
    depth: int = 12
    dim_head: int = 64
    heads: int = 3
    num_fusion_tokens: int = 256
    frozen_stages: int = 11
    fusion_mode: str = "crossattn"
    backbone_type: str = "vit"
    resnet_input: str = "s2"
    # head (maskformer_ake150.yaml)
    conv_dim: int = 256
    mask_dim: int = 256
    transformer_enc_layers: int = 2
    num_fpn_levels: int = 2
    num_queries: int = 100
    dec_layers: int = 3
    dim_feedforward: int = 2048
    decoder_type: str = "mask2former"
    pre_norm: bool = False
    keep_ratio: float = 0.9  # train-time visible-token ratio

    @property
    def num_patches(self) -> int:
        n = self.image_size // self.patch_size
        return n * n

    @property
    def max_encoded_tokens(self) -> int:
        """Static packed size: ceil(keep_ratio * all tokens), 128-aligned,
        clamped to the total token count."""
        total = self.num_patches * len(self.in_domains)
        e = int(self.keep_ratio * total)
        return min(((e + 127) // 128) * 128, total)


class MaskFormerModel(nn.Module):
    """``attn_impl`` ('auto' | 'pallas' | 'xla') routes the backbone's
    attention and feed-forwards and the pixel decoder's deformable
    attention: through the kernels' wrappers, or 'xla' through the plain
    versions everywhere."""

    def __init__(self, cfg: MaskFormerConfig, attn_impl: str = "auto"):
        super().__init__()
        if cfg.backbone_type not in BACKBONES:
            raise ValueError(f"backbone_type must be one of {BACKBONES}, got {cfg.backbone_type!r}")
        if cfg.decoder_type not in DECODERS:
            raise ValueError(f"decoder_type must be one of {DECODERS}, got {cfg.decoder_type!r}")
        self.cfg = cfg
        in_ch = modreg.get(cfg.resnet_input).num_channels
        if cfg.backbone_type.startswith("resnet"):
            self.backbone = ResNet(int(cfg.backbone_type[len("resnet"):]), in_ch)
        elif cfg.backbone_type == "swin":
            self.backbone = SwinTransformer(in_channels=in_ch)
        else:
            self.backbone = ViTBaseline(
                in_domains=cfg.in_domains, image_size=cfg.image_size, patch_size=cfg.patch_size,
                dim_tokens=cfg.dim_tokens, depth=cfg.depth, dim_head=cfg.dim_head, heads=cfg.heads,
                num_fusion_tokens=cfg.num_fusion_tokens,
                fusion_mode="crossattn" if cfg.backbone_type == "vit_adapter" else cfg.fusion_mode,
                adapter=cfg.backbone_type == "vit_adapter")
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            self.backbone.out_channels, conv_dim=cfg.conv_dim, mask_dim=cfg.mask_dim,
            transformer_enc_layers=cfg.transformer_enc_layers, num_fpn_levels=cfg.num_fpn_levels)
        if cfg.decoder_type == "standard":
            self.predictor = StandardTransformerDecoder(
                num_classes=cfg.num_classes, in_channels=cfg.conv_dim, hidden_dim=cfg.conv_dim,
                num_queries=cfg.num_queries, dec_layers=cfg.dec_layers, dim_feedforward=cfg.dim_feedforward,
                mask_dim=cfg.mask_dim, pre_norm=cfg.pre_norm)
        else:
            self.predictor = MultiScaleMaskedTransformerDecoder(
                num_classes=cfg.num_classes, hidden_dim=cfg.conv_dim, num_queries=cfg.num_queries,
                dec_layers=cfg.dec_layers, dim_feedforward=cfg.dim_feedforward, mask_dim=cfg.mask_dim)
        self.attn_impl = attn_impl

    @property
    def attn_impl(self) -> str:
        """The route of the modules that read it (every model's pixel
        decoder has deformable attention)."""
        return next(m.impl for m in self.modules() if isinstance(m, MSDeformAttn))

    @attn_impl.setter
    def attn_impl(self, impl: str) -> None:
        if impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"attn_impl must be 'auto', 'pallas' or 'xla', got {impl!r}")
        for m in self.modules():
            if isinstance(m, MSDeformAttn):
                m.impl = impl
            elif isinstance(m, ViTBaseline):
                m.attn_impl = impl

    def init_weights(self, generator: torch.Generator) -> "MaskFormerModel":
        """The JAX package's initializers, drawn from ``generator``:
        xavier-uniform for every projection and convolution (fused xavier for
        the packed kv), zero biases, unit norm weights, He-normal (fan-out)
        for the transposed convolutions, the sampling-offset grid with zero
        sampling kernels, truncated normal 0.02 for the fusion and return
        tokens and the adapter's level embedding, a zero mask embedding and
        a zero injector gamma, normal(1.0) for the level embeddings and the
        queries; flax's defaults (lecun-normal kernels) for the ResNet, Swin
        and spatial-prior convolutions and Swin's projections."""
        for name, module in self.named_modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                w = module.weight
                if w.dim() == 2:
                    xavier_uniform_(w, generator, 2 if name.endswith("to_kv") else 1)
                else:  # [out, in, kh, kw]: fans over the receptive field
                    field = w.shape[2] * w.shape[3]
                    val = math.sqrt(6.0 / ((w.shape[0] + w.shape[1]) * field))
                    with torch.no_grad():
                        w.uniform_(-val, val, generator=generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
            elif isinstance(module, ConvTranspose2x2):
                fan_out = module.weight.shape[1] * module.weight.shape[2] * module.weight.shape[3]
                with torch.no_grad():
                    module.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
                nn.init.zeros_(module.bias)
            elif isinstance(module, (LayerNorm, GroupNorm)):
                nn.init.ones_(module.weight)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
        for module in self.modules():
            if isinstance(module, MSDeformAttn):
                module.reset_offsets()
            elif isinstance(module, Injector):
                nn.init.zeros_(module.gamma)
            elif isinstance(module, (ResNet, SwinTransformer, SpatialPriorModule)):
                module.init_weights(generator)
        bb = self.backbone
        if isinstance(bb, ViTBaseline):
            if bb.fusion_mode == "crossattn":
                trunc_normal_(bb.fusion_tokens, generator)
                nn.init.zeros_(bb.mask_embedding)
            else:
                trunc_normal_(bb.return_tokens, generator)
            if bb.adapter:
                trunc_normal_(bb.adapter_level_embed, generator)
        embeds = [self.pixel_decoder.level_embed, self.predictor.query_embed]
        if isinstance(self.predictor, MultiScaleMaskedTransformerDecoder):
            embeds += [self.predictor.level_embed, self.predictor.query_feat]
        with torch.no_grad():
            for p in embeds:
                p.normal_(0.0, 1.0, generator=generator)
        return self

    def forward(self, x: Dict[str, torch.Tensor], mask_info: Optional[MaskInfo] = None,
                num_encoded_tokens: Optional[int] = None, present: Optional[torch.Tensor] = None):
        """x: {domain: [B, H, W, C]} NHWC. Without ``mask_info`` every token
        is visible (the eval path); with it, ``num_encoded_tokens`` slots
        (default ``cfg.max_encoded_tokens``) are packed."""
        c = self.cfg
        if not isinstance(self.backbone, ViTBaseline):  # the CNN variants: one input, no masks
            return self._head(self.backbone(x[c.resnet_input]))
        b = x[c.in_domains[0]].shape[0]
        if mask_info is None:
            mask_info = full_visible_mask_info(c.in_domains, (c.num_patches,) * len(c.in_domains), b,
                                               device=x[c.in_domains[0]].device)
            e = c.num_patches * len(c.in_domains)
        else:
            e = num_encoded_tokens or c.max_encoded_tokens
        return self._head(self.backbone(x, mask_info, e, present=present))

    def _head(self, feats):
        mask_features, ms_feats = self.pixel_decoder(feats)
        if isinstance(self.predictor, StandardTransformerDecoder):
            return self.predictor(ms_feats[0], mask_features)
        return self.predictor(ms_feats, mask_features)


def build_maskformer(cfg: MaskFormerConfig, device="cuda",
                     generator: Optional[torch.Generator] = None) -> MaskFormerModel:
    """Build a MaskFormerModel from ``cfg``, initialized on the CPU with the
    JAX package's initializers drawn from ``generator`` (seed 0 when None),
    then moved to ``device``: the card unless the caller asks for the CPU.
    Raises when the device is CUDA and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_maskformer: no CUDA device; pass device='cpu' to build on the CPU")
    model = MaskFormerModel(cfg)
    model.init_weights(generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(device)
