"""The original DETR-style MaskFormer query decoder,
``StandardTransformerDecoder`` (JAX package models/maskformer_decoder.py;
reference transformer_decoder/maskformer_transformer_decoder.py:12-106 and
the vendored DETR transformer.py:19-369).

Unlike the Mask2Former decoder: one feature level, no masked
cross-attention, an optional self-attention encoder over the memory
(``enc_layers``), and queries that start at zero with a learned positional
embedding. Post-norm by default, pre-norm with ``pre_norm``: both orders of
DETR's layers (transformer.py:204-340). flax's LayerNorm epsilon, 1e-6.
Batch-first NHWC; the attention is ``ops.attention.multihead_attention``
(no TPU kernel: plain PyTorch, as JAX leaves it to XLA). Its output dict is
the Mask2Former decoder's, aux outputs included, so the set criterion and
the segmentation entry points take it unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, LayerNorm
from .mask2former_decoder import MHA, MLP
from .position_encoding import position_embedding_sine

EPS = 1e-6  # flax nn.LayerNorm's default


class _EncoderLayer(nn.Module):
    """DETR TransformerEncoderLayer (transformer.py:204-252): self-attention
    over the memory with ``pos`` on q and k, then the ReLU FFN."""

    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int, pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.norm1 = LayerNorm(d_model, eps=EPS)
        self.norm2 = LayerNorm(d_model, eps=EPS)
        self.self_attn = MHA(d_model, n_heads)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)

    def _ffn(self, x):
        return self.linear2(F.relu(self.linear1(x)))

    def forward(self, src, pos):
        if self.pre_norm:
            h = self.norm1(src)
            src = src + self.self_attn(h + pos, h + pos, h)
            return src + self._ffn(self.norm2(src))
        src = self.norm1(src + self.self_attn(src + pos, src + pos, src))
        return self.norm2(src + self._ffn(src))


class _DecoderLayer(nn.Module):
    """DETR TransformerDecoderLayer (transformer.py:254-340): query
    self-attention, cross-attention into the memory (``query_pos`` / ``pos``
    on q / k), the ReLU FFN."""

    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int, pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.norm1 = LayerNorm(d_model, eps=EPS)
        self.norm2 = LayerNorm(d_model, eps=EPS)
        self.norm3 = LayerNorm(d_model, eps=EPS)
        self.self_attn = MHA(d_model, n_heads)
        self.multihead_attn = MHA(d_model, n_heads)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)

    def _ffn(self, x):
        return self.linear2(F.relu(self.linear1(x)))

    def forward(self, tgt, memory, pos, query_pos):
        if self.pre_norm:
            h = self.norm1(tgt)
            tgt = tgt + self.self_attn(h + query_pos, h + query_pos, h)
            h = self.norm2(tgt)
            tgt = tgt + self.multihead_attn(h + query_pos, memory + pos, memory)
            return tgt + self._ffn(self.norm3(tgt))
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory))
        return self.norm3(tgt + self._ffn(tgt))


class StandardTransformerDecoder(nn.Module):
    """maskformer_transformer_decoder.py:12-106: the sine position encoding
    of the one feature map, an input projection where its width is not
    ``hidden_dim``, zero queries with a learned ``query_embed``, the DETR
    stack with deep supervision, the class and mask heads. ``in_channels``
    is the feature map's width. (JAX's ``deep_supervision``,
    ``mask_classification`` and ``enforce_input_project`` switches are left
    at their defaults by every caller, and are not ported.)"""

    def __init__(self, num_classes: int, in_channels: int, hidden_dim: int = 256, num_queries: int = 100,
                 n_heads: int = 8, dim_feedforward: int = 2048, enc_layers: int = 0, dec_layers: int = 10,
                 mask_dim: int = 256, pre_norm: bool = False):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_queries = num_queries
        self.enc_layers = enc_layers
        self.dec_layers = dec_layers
        self.pre_norm = pre_norm
        if in_channels != hidden_dim:
            # a 1x1 convolution is a Dense on the flattened map (input_proj, :53-57)
            self.input_proj = Dense(in_channels, hidden_dim)
        for i in range(enc_layers):
            self.add_module(f"enc{i}", _EncoderLayer(hidden_dim, n_heads, dim_feedforward, pre_norm))
        if enc_layers and pre_norm:
            self.encoder_norm = LayerNorm(hidden_dim, eps=EPS)
        self.query_embed = nn.Parameter(torch.zeros(num_queries, hidden_dim))
        for i in range(dec_layers):
            self.add_module(f"dec{i}", _DecoderLayer(hidden_dim, n_heads, dim_feedforward, pre_norm))
        self.decoder_norm = LayerNorm(hidden_dim, eps=EPS)
        self.class_embed = Dense(hidden_dim, num_classes + 1)
        self.mask_embed = MLP(hidden_dim, hidden_dim, mask_dim, 3)

    def _heads(self, dec, mask_features):
        logits = self.class_embed(dec)
        emb = self.mask_embed(dec)
        dt = torch.promote_types(emb.dtype, mask_features.dtype)
        return logits, torch.einsum("bqc,bhwc->bqhw", emb.to(dt), mask_features.to(dt))

    def forward(self, x: torch.Tensor, mask_features: torch.Tensor):
        """x [B, H, W, C] one feature level; mask_features [B, Hm, Wm,
        mask_dim]. Returns {'pred_logits', 'pred_masks' [B, Q, Hm, Wm],
        'aux_outputs'}."""
        b, h, w, c = x.shape
        d = self.hidden_dim
        pos = position_embedding_sine(h, w, d // 2, device=x.device).reshape(1, h * w, d)
        src = x.reshape(b, h * w, c)
        if hasattr(self, "input_proj"):
            src = self.input_proj(src)
        for i in range(self.enc_layers):
            src = getattr(self, f"enc{i}")(src, pos)
        if self.enc_layers and self.pre_norm:
            src = self.encoder_norm(src)
        qpos = self.query_embed[None].expand(b, -1, -1)
        tgt = torch.zeros((b, self.num_queries, d), dtype=src.dtype, device=src.device)  # transformer.py:71
        intermediate = []
        for i in range(self.dec_layers):
            tgt = getattr(self, f"dec{i}")(tgt, src, pos, qpos)
            intermediate.append(self.decoder_norm(tgt))

        outs = [self._heads(dec, mask_features) for dec in intermediate]
        return {"pred_logits": outs[-1][0], "pred_masks": outs[-1][1],
                "aux_outputs": [{"pred_logits": lg, "pred_masks": m} for lg, m in outs[:-1]]}
