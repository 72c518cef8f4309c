"""Mask2Former query decoder (JAX package models/mask2former_decoder.py;
reference transformer_decoder/mask2former_transformer_decoder.py:200-382):
learned queries, the three feature levels round-robin, masked
cross-attention whose mask is the previous layer's mask prediction
(sigmoid < 0.5 blocked, fully blocked rows unblocked), self-attention, FFN,
deep-supervision aux outputs, and the class and mask heads.

Batch-first NHWC, post-norm layers, plain PyTorch as the JAX package leaves
these to XLA; the masked attention is ``ops.attention.multihead_attention``.
Under the training step's bf16 weights the layers follow flax's dtype rule
(``layers.Dense``): the query stream (bf16 learned queries) computes in bf16,
the memory side (f32 pixel-decoder maps) in f32.
Submodules carry the flax names (``cross{i}``, ``self{i}``, ``ffn{i}``,
``mask_embed.layer{j}``).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multihead_attention
from ..ops.resize import resize_bilinear
from .layers import Dense, LayerNorm
from .position_encoding import position_embedding_sine


class MHA(nn.Module):
    """``torch.nn.MultiheadAttention``'s function with separate q/k/v/out
    projections (biases), True in ``attn_mask`` = may attend."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = Dense(d_model, d_model)
        self.k_proj = Dense(d_model, d_model)
        self.v_proj = Dense(d_model, d_model)
        self.out_proj = Dense(d_model, d_model)

    def forward(self, q, k, v, attn_mask=None):
        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], self.n_heads, -1)

        out = multihead_attention(heads(self.q_proj(q)), heads(self.k_proj(k)),
                                  heads(self.v_proj(v)), mask=attn_mask)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], -1))


class CrossAttentionLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.mha = MHA(d_model, n_heads)
        self.norm = LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory, attn_mask, pos, query_pos):
        tgt2 = self.mha(tgt + query_pos, memory + pos, memory, attn_mask=attn_mask)
        return self.norm(tgt + tgt2)


class SelfAttentionLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.mha = MHA(d_model, n_heads)
        self.norm = LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, query_pos):
        q = tgt + query_pos
        return self.norm(tgt + self.mha(q, q, tgt))


class FFNLayer(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int):
        super().__init__()
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.norm = LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt):
        return self.norm(tgt + self.linear2(F.relu(self.linear1(tgt))))


class MLP(nn.Module):
    """ReLU MLP of the mask-embedding head: ``layer0`` .. ``layer{n-1}``."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layer{i}", Dense(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class MultiScaleMaskedTransformerDecoder(nn.Module):
    def __init__(self, num_classes: int, hidden_dim: int = 256, num_queries: int = 100,
                 n_heads: int = 8, dim_feedforward: int = 2048, dec_layers: int = 3,
                 mask_dim: int = 256, num_feature_levels: int = 3):
        super().__init__()
        self.num_queries = num_queries
        self.dec_layers = dec_layers
        self.num_feature_levels = num_feature_levels
        self.level_embed = nn.Parameter(torch.zeros(num_feature_levels, hidden_dim))
        self.query_feat = nn.Parameter(torch.zeros(num_queries, hidden_dim))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, hidden_dim))
        for i in range(dec_layers):
            self.add_module(f"cross{i}", CrossAttentionLayer(hidden_dim, n_heads))
            self.add_module(f"self{i}", SelfAttentionLayer(hidden_dim, n_heads))
            self.add_module(f"ffn{i}", FFNLayer(hidden_dim, dim_feedforward))
        self.decoder_norm = LayerNorm(hidden_dim, eps=1e-5)
        self.class_embed = Dense(hidden_dim, num_classes + 1)
        self.mask_embed = MLP(hidden_dim, hidden_dim, mask_dim, 3)

    def _heads(self, output, mask_features, target_size):
        """Class logits, full-resolution mask logits and the next layer's
        attention mask [B, 1, Q, h*w] at ``target_size``."""
        dec = self.decoder_norm(output)
        logits = self.class_embed(dec)
        emb = self.mask_embed(dec)
        dt = torch.promote_types(emb.dtype, mask_features.dtype)
        masks = torch.einsum("bqc,bhwc->bqhw", emb.to(dt), mask_features.to(dt))
        # no antialiasing: the reference's F.interpolate does not filter
        # this 4-16x downsample, and a filter moves threshold bits
        small = resize_bilinear(masks.detach(), target_size, antialias=False)
        allowed = (torch.sigmoid(small) >= 0.5).flatten(2)
        allowed = allowed | ~allowed.any(dim=-1, keepdim=True)  # unblock fully blocked rows (:317)
        return logits, masks, allowed[:, None]

    def forward(self, x: List[torch.Tensor], mask_features: torch.Tensor):
        """x: multi-scale features low -> high resolution (NHWC);
        mask_features [B, H, W, mask_dim]. Returns {'pred_logits',
        'pred_masks' [B, Q, H, W], 'aux_outputs'}."""
        if len(x) != self.num_feature_levels:
            raise ValueError(f"expected {self.num_feature_levels} feature levels, got {len(x)}")
        b = x[0].shape[0]
        srcs, poss, sizes = [], [], []
        for i, f in enumerate(x):
            h, w = f.shape[1], f.shape[2]
            d = f.shape[-1]
            sizes.append((h, w))
            poss.append(position_embedding_sine(h, w, d // 2, device=f.device).reshape(1, h * w, d))
            srcs.append(f.reshape(b, h * w, d) + self.level_embed[i][None, None, :])

        output = self.query_feat[None].expand(b, -1, -1)
        qpos = self.query_embed[None].expand(b, -1, -1)
        pred_classes, pred_masks = [], []
        logits, masks, attn = self._heads(output, mask_features, sizes[0])
        pred_classes.append(logits)
        pred_masks.append(masks)
        for i in range(self.dec_layers):
            li = i % self.num_feature_levels
            output = getattr(self, f"cross{i}")(output, srcs[li], attn, poss[li], qpos)
            output = getattr(self, f"self{i}")(output, qpos)
            output = getattr(self, f"ffn{i}")(output)
            logits, masks, attn = self._heads(output, mask_features,
                                              sizes[(i + 1) % self.num_feature_levels])
            pred_classes.append(logits)
            pred_masks.append(masks)
        return {
            "pred_logits": pred_classes[-1],
            "pred_masks": pred_masks[-1],
            "aux_outputs": [{"pred_logits": c, "pred_masks": m}
                            for c, m in zip(pred_classes[:-1], pred_masks[:-1])],
        }
