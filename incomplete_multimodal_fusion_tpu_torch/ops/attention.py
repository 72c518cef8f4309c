"""Masked multi-head attention and the Zorro mask (JAX package
ops/attention.py).

The Zorro mask is block-structured over token types (modality-diagonal plus
a full fusion row, reference multimae_crossattn.py:431-447). With the packed
layout it is recomputed per forward from the packed token types.

Logits and softmax run in float32 whatever the activation dtype; the
probabilities are cast to the activation dtype before the value product,
where the JAX code casts them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

NEG_INF = -torch.finfo(torch.float32).max


def multihead_attention(
    q: torch.Tensor,  # [B, Nq, H, Dh]
    k: torch.Tensor,  # [B, Nk, H, Dh]
    v: torch.Tensor,  # [B, Nk, H, Dh]
    mask: Optional[torch.Tensor] = None,  # bool, broadcastable to [B, H, Nq, Nk]
    scale: Optional[float] = None,
    empty_rows_uniform_over: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked SDPA; True in ``mask`` = may attend (reference
    zorro_utils.py:184-194).

    A query row with no key to attend (the pool token of a modality with no
    visible token) attends uniformly over the keys marked True in
    ``empty_rows_uniform_over`` -- the reference's ``masked_fill(-max)`` then
    softmax does that over its whole sequence. Without it such a row is 0.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dtype = q.dtype
    sim = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    if mask is not None:
        sim = torch.where(mask, sim, torch.full_like(sim, NEG_INF))
    attn = torch.softmax(sim, dim=-1)
    if mask is not None:
        any_valid = mask.any(dim=-1, keepdim=True)
        if empty_rows_uniform_over is not None:
            w = empty_rows_uniform_over.to(attn.dtype)
            w = w / w.sum(dim=-1, keepdim=True).clamp(min=1.0)
            attn = torch.where(any_valid, attn, w)
        else:
            attn = torch.where(any_valid, attn, torch.zeros_like(attn))
    out = torch.einsum("bhij,bjhd->bihd", attn.to(dtype).float(), v.float())
    return out.to(dtype)


def zorro_mask_from_types(
    types_q: torch.Tensor,  # [.., Nq] int
    types_k: torch.Tensor,  # [.., Nk] int
    fusion_type: int,
    valid_k: Optional[torch.Tensor] = None,  # [.., Nk] bool, False = padding slot
) -> torch.Tensor:
    """(same type) OR (query is fusion); padded key slots never attended to."""
    m = (types_q[..., :, None] == types_k[..., None, :]) | (
        types_q[..., :, None] == fusion_type
    )
    if valid_k is not None:
        m = m & valid_k[..., None, :]
    return m


def zorro_mask_from_padded_types(types: torch.Tensor, fusion_type: int,
                                 pad_type: int) -> torch.Tensor:
    """The rule kernel K1 applies per tile: attend iff same type, or the
    query is fusion and the key is not padding."""
    tq = types[..., :, None]
    tk = types[..., None, :]
    return (tq == tk) | ((tq == fusion_type) & (tk != pad_type))


def packed_token_types(
    order: torch.Tensor,  # [B, N_total]
    num_tokens_per_task: Sequence[int],
    num_encoded_tokens: int,
    num_fusion_tokens: int,
    fusion_type: int,
) -> torch.Tensor:
    """Token-type id for each packed slot, plus the trailing fusion block.
    [B, E + F] int64."""
    bounds = torch.cumsum(torch.tensor(num_tokens_per_task, device=order.device), 0)
    full_types = torch.searchsorted(bounds, order[:, :num_encoded_tokens].contiguous(),
                                    right=True)
    fus = torch.full((order.shape[0], num_fusion_tokens), fusion_type,
                     dtype=full_types.dtype, device=order.device)
    return torch.cat([full_types, fus], dim=1)


def packed_valid(num_visible: torch.Tensor, num_encoded_tokens: int,
                 num_fusion_tokens: int) -> torch.Tensor:
    """[B, E + F] bool: True for real slots. Fusion tokens always valid."""
    slot = torch.arange(num_encoded_tokens, device=num_visible.device)[None, :]
    vis = slot < num_visible[:, None]
    fus = torch.ones((num_visible.shape[0], num_fusion_tokens), dtype=torch.bool,
                     device=num_visible.device)
    return torch.cat([vis, fus], dim=1)
