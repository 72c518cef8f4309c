"""Segmentation inference post-processing (JAX package eval/metrics.py:
``semantic_inference`` and ``instance_inference``; reference
maskformer_train_ins_vit.py:325-369). The evaluation metrics (dice,
ConfMatrix) are not ported yet."""
from __future__ import annotations

from typing import Dict

import torch


def semantic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor) -> torch.Tensor:
    """softmax(cls)[..., 1:] x sigmoid(mask) -> [B, num_classes, H, W].

    Softmax channel 0 is dropped, as both reference trainers do: semantic
    labels are 1-based with 0 = ignore, so logits channel 0 is a dead class,
    kept channel j stands for label j + 1, and the void channel (the last)
    survives in the kept set."""
    cls = torch.softmax(mask_cls, dim=-1)[..., 1:]
    return torch.einsum("bqc,bqhw->bchw", cls, torch.sigmoid(mask_pred))


def instance_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor, num_classes: int,
                       topk: int = 100) -> Dict[str, torch.Tensor]:
    """Top-k over the Q*K class scores (void dropped), each rescored by its
    mask's mean probability inside the mask. mask_cls [Q, K+1], mask_pred
    [Q, H, W] logits at full resolution."""
    q = mask_cls.shape[0]
    scores = torch.softmax(mask_cls, dim=-1)[:, :-1]  # [Q, K]
    labels = torch.arange(num_classes, device=mask_cls.device).repeat(q)  # [Q*K]
    flat = scores.reshape(-1)
    scores_k, idx = torch.topk(flat, min(topk, flat.shape[0]))
    masks = mask_pred[idx // num_classes]  # [topk, H, W]
    bin_masks = (masks > 0).to(masks.dtype)
    rescore = (torch.sigmoid(masks) * bin_masks).sum(dim=(1, 2)) / (bin_masks.sum(dim=(1, 2)) + 1e-6)
    return {"scores": scores_k * rescore, "pred_classes": labels[idx], "pred_masks": bin_masks,
            "mask_logits": masks}
