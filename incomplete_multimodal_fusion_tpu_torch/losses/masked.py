"""Masked reconstruction losses (JAX package losses/masked.py; reference
pretraining/multimae/criterion.py).

Semantics as the JAX package keeps them, quirks included:
  * the patch-level mask is upsampled nearest to the pixel grid
    (criterion.py:104-106);
  * per-sample masked mean, then the mean over the samples whose mask is not
    empty (the reference's ``nanmean``, criterion.py:110-111), counted
    explicitly so no 0/0 enters the graph;
  * an all-zero mask returns 0 (criterion.py:100-102);
  * ``norm_pix`` uses the unbiased (N-1) variance (criterion.py:92).

Images are NHWC. The ``*_patch`` variants take the decoder's patch layout
[B, N, p*p*C] (pixel order (ph, pw, c)) and give the same values up to float
reassociation. Losses compute in f32 whatever the prediction dtype.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..ops.patches import patchify


def _upsample_mask_nearest(mask: torch.Tensor, h: int, w: int, p: int) -> torch.Tensor:
    """[B, nh*nw] patch mask -> [B, H, W] pixel mask (nearest)."""
    m = mask.reshape(mask.shape[0], h // p, w // p).float()
    return m.repeat_interleave(p, dim=1).repeat_interleave(p, dim=2)


def _masked_mean(num: torch.Tensor, den: torch.Tensor, mask: torch.Tensor, batch_sum=None) -> torch.Tensor:
    """Per-sample num / den, averaged over the samples with den > 0; 0 for
    an all-zero mask. ``batch_sum`` (data parallelism, parallel/comm.py)
    sums the numerator and both counts over the ranks' rows, so the mean is
    the global batch's: the mean of the ranks' means is not."""
    valid = den > 0
    per_sample = num / den.clamp(min=1.0)
    total = torch.where(valid, per_sample, torch.zeros_like(per_sample)).sum()
    if batch_sum is None:
        total = total / valid.sum().clamp(min=1)
        return torch.where(mask.sum() == 0, torch.zeros_like(total), total)
    total, count, masked = batch_sum(torch.stack([total, valid.sum().to(total.dtype), mask.sum().to(total.dtype)]))
    total = total / count.clamp(min=1)
    return torch.where(masked == 0, torch.zeros_like(total), total)


def _mean(loss: torch.Tensor, batch_sum=None) -> torch.Tensor:
    """The mean over every element, the global batch's with ``batch_sum``."""
    if batch_sum is None:
        return loss.mean()
    total, count = batch_sum(torch.stack([loss.sum(), loss.new_full((), float(loss.numel()))]))
    return total / count


def _masked_reduce(loss_phw: torch.Tensor, mask: torch.Tensor, p: int, batch_sum=None) -> torch.Tensor:
    """loss_phw [B, H, W] per-pixel loss; mask [B, nh*nw] (1 = masked patch,
    where the loss is taken, MAE-style)."""
    b, h, w = loss_phw.shape
    pix = _upsample_mask_nearest(mask, h, w, p)
    return _masked_mean((loss_phw * pix).reshape(b, -1).sum(dim=1), pix.reshape(b, -1).sum(dim=1), mask,
                        batch_sum)


def _masked_reduce_patch(per_patch: torch.Tensor, mask: torch.Tensor, batch_sum=None) -> torch.Tensor:
    """per_patch [B, N] per-patch mean loss; mask [B, N] (1 = masked)."""
    m = mask.float()
    return _masked_mean((per_patch * m).sum(dim=1), m.sum(dim=1), mask, batch_sum)


def _norm_pix_patch(t: torch.Tensor) -> torch.Tensor:
    """Per-patch normalization on [B, N, p*p*C] (criterion.py:90-96)."""
    mean = t.mean(dim=-1, keepdim=True)
    var = t.var(dim=-1, unbiased=True, keepdim=True)
    return (t - mean) / torch.sqrt(var + 1e-6)


def _norm_pix(target: torch.Tensor, p: int) -> torch.Tensor:
    """Per-patch normalization of an NHWC target, back in NHWC."""
    b, h, w, c = target.shape
    nh, nw = h // p, w // p
    t = _norm_pix_patch(patchify(target, p))
    return t.reshape(b, nh, nw, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _targets(pred, target, p, norm_pix, patch: bool):
    pred = pred.float()
    target = target.float()
    if patch:
        if target.dim() == 4:
            target = patchify(target, p)
        return pred, _norm_pix_patch(target) if norm_pix else target
    return pred, _norm_pix(target, p) if norm_pix else target


def masked_mse_loss(pred, target, mask: Optional[torch.Tensor] = None, *, patch_size: int = 16,
                    stride: int = 1, norm_pix: bool = False, batch_sum=None):
    """MaskedMSELoss (criterion.py:61-115). pred/target [B, H, W, C]."""
    p = patch_size // stride
    pred, target = _targets(pred, target, p, norm_pix, patch=False)
    loss = (pred - target) ** 2
    if mask is None:
        return _mean(loss, batch_sum)
    return _masked_reduce(loss.mean(dim=-1), mask, p, batch_sum)


def masked_l1_loss(pred, target, mask: Optional[torch.Tensor] = None, *, patch_size: int = 16,
                   stride: int = 1, norm_pix: bool = False, batch_sum=None):
    """MaskedL1Loss (criterion.py:118-172). pred/target [B, H, W, C]."""
    p = patch_size // stride
    pred, target = _targets(pred, target, p, norm_pix, patch=False)
    loss = (pred - target).abs()
    if mask is None:
        return _mean(loss, batch_sum)
    return _masked_reduce(loss.mean(dim=-1), mask, p, batch_sum)


def _cross_entropy(logits: torch.Tensor, target: torch.Tensor, label_smoothing: float):
    """-sum(onehot * log_softmax) over the last axis, in f32."""
    k = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = torch.nn.functional.one_hot(target.long(), k).float()
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / k
    return -(onehot * logp).sum(dim=-1)


def masked_cross_entropy_loss(logits, target, mask: Optional[torch.Tensor] = None, *,
                              patch_size: int = 16, stride: int = 1,
                              label_smoothing: float = 0.0, batch_sum=None):
    """MaskedCrossEntropyLoss (criterion.py:24-58). logits [B, H, W, K],
    target [B, H, W] int."""
    p = patch_size // stride
    loss = _cross_entropy(logits, target, label_smoothing)  # [B, H, W]
    if mask is None:
        return _mean(loss, batch_sum)
    return _masked_reduce(loss, mask, p, batch_sum)


LOSS_FNS: Dict[str, Callable] = {
    "mse": masked_mse_loss,
    "l1": masked_l1_loss,
    "cross_entropy": masked_cross_entropy_loss,
}


def masked_mse_loss_patch(pred_patch, target, mask: Optional[torch.Tensor] = None, *,
                          patch_size: int = 16, stride: int = 1, norm_pix: bool = False, batch_sum=None):
    """MaskedMSELoss on patch-layout preds. pred_patch [B, N, p*p*C],
    target [B, H, W, C] pixels (or already [B, N, p*p*C])."""
    pred, t = _targets(pred_patch, target, patch_size // stride, norm_pix, patch=True)
    loss = (pred - t) ** 2
    if mask is None:
        return _mean(loss, batch_sum)
    return _masked_reduce_patch(loss.mean(dim=-1), mask, batch_sum)


def masked_l1_loss_patch(pred_patch, target, mask: Optional[torch.Tensor] = None, *,
                         patch_size: int = 16, stride: int = 1, norm_pix: bool = False, batch_sum=None):
    """MaskedL1Loss on patch-layout preds."""
    pred, t = _targets(pred_patch, target, patch_size // stride, norm_pix, patch=True)
    loss = (pred - t).abs()
    if mask is None:
        return _mean(loss, batch_sum)
    return _masked_reduce_patch(loss.mean(dim=-1), mask, batch_sum)


def masked_cross_entropy_loss_patch(pred_patch, target, mask: Optional[torch.Tensor] = None, *,
                                    patch_size: int = 16, stride: int = 1,
                                    label_smoothing: float = 0.0, batch_sum=None):
    """MaskedCrossEntropyLoss on patch-layout logits. pred_patch
    [B, N, p*p*K] (pixel order (ph, pw, k)), target [B, H, W] int."""
    p = patch_size // stride
    b, n, pk = pred_patch.shape
    k = pk // (p * p)
    nh = int(round(n ** 0.5))
    t = target.reshape(b, nh, p, nh, p).permute(0, 1, 3, 2, 4).reshape(b, n, p * p)
    loss = _cross_entropy(pred_patch.reshape(b, n, p * p, k), t, label_smoothing)  # [B, N, p*p]
    if mask is None:
        return _mean(loss, batch_sum)
    return _masked_reduce_patch(loss.mean(dim=-1), mask, batch_sum)


PATCH_LOSS_FNS: Dict[str, Callable] = {
    "mse": masked_mse_loss_patch,
    "l1": masked_l1_loss_patch,
    "cross_entropy": masked_cross_entropy_loss_patch,
}
