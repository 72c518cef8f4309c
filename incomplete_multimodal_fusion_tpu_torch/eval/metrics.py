"""Segmentation inference post-processing and evaluation metrics (JAX
package eval/metrics.py):

  * ``semantic_inference`` / ``instance_inference``
    (reference maskformer_train_ins_vit.py:325-369);
  * ``dice_score`` and ``binary_mask_from_labels`` (:308-323);
  * ``ConfMatrix`` AA / SA / IoU / mIoU (semantic utils/metrics.py:7-100),
    numpy, with the ignore-class-0 filter in ``add``;
  * ``psnr_metrics`` (:148), the reconstruction PSNR as a float.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
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


def dice_score(predict: torch.Tensor, target: torch.Tensor, smooth: float = 1e-5) -> torch.Tensor:
    """Per-class dice, meaned (maskformer_train_ins_vit.py:308-316): predict,
    target [K, ...]."""
    p = predict.reshape(predict.shape[0], -1)
    t = target.reshape(target.shape[0], -1)
    num = (p * t).sum(dim=1)
    den = p.sum(-1) + t.sum(-1)
    return ((2 * num + smooth).sum(-1) / (den + smooth).sum(-1)).mean()


def binary_mask_from_labels(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[H, W] int -> [num_classes, H, W] f32 one-hot of labels 1..K, class 0
    dropped (_get_binary_mask, maskformer_train_ins_vit.py:318-323); a label
    outside 0..K (255, ignore) is zero everywhere, as jax.nn.one_hot gives."""
    classes = torch.arange(1, num_classes + 1, device=target.device)
    return (target[None] == classes[:, None, None]).float()


class ConfMatrix:
    """Streaming confusion matrix (semantic utils/metrics.py:7-100); ``add``
    drops the pixels whose ground truth is class 0 (ignore), as the
    reference does."""

    def __init__(self, num_classes: int, ignore_zero: bool = True):
        self.num_classes = num_classes
        self.ignore_zero = ignore_zero
        self.state = np.zeros((num_classes, num_classes), np.float64)

    def _cm(self, gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
        k = self.num_classes
        keep = (gt >= 0) & (gt < k) & (pred >= 0) & (pred < k)
        idx = gt[keep].astype(np.int64) * k + pred[keep].astype(np.int64)
        return np.bincount(idx, minlength=k * k).reshape(k, k).astype(np.float64)

    def add(self, gt, pred) -> None:
        gt = to_numpy(gt).flatten()
        pred = to_numpy(pred).flatten()
        if self.ignore_zero:
            pred = pred[gt != 0]
            gt = gt[gt != 0]
        if gt.size:
            self.state += self._cm(gt, pred)

    def add_batch(self, gt, pred) -> None:
        for g, p in zip(to_numpy(gt), to_numpy(pred)):
            self.add(g, p)

    def get_existing_classes(self) -> int:
        return int((self.state.sum(axis=1) > 0).sum())

    def norm_on_lines(self) -> np.ndarray:
        a = self.state
        b = self.state.sum(axis=1)[:, None]
        return np.divide(a, b, out=np.zeros_like(a), where=b != 0)

    def get_aa(self) -> float:
        return float(np.diagonal(self.norm_on_lines()).sum() / max(self.get_existing_classes(), 1))

    def get_sa(self) -> np.ndarray:
        return np.diagonal(self.norm_on_lines())

    def get_iou(self) -> np.ndarray:
        cm = self.state
        res = np.zeros(self.num_classes)
        for i in range(self.num_classes):
            den = cm[i, :].sum() + cm[:, i].sum() - cm[i, i]
            res[i] = cm[i, i] / den if den > 0 else 0.0
        return res

    def get_miou(self) -> float:
        """Mean IoU over the classes with any support (ground truth or
        prediction), so the structurally empty ignore class 0 does not
        deflate it."""
        iou = self.get_iou()
        present = (self.state.sum(axis=1) + self.state.sum(axis=0)) > 0
        if not present.any():
            return 0.0
        return float(iou[present].mean())


def to_numpy(x) -> np.ndarray:
    """An array (or a tensor on any device, brought to the host once) as a
    numpy array; bf16 widens to f32, which numpy lacks."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def psnr_metrics(pred, target, data_range: Optional[float] = None) -> float:
    """PSNR of ``pred`` against ``target`` (arrays or tensors) as a float."""
    from ..infer import psnr

    return float(psnr(torch.as_tensor(to_numpy(pred)), torch.as_tensor(to_numpy(target)), data_range))
