"""COCO-style mask / box evaluation, numpy on the host (JAX package
eval/coco_eval.py:1-292, the same protocol and the same numbers; reference
downstream/*/utils/cocoeval.py:1-535 and cocoeval_improve.py SelfEval, both
pycocotools-dependent):

  * segm AND bbox IoU types (boxes derived from masks when not supplied);
  * 10 IoU thresholds 0.5:0.05:0.95, 101-point interpolated PR curves;
  * per-area breakdown (all / small / medium / large, the cocoeval.py
    areaRng table) with the ignore semantics: out-of-range GT is ignored,
    detections matched to ignored GT are dropped from the PR, and unmatched
    out-of-range detections don't count as false positives;
  * AR at maxDets 1/10/100 (greedy matching in score order means the
    first-k prefix of the match array IS the k-detection matching).

Masks are dense binary arrays, not RLE. ``add_image`` and
``predictions_to_coco_json`` also take torch tensors on any device (the
port's instance outputs), each brought to the host once.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .metrics import to_numpy

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def mask_iou(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """pred [P, H, W], gt [G, H, W] binary -> IoU [P, G]."""
    p = pred.reshape(pred.shape[0], -1).astype(np.float32)
    g = gt.reshape(gt.shape[0], -1).astype(np.float32)
    inter = p @ g.T
    union = p.sum(1)[:, None] + g.sum(1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def boxes_from_masks(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] binary -> [N, 4] xyxy tight boxes (empty mask -> zeros)."""
    out = np.zeros((masks.shape[0], 4), np.float32)
    for i, m in enumerate(np.asarray(masks, bool)):
        ys, xs = np.nonzero(m)
        if ys.size:
            out[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return out


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a [P, 4], b [G, 4] xyxy -> IoU [P, G]."""
    ax0, ay0, ax1, ay1 = [a[:, i][:, None] for i in range(4)]
    bx0, by0, bx1, by1 = [b[:, i][None, :] for i in range(4)]
    iw = np.clip(np.minimum(ax1, bx1) - np.maximum(ax0, bx0), 0, None)
    ih = np.clip(np.minimum(ay1, by1) - np.maximum(ay0, by0), 0, None)
    inter = iw * ih
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


class CocoMaskEvaluator:
    """Streaming evaluator: add per-image predictions + GT, then summarize.

    ``iou_type``: 'segm' (mask IoU) or 'bbox' (mask-derived or supplied
    boxes), matching cocoeval.py's two evaluation modes.
    """

    def __init__(self, num_classes: int, max_dets: int = 100,
                 iou_type: str = "segm"):
        assert iou_type in ("segm", "bbox")
        self.num_classes = num_classes
        self.max_dets = max_dets
        self.iou_type = iou_type
        # per class: per-image raw match inputs, matched lazily in summarize
        self._imgs: Dict[int, List[Dict[str, np.ndarray]]] = {
            c: [] for c in range(num_classes)
        }

    def add_image(
        self,
        pred_masks,  # [P, H, W] binary (arrays or tensors throughout)
        pred_classes: np.ndarray,  # [P]
        pred_scores: np.ndarray,  # [P]
        gt_masks: np.ndarray,  # [G, H, W] binary
        gt_classes: np.ndarray,  # [G]
        pred_boxes: Optional[np.ndarray] = None,  # [P, 4] xyxy
        gt_boxes: Optional[np.ndarray] = None,  # [G, 4]
    ) -> None:
        pred_scores = to_numpy(pred_scores)
        order = np.argsort(-pred_scores)[: self.max_dets]
        pred_masks = to_numpy(pred_masks)[order]
        pred_classes = to_numpy(pred_classes)[order]
        pred_scores = pred_scores[order]
        gt_masks = to_numpy(gt_masks)
        gt_classes = to_numpy(gt_classes)
        pred_boxes = None if pred_boxes is None else to_numpy(pred_boxes)
        gt_boxes = None if gt_boxes is None else to_numpy(gt_boxes)
        # areas are mask areas in both modes (COCO convention: 'area' is the
        # segment area, used for the size breakdown in bbox eval too)
        # sum over all but the instance axis; tuple form keeps zero-instance
        # images legal (reshape(0, -1) cannot infer the trailing dim)
        pred_areas = np.asarray(pred_masks, bool).sum(
            axis=tuple(range(1, max(pred_masks.ndim, 2))))
        gt_areas = np.asarray(gt_masks, bool).sum(
            axis=tuple(range(1, max(gt_masks.ndim, 2))))

        if self.iou_type == "bbox":
            pb = pred_boxes[order] if pred_boxes is not None else boxes_from_masks(pred_masks)
            gb = gt_boxes if gt_boxes is not None else boxes_from_masks(gt_masks)

        for c in range(self.num_classes):
            p_idx = np.nonzero(pred_classes == c)[0]
            g_idx = np.nonzero(gt_classes == c)[0]
            if len(p_idx) == 0 and len(g_idx) == 0:
                continue
            if self.iou_type == "bbox":
                ious = box_iou(pb[p_idx], gb[g_idx]) if len(p_idx) and len(g_idx) \
                    else np.zeros((len(p_idx), len(g_idx)), np.float32)
            else:
                ious = mask_iou(pred_masks[p_idx], gt_masks[g_idx]) \
                    if len(p_idx) and len(g_idx) \
                    else np.zeros((len(p_idx), len(g_idx)), np.float32)
            self._imgs[c].append({
                "scores": pred_scores[p_idx],
                "ious": ious,
                "p_area": pred_areas[p_idx].astype(np.float64),
                "g_area": gt_areas[g_idx].astype(np.float64),
            })

    @staticmethod
    def _match_image(rec, thr: float, a0: float, a1: float):
        """cocoeval.evaluateImg semantics for one (image, class, thr, area):
        returns (scores, tp flags, ignore flags, n_gt_in_range)."""
        scores, ious = rec["scores"], rec["ious"]
        g_ig = (rec["g_area"] < a0) | (rec["g_area"] > a1)  # [G]
        p, g = len(scores), len(g_ig)
        tp = np.zeros(p, bool)
        ignore = np.zeros(p, bool)
        taken = np.zeros(g, bool)
        for pi in range(p):  # descending score order (sorted in add_image)
            # prefer non-ignored GT; fall back to ignored GT only when no
            # real match clears the threshold (cocoeval.py behavior)
            best, best_g = thr, -1
            for gi in range(g):
                if taken[gi] or g_ig[gi] or ious[pi, gi] < best:
                    continue
                best, best_g = ious[pi, gi], gi
            if best_g >= 0:
                taken[best_g] = True
                tp[pi] = True
                continue
            best = thr
            for gi in range(g):
                if taken[gi] or not g_ig[gi] or ious[pi, gi] < best:
                    continue
                best, best_g = ious[pi, gi], gi
            if best_g >= 0:
                taken[best_g] = True
                ignore[pi] = True
        # unmatched detections outside the area range are ignored, not FPs
        out_of_rng = (rec["p_area"] < a0) | (rec["p_area"] > a1)
        ignore |= (~tp) & ~ignore & out_of_rng
        return scores, tp, ignore, int((~g_ig).sum())

    def _compute_matches(self, area: str):
        """One greedy-matching pass per (class, image, thr) for this area
        range. Matching is independent of the detection limit (detections
        are score-sorted, so a maxDets cut is a prefix slice) — callers
        reuse one pass for every AR@k instead of rematching."""
        a0, a1 = AREA_RNG[area]
        t = len(IOU_THRS)
        out = []
        for c in range(self.num_classes):
            recs = []
            for r in self._imgs[c]:
                recs.append([self._match_image(r, thr, a0, a1)
                             for thr in IOU_THRS])
            out.append(recs)
        return out

    def _pr_stats(self, matches, max_det: int):
        """Per (class, thr): 101-pt AP and best recall at this det limit."""
        t = len(IOU_THRS)
        ap = np.full((self.num_classes, t), np.nan)
        rec = np.full((self.num_classes, t), np.nan)
        for c in range(self.num_classes):
            per_thr_scores = [[] for _ in range(t)]
            per_thr_tp = [[] for _ in range(t)]
            n_gt = 0
            for per_thr in matches[c]:
                for ti, (s, tp, ig, ng) in enumerate(per_thr):
                    s, tp, ig = s[:max_det], tp[:max_det], ig[:max_det]
                    per_thr_scores[ti].append(s[~ig])
                    per_thr_tp[ti].append(tp[~ig])
                    if ti == 0:
                        n_gt += ng
            if n_gt == 0:
                continue
            for ti in range(t):
                if not per_thr_scores[ti]:
                    ap[c, ti] = 0.0
                    rec[c, ti] = 0.0
                    continue
                scores = np.concatenate(per_thr_scores[ti])
                tp = np.concatenate(per_thr_tp[ti])
                order = np.argsort(-scores)
                tp = tp[order]
                ctp = np.cumsum(tp)
                cfp = np.cumsum(~tp)
                recall = ctp / n_gt
                precision = ctp / np.maximum(ctp + cfp, 1)
                for i in range(len(precision) - 1, 0, -1):
                    precision[i - 1] = max(precision[i - 1], precision[i])
                idx = np.searchsorted(recall, RECALL_THRS, side="left")
                pr = np.where(
                    idx < len(precision),
                    precision[np.minimum(idx, max(len(precision) - 1, 0))]
                    if len(precision) else 0.0,
                    0.0,
                )
                ap[c, ti] = pr.mean()
                rec[c, ti] = recall[-1] if len(recall) else 0.0
        return ap, rec

    def summarize(self) -> Dict[str, float]:
        """cocoeval.py summarize() table: AP / AP50 / AP75 / AP_s/m/l and
        AR at 1/10/max_dets detections (+ per-class AP at area=all). One
        matching pass per area range — 4 total, with every AR@k sliced from
        the area='all' pass."""
        m_all = self._compute_matches("all")
        ap_all, _ = self._pr_stats(m_all, self.max_dets)
        valid = ~np.isnan(ap_all[:, 0])
        if not valid.any():
            return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}
        out = {
            "AP": float(np.nanmean(ap_all)),
            "AP50": float(np.nanmean(ap_all[:, 0])),
            "AP75": float(np.nanmean(ap_all[:, 5])),
            "per_class_AP": [
                float(np.nanmean(ap_all[c])) if valid[c] else -1.0
                for c in range(self.num_classes)
            ],
        }
        for area in ("small", "medium", "large"):
            ap_a, _ = self._pr_stats(self._compute_matches(area), self.max_dets)
            out[f"AP_{area}"] = (
                float(np.nanmean(ap_a)) if not np.isnan(ap_a).all() else -1.0
            )
        # add_image stores at most self.max_dets detections, so only honest
        # det limits are reported (no 'AR@100' computed over 50 detections)
        for md in sorted({min(md, self.max_dets) for md in MAX_DETS}):
            _, rec = self._pr_stats(m_all, md)
            out[f"AR@{md}"] = (
                float(np.nanmean(rec)) if not np.isnan(rec).all() else -1.0
            )
        return out


def predictions_to_coco_json(
    image_ids: Sequence[int],
    results: Sequence[Dict],
    category_offset: int = 1,
) -> List[Dict]:
    """COCO-format prediction dump (reference mask2former_infer2json.py
    build_coco_results :86-220) with uncompressed RLE masks + bboxes."""
    out = []
    for img_id, res in zip(image_ids, results):
        masks = to_numpy(res["pred_masks"])
        classes = to_numpy(res["pred_classes"])
        scores = to_numpy(res["scores"])
        boxes = boxes_from_masks(masks)
        for m, c, s, bx in zip(masks, classes, scores, boxes):
            col = np.asarray(m, bool).T.flatten()  # column-major RLE
            # uncompressed counts
            counts = []
            prev, run = False, 0
            for v in col:
                if v == prev:
                    run += 1
                else:
                    counts.append(run)
                    prev, run = v, 1
            counts.append(run)
            x0, y0, x1, y1 = [float(v) for v in bx]
            out.append({
                "image_id": int(img_id),
                "category_id": int(c) + category_offset,
                "score": float(s),
                "segmentation": {"size": list(m.shape), "counts": counts},
                "bbox": [x0, y0, x1 - x0, y1 - y0],
            })
    return out
