"""COCO-json instance dataset for the rgb/sar/dsm layout (JAX package
data/coco_instance.py; reference downstream/instance_segmentation/dataset/
my_json_dataset_resize.py:91-241).

Differences by design:
  * no pycocotools dependency: the annotation json is parsed directly and
    polygons are rasterized with a vectorized even-odd scanline fill
    (replaces coco.annToMask);
  * targets come out as padded ``SegTargets`` batches (static shapes)
    instead of python dicts + collate(zip*).

``CocoBatches`` fills the batches of the JAX package's
``coco_batch_iterator`` into buffers the caller owns; the shuffle and the
augmentation draw from one generator, on the thread that fills.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np

from .dfc2023 import load_dsm, load_rgb, load_sar
from .targets import SegTargets


def rasterize_polygon(poly: np.ndarray, h: int, w: int) -> np.ndarray:
    """Even-odd fill of one polygon [[x, y], ...] onto an h x w grid,
    evaluated at pixel centers (matches COCO polygon semantics closely)."""
    xs = poly[:, 0]
    ys = poly[:, 1]
    n = len(poly)
    px = np.arange(w, dtype=np.float64) + 0.5
    py = np.arange(h, dtype=np.float64) + 0.5
    inside = np.zeros((h, w), bool)
    j = n - 1
    for i in range(n):
        x0, y0 = xs[j], ys[j]
        x1, y1 = xs[i], ys[i]
        j = i
        if y0 == y1:
            continue
        # rows whose center crosses edge (y1, y0)
        ymin, ymax = (y1, y0) if y1 < y0 else (y0, y1)
        rows = (py > ymin) & (py <= ymax)
        if not rows.any():
            continue
        x_at = x1 + (py[rows] - y1) * (x0 - x1) / (y0 - y1)
        inside[rows] ^= px[None, :] < x_at[:, None]
    return inside


def masks_from_segmentation(segm, h: int, w: int) -> np.ndarray:
    """COCO 'segmentation' (list of polygons) -> [h, w] binary mask
    (convert_coco_poly_mask role)."""
    mask = np.zeros((h, w), bool)
    if isinstance(segm, dict):  # RLE — decode uncompressed counts only
        counts = segm.get("counts")
        if isinstance(counts, list):
            flat = np.zeros(h * w, bool)
            pos, val = 0, False
            for c in counts:
                flat[pos : pos + c] = val
                pos += c
                val = not val
            mask = flat.reshape(w, h).T  # RLE is column-major
        return mask
    for poly in segm:
        p = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(p) >= 3:
            mask |= rasterize_polygon(p, h, w)
    return mask


class CocoInstanceDataset:
    """Images + instance targets from a COCO json over an rgb/ tree with
    derived sar/ and dsm/ siblings (my_json_dataset_resize.py:253-265).
    ``native`` picks the C++ normalizations (True) or the numpy ones. The
    targets are numpy ``SegTargets``."""

    def __init__(self, root: str, annotation_json: str, img_size: int = 256,
                 max_instances: int = 100, min_area: float = 1.0, native: bool = True):
        with open(annotation_json) as f:
            coco = json.load(f)
        self.img_size = img_size
        self.max_instances = max_instances
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns_by_img: Dict[int, List[dict]] = {}
        for ann in coco.get("annotations", []):
            if ann.get("iscrowd", 0) == 0 and ann.get("area", min_area) >= min_area:
                self.anns_by_img.setdefault(ann["image_id"], []).append(ann)
        self.cat_ids = sorted({c["id"] for c in coco.get("categories", [])})
        self.cat_to_contig = {c: i for i, c in enumerate(self.cat_ids)}
        self.root = root
        self.native = native
        # train-mode filter: drop images without annotations
        self.ids = [i for i in sorted(self.images) if self.anns_by_img.get(i)]

    def __len__(self):
        return len(self.ids)

    @property
    def num_classes(self) -> int:
        return len(self.cat_ids)

    def __getitem__(self, index: int):
        img_id = self.ids[index]
        info = self.images[img_id]
        rgb_loc = os.path.join(self.root, info["file_name"])
        sar_loc = rgb_loc.replace("rgb", "sar")
        dsm_loc = rgb_loc.replace("rgb", "dsm")
        s = self.img_size
        x = {
            "s2": load_rgb(rgb_loc, s, self.native).transpose(1, 2, 0),
            "s1": load_sar(sar_loc, s, self.native).transpose(1, 2, 0),
            "dem": load_dsm(dsm_loc, s, self.native).transpose(1, 2, 0),
        }
        h0, w0 = info.get("height", s), info.get("width", s)
        g = self.max_instances
        labels = np.full((g,), -1, np.int32)
        masks = np.zeros((g, s, s), np.float32)
        valid = np.zeros((g,), bool)
        for k, ann in enumerate(self.anns_by_img.get(img_id, [])[:g]):
            m = masks_from_segmentation(ann["segmentation"], h0, w0)
            if m.shape != (s, s):  # nearest resize to model resolution
                yi = (np.arange(s) * h0 / s).astype(np.int64)
                xi = (np.arange(s) * w0 / s).astype(np.int64)
                m = m[yi][:, xi]
            if not m.any():
                continue
            labels[k] = self.cat_to_contig.get(ann["category_id"], 0)
            masks[k] = m.astype(np.float32)
            valid[k] = True
        return x, SegTargets(labels, masks, valid)


def _augment_one(x, t, rng, aug_cfg):
    """Shared geometric transform across modalities + instance masks
    (aug_strategy.py pipeline via imgaug_mask, dataset.py:115,166);
    instances whose mask leaves the frame are invalidated."""
    from .augment import augment_sample

    imgs_chw = {k: v.transpose(2, 0, 1) for k, v in x.items()}
    imgs, masks, _ = augment_sample(imgs_chw, rng, aug_cfg, masks=t.masks)
    x = {k: v.transpose(1, 2, 0) for k, v in imgs.items()}
    valid = t.valid & (masks.reshape(masks.shape[0], -1).sum(axis=1) > 0)
    return x, SegTargets(t.labels, masks, valid)


TARGET_KEYS = ("labels", "masks", "valid")


class CocoBatches:
    """The batches of ``coco_batch_iterator`` (JAX package
    coco_instance.py:145-176) as one flat dict: the rasters ({domain: [B, s,
    s, C] float32}) and the targets' ``labels`` [B, G] int32, ``masks`` [B,
    G, s, s] float32 and ``valid`` [B, G] bool. Each epoch shuffles the
    index pool with ``np.random.default_rng(seed)``; the same generator then
    draws each augmented sample's transform, after its batch's reads."""

    def __init__(self, dataset: CocoInstanceDataset, batch_size: int, seed: int = 0, shuffle: bool = True,
                 augment=None):  # Optional[data.augment.AugmentConfig]
        if len(dataset) < batch_size:
            raise ValueError(f"{len(dataset)} annotated images, fewer than a batch of {batch_size}")
        self.dataset, self.batch_size, self.shuffle, self.augment = dataset, batch_size, shuffle, augment
        self.rng = np.random.default_rng(seed)
        self.order = np.arange(len(dataset))
        self.pos = len(dataset)  # an epoch starts on the first batch
        x, t = dataset[0]
        self.specs = {k: ((batch_size,) + v.shape, v.dtype) for k, v in x.items()}
        self.specs.update({k: ((batch_size,) + getattr(t, k).shape, getattr(t, k).dtype) for k in TARGET_KEYS})

    def fill(self, out: Dict[str, np.ndarray]) -> None:
        if self.pos + self.batch_size > len(self.dataset):
            if self.shuffle:
                self.rng.shuffle(self.order)
            self.pos = 0
        idx = self.order[self.pos:self.pos + self.batch_size]
        self.pos += self.batch_size
        pairs = [self.dataset[int(i)] for i in idx]
        if self.augment is not None:
            pairs = [_augment_one(x, t, self.rng, self.augment) for x, t in pairs]
        xs, ts = zip(*pairs)
        for k in xs[0]:
            np.stack([x[k] for x in xs], out=out[k])
        for k in TARGET_KEYS:
            np.stack([getattr(t, k) for t in ts], out=out[k])

    def close(self) -> None:
        pass


def split_targets(batch: Dict) -> Tuple[Dict, SegTargets]:
    """A ``CocoBatches`` batch (numpy or tensors) as (rasters, SegTargets)."""
    return ({k: v for k, v in batch.items() if k not in TARGET_KEYS},
            SegTargets(*(batch[k] for k in TARGET_KEYS)))


def coco_batch_iterator(
    dataset: CocoInstanceDataset,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    prefetch: int = 2,
    augment=None,  # Optional[data.augment.AugmentConfig]
) -> Iterator[Tuple[Dict[str, np.ndarray], SegTargets]]:
    """Infinite (rasters, numpy SegTargets) batches, the JAX package's batch
    for batch: ``CocoBatches`` filled on a producer thread."""
    from .loader import host_batches

    return (split_targets(b) for b in host_batches(CocoBatches(dataset, batch_size, seed, shuffle, augment),
                                                   prefetch))
