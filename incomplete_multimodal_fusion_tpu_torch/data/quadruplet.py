"""Quadruplet (s1, s2, dem, dnw [, lc]) dataset (JAX package
data/quadruplet.py; reference pretraining/utils/multimodal_quadruplet.py:211-290 and the
downstream semantic copy with segm_downsampling_rate,
downstream/semantic_segmentation/dataset/multimodal_quadruplet.py).

Layout: folder-of-places (f1..fN), each containing s2_* tile folders with
sibling s1_*/dem_*/dnw_*/lc_* derived by name replacement. Normalization
matches the reference exactly:
  * S2 HR bands [2,3,4,8], clip [0, 10000], per-band z-score (:58-65)
  * S1 2ch, clip [-25, 25], per-band z-score (:67-73)
  * DEM clip [-100, 5000], min-max (:121-131, 50-56)
  * DNW band 10 as int labels (:161-168)
  * LC RGB -> index via the 28-color table (:19-48)

``QuadrupletBatches`` is the batch loop of the JAX package's downstream
script over this dataset (scripts/train_downstream.py:163-205): the same
shuffle, augmentation and channel cuts, into buffers the caller owns.
"""
from __future__ import annotations

import copy
import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .dfc2023 import _read_raster

# Sentinel-2 band groups (SEN12MS-style loader, multimodal_dataset.py:76-96)
S2_BANDS_HR = [2, 3, 4, 8]
S2_BANDS_MR = [5, 6, 7, 9, 12, 13]
S2_BANDS_LR = [1, 10, 11]
S2_MEAN = np.array([1353.3418, 1265.4015, 1269.009, 1976.1317], np.float32)
S2_STD = np.array([242.07303, 290.84450, 402.9476, 516.77480], np.float32)
S1_MEAN = np.array([-9.020017, -15.73008], np.float32)
S1_STD = np.array([3.5793820, 3.671725], np.float32)

NUM_LC_CLASSES = 28
LC_COLORMAP = [
    [0, 0, 0], [128, 0, 0], [191, 0, 0], [255, 64, 64], [255, 128, 128],
    [255, 191, 191], [204, 102, 102], [204, 77, 242], [149, 149, 149],
    [179, 179, 179], [89, 89, 89], [230, 204, 204], [230, 204, 230],
    [115, 77, 55], [185, 165, 110], [135, 69, 69], [140, 220, 0],
    [175, 210, 165], [255, 255, 168], [242, 166, 77], [230, 230, 77],
    [255, 230, 77], [242, 204, 128], [0, 140, 0], [204, 242, 77],
    [204, 255, 204], [166, 166, 255], [128, 242, 230],
]
_COLOR2LABEL = np.zeros(256 ** 3, np.uint8)
for _i, _cm in enumerate(LC_COLORMAP):
    _COLOR2LABEL[(_cm[0] * 256 + _cm[1]) * 256 + _cm[2]] = _i


def color_to_index(rgb: np.ndarray) -> np.ndarray:
    """[3, H, W] RGB -> [H, W] class index (Color2Index, :42-48)."""
    d = rgb.astype(np.int32)
    idx = (d[0] * 256 + d[1]) * 256 + d[2]
    out = _COLOR2LABEL[idx]
    return (out * (out <= NUM_LC_CLASSES)).astype(np.uint8)


def index_to_color(pred: np.ndarray) -> np.ndarray:
    return np.asarray(LC_COLORMAP, np.uint8)[np.asarray(pred, np.int32)]


def _minmax(x: np.ndarray) -> np.ndarray:
    rng = x.max() - x.min() + 1e-6
    return (x - x.min()) / rng


def select_s2_bands(use_hr: bool = True, use_mr: bool = False, use_lr: bool = False):
    """Sorted band list like the SEN12MS loader (multimodal_dataset.py:82-96)."""
    bands = []
    if use_hr:
        bands += S2_BANDS_HR
    if use_mr:
        bands += S2_BANDS_MR
    if use_lr:
        bands += S2_BANDS_LR
    return sorted(bands)


def load_s2(path: str, bands: Optional[Sequence[int]] = None) -> np.ndarray:
    bands = list(bands) if bands is not None else S2_BANDS_HR
    s2 = _read_raster(path)
    if s2.shape[0] >= max(bands):
        s2 = s2[[b - 1 for b in bands]]
    s2 = np.clip(np.nan_to_num(s2), 0, 10000).astype(np.float32)
    if len(bands) == len(S2_BANDS_HR) and bands == S2_BANDS_HR:
        return (s2 - S2_MEAN[:, None, None]) / S2_STD[:, None, None]
    # per-band standardize when stats are not published for the subset
    mu = s2.mean(axis=(1, 2), keepdims=True)
    sd = s2.std(axis=(1, 2), keepdims=True) + 1e-6
    return (s2 - mu) / sd


def load_s1(path: str) -> np.ndarray:
    s1 = _read_raster(path)[:2]
    s1 = np.clip(np.nan_to_num(s1), -25, 25).astype(np.float32)
    return (s1 - S1_MEAN[:, None, None]) / S1_STD[:, None, None]


def load_dem(path: str) -> np.ndarray:
    dem = _read_raster(path)[:1]
    dem = np.clip(np.nan_to_num(dem), -100, 5000).astype(np.float32)
    return _minmax(dem)


def load_dnw(path: str) -> np.ndarray:
    r = _read_raster(path)
    band = r[9] if r.shape[0] >= 10 else r[0]
    return band.astype(np.int32)


def load_lc(path: str) -> np.ndarray:
    return color_to_index(_read_raster(path)[:3])


class QuadrupletDataset:
    """Folder-of-places tree (MyDataset, multimodal_quadruplet.py:211-283).
    Train places f1..f17 / eval f2 in the downstream semantic variant
    (dataset/multimodal_quadruplet.py:352, :435)."""

    def __init__(self, path: str, places: Optional[Sequence[str]] = None,
                 unlabeled: bool = True, crop_size: Optional[int] = None,
                 segm_downsampling_rate: int = 1, seed: int = 0):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        places = places or ["f1", "f2", "f3", "f4", "f5", "f6"]
        self.unlabeled = unlabeled
        self.crop_size = crop_size
        self.segm_rate = segm_downsampling_rate
        self.rng = np.random.default_rng(seed)
        folders = []
        for place in places:
            pdir = os.path.join(path, place)
            if not os.path.isdir(pdir):
                continue
            folders += [
                os.path.join(place, x) for x in os.listdir(pdir) if "s2_" in x
            ]
        self.samples: List[Dict[str, str]] = []
        for folder in folders:
            for s2_loc in sorted(
                glob.glob(os.path.join(path, folder, "*.tif"))
                + glob.glob(os.path.join(path, folder, "*.npy"))
            ):
                rec = {
                    "s2": s2_loc,
                    "s1": s2_loc.replace("_s2_", "_s1_").replace("s2_", "s1_"),
                    "dem": s2_loc.replace("_s2_", "_dem_").replace("s2_", "dem_"),
                    "dnw": s2_loc.replace("_s2_", "_dnw_").replace("s2_", "dnw_"),
                }
                if not unlabeled:
                    rec["lc"] = s2_loc.replace("_s2_", "_lc_").replace("s2_", "lc_")
                paths = [rec[k] for k in ("s1", "dem", "dnw")] + (
                    [rec["lc"]] if not unlabeled else []
                )
                def exists(p):
                    return os.path.exists(p) or os.path.exists(os.path.splitext(p)[0] + ".npy")
                if all(exists(p) for p in paths):
                    self.samples.append(rec)
        if not self.samples:
            raise FileNotFoundError(f"no quadruplet tiles under {path}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rec = self.samples[i]
        out = {
            "s1": load_s1(rec["s1"]),
            "s2": load_s2(rec["s2"]),
            "dem": load_dem(rec["dem"]),
            "dnw": load_dnw(rec["dnw"]),
        }
        if not self.unlabeled:
            out["label"] = load_lc(rec["lc"])
        if self.crop_size:
            out = self._random_crop(out)
        return out

    def _random_crop(self, s: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """RandomCrop with label downsampling (downstream
        dataset/multimodal_quadruplet.py:218)."""
        h, w = s["s2"].shape[-2:]
        c = self.crop_size
        top = int(self.rng.integers(0, max(h - c, 1)))
        left = int(self.rng.integers(0, max(w - c, 1)))
        out = {}
        for k, v in s.items():
            crop = v[..., top : top + c, left : left + c]
            if k == "label" and self.segm_rate > 1:
                crop = crop[..., :: self.segm_rate, :: self.segm_rate]
            out[k] = crop
        return out


class QuadrupletBatches:
    """The semantic batches of scripts/train_downstream.py:163-205 over a
    labeled ``QuadrupletDataset``: s1 [B, s, s, 1] (its first band), s2 [B,
    s, s, 3] (its first three), dem [B, s, s, 1] and ``label`` [B, s, s]
    (uint8 class indices). Each epoch shuffles the index pool with
    ``np.random.default_rng(seed)``; with ``augment`` (an ``AugmentConfig``)
    the same generator draws each sample's transform, the label padded with
    the ignore index 255."""

    def __init__(self, dataset: QuadrupletDataset, batch_size: int, seed: int = 0, augment=None):
        if len(dataset) < batch_size:
            raise ValueError(f"{len(dataset)} quadruplet tiles, fewer than a batch of {batch_size}")
        self.dataset, self.batch_size, self.augment = dataset, batch_size, augment
        self.rng = np.random.default_rng(seed)
        self.order = np.arange(len(dataset))
        self.pos = len(dataset)  # an epoch starts on the first batch
        # shapes and dtypes from sample 0 of a copy: the dataset's own crop
        # generator draws nothing for it
        s0 = copy.deepcopy(dataset)[0]
        self.specs = {"s1": s0["s1"][:1], "s2": s0["s2"][:3], "dem": s0["dem"]}
        self.specs = {k: ((batch_size,) + v.shape[1:] + v.shape[:1], v.dtype) for k, v in self.specs.items()}
        self.specs["label"] = ((batch_size,) + s0["label"].shape, s0["label"].dtype)

    def fill(self, out: Dict[str, np.ndarray]) -> None:
        if self.pos + self.batch_size > len(self.dataset):
            self.rng.shuffle(self.order)
            self.pos = 0
        idx = self.order[self.pos:self.pos + self.batch_size]
        self.pos += self.batch_size
        samples = [self.dataset[int(i)] for i in idx]
        if self.augment is not None:
            from .augment import augment_sample

            auged = []
            for s in samples:
                imgs = {k: s[k] for k in ("s1", "s2", "dem")}
                imgs, _, lab = augment_sample(imgs, self.rng, self.augment, label=s["label"], label_cval=255)
                auged.append({**imgs, "label": lab})
            samples = auged
        np.stack([s["s1"].transpose(1, 2, 0)[..., :1] for s in samples], out=out["s1"])
        np.stack([s["s2"].transpose(1, 2, 0)[..., :3] for s in samples], out=out["s2"])
        np.stack([s["dem"].transpose(1, 2, 0) for s in samples], out=out["dem"])
        np.stack([s["label"] for s in samples], out=out["label"])

    def close(self) -> None:
        pass
