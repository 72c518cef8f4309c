"""SEN12MS / DFC2020-style dataset with superpixel side channels (JAX
package data/sen12ms.py).

Covers the reference's ``pretraining/utils/multimodal_dataset.py``:
  * ``DFC2020`` folder layout — places named ``s1_*`` with per-tile tifs,
    sibling paths derived by string replace (``s2_`` / ``se_`` / ``dfc_``,
    multimodal_dataset.py:316-321), superpixel ``se_*.npy`` files.
  * S2 band selection by resolution class (HR [2,3,4,8] / MR / LR,
    multimodal_dataset.py:76-96; shared with data/quadruplet.py).
  * S1 2-channel norm: nan->0, clip [-25, 0], per-band z-score
    (S1_MEAN/STD, multimodal_dataset.py:12-23).
  * Superpixel-aware RandomCrop: the crop slices image, ``segments`` map and
    per-pixel ``index`` channels with the same window
    (multimodal_dataset.py:46-72).

Note: in the reference this path is dead code AND internally broken —
``load_sample`` never returns 'segments'/'index' keys, so
``RandomCrop(sample, superpixel=True)`` would KeyError, and the ``DFC2023``
class reads ``self.use_s1`` it never sets (multimodal_dataset.py:253-258).
This module implements the evident intent as a working loader.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .quadruplet import select_s2_bands

# multimodal_dataset.py:8-17
S1_MEAN = (-11.76858, -18.294598)
S1_STD = (4.525339, 4.3586307)
S2_MEAN_STD_CLIP = 10000.0


def _read_tif(path: str, bands: Optional[Sequence[int]] = None) -> np.ndarray:
    """Read [C, H, W]: a ``.npy`` side-car wins (tests / pre-chipped fast
    path), else the port's TIFF codec (``data/tiff.py``), its [H, W, C]
    turned channel-first where the last axis is the shortest."""
    npy = os.path.splitext(path)[0] + ".npy"
    if os.path.exists(npy):
        arr = np.load(npy)
    else:
        from .tiff import read_tiff

        arr = read_tiff(path)
        if arr.ndim == 3 and arr.shape[-1] < arr.shape[0]:
            arr = arr.transpose(2, 0, 1)
    if arr.ndim == 2:
        arr = arr[None]
    if bands is not None:
        arr = arr[[b - 1 for b in bands]]
    return arr


def normalize_s1(x: np.ndarray) -> np.ndarray:
    """2-channel SAR: nan->0, clip [-25, 0], per-band z-score
    (multimodal_dataset.py:100-107, 20-23)."""
    x = np.nan_to_num(x.astype(np.float32))
    x = np.clip(x, -25.0, 0.0)
    for i in range(min(2, x.shape[0])):
        x[i] = (x[i] - S1_MEAN[i]) / S1_STD[i]
    return x


def normalize_s2(x: np.ndarray) -> np.ndarray:
    """clip [0, 10000] then /10000 (multimodal_dataset.py load_s2)."""
    x = np.clip(x.astype(np.float32), 0.0, S2_MEAN_STD_CLIP)
    return x / S2_MEAN_STD_CLIP


def random_crop_superpixel(
    sample: Dict[str, np.ndarray],
    size: int,
    rng: np.random.Generator,
) -> Dict[str, np.ndarray]:
    """Crop image [C, H, W], 'segments' [H, W] and 'index' [K, H, W] with the
    same window (multimodal_dataset.py:46-72); 'label' [H, W] if present.
    Thin wrapper over the shared window-crop (data/augment.py), which crops
    every ndarray entry — superpixel planes included — with one window."""
    from .augment import random_crop_multimodal

    return random_crop_multimodal(sample, (size, size), rng)


class SEN12MSDataset:
    """DFC2020 folder-of-places layout (multimodal_dataset.py:269-336):
    ``{path}/s1_*/**.tif`` with s2/se/dfc siblings via name replace."""

    def __init__(
        self,
        path: str,
        use_s2hr: bool = True,
        use_s2mr: bool = False,
        use_s2lr: bool = False,
        use_s1: bool = True,
        unlabeled: bool = True,
        use_superpixel: bool = False,
        crop_size: Optional[int] = None,
        seed: int = 0,
    ):
        if not (use_s2hr or use_s2mr or use_s2lr or use_s1):
            raise ValueError("set at least one of use_[s2hr, s2mr, s2lr, s1]")
        self.bands = select_s2_bands(use_s2hr, use_s2mr, use_s2lr)
        self.use_s1 = use_s1
        self.use_s2 = bool(self.bands)
        self.unlabeled = unlabeled
        self.use_superpixel = use_superpixel
        self.crop_size = crop_size
        self.rng = np.random.default_rng(seed)

        folders = [x for x in os.listdir(path) if "s1_" in x]
        self.samples: List[Dict[str, str]] = []
        for folder in sorted(folders):
            tifs = set(glob.glob(os.path.join(path, folder, "*.tif")))
            tifs |= {p[:-4] + ".tif"
                     for p in glob.glob(os.path.join(path, folder, "*.npy"))}
            for s1_loc in sorted(tifs):
                s2_loc = s1_loc.replace("_s1_", "_s2_").replace("s1_", "s2_")
                se_loc = (s1_loc.replace("tif", "npy")
                          .replace("s1_", "se_").replace("_s1_", "_se_"))
                lc_loc = s1_loc.replace("_s1_", "_dfc_").replace("s1_", "dfc_")
                self.samples.append({"s1": s1_loc, "s2": s2_loc, "se": se_loc,
                                     "lc": lc_loc,
                                     "id": os.path.basename(s1_loc)})

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rec = self.samples[i]
        parts = []
        if self.use_s2:
            parts.append(normalize_s2(_read_tif(rec["s2"], self.bands)))
        if self.use_s1:
            parts.append(normalize_s1(_read_tif(rec["s1"])))
        img = np.concatenate(parts, axis=0)
        out: Dict[str, np.ndarray] = {"image": img, "id": rec["id"]}
        if self.use_superpixel:
            seg = np.load(rec["se"])
            out["segments"] = seg.astype(np.int32)
            # per-pixel superpixel one-position 'index' channel: mean feature
            # per segment scattered back (the role of the reference's index
            # channels in its weak-supervision recipe)
            out["index"] = segment_mean_channels(img, out["segments"])
        if not self.unlabeled:
            out["label"] = _read_tif(rec["lc"])[0].astype(np.int32)
        if self.crop_size:
            out = random_crop_superpixel(out, self.crop_size, self.rng)
        return out


def segment_mean_channels(img: np.ndarray, segments: np.ndarray) -> np.ndarray:
    """[C, H, W] image + [H, W] segment ids -> [C, H, W] where every pixel
    carries its superpixel's mean value (vectorized np.bincount scatter)."""
    c, h, w = img.shape
    flat_seg = segments.reshape(-1)
    nseg = int(flat_seg.max()) + 1 if flat_seg.size else 1
    counts = np.bincount(flat_seg, minlength=nseg).astype(np.float32)
    counts = np.maximum(counts, 1.0)
    out = np.empty_like(img, dtype=np.float32)
    for ch in range(c):
        sums = np.bincount(flat_seg, weights=img[ch].reshape(-1), minlength=nseg)
        out[ch] = (sums / counts)[flat_seg].reshape(h, w)
    return out
