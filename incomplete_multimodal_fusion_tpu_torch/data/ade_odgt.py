"""ADE20k-style odgt semantic dataset (JAX package data/ade_odgt.py;
reference downstream/instance_segmentation/dataset/dataset.py:34-199
``ADE200kDataset``: json-lines records {fpath_img, fpath_segm} with
training.odgt / validation.odgt lists; the reference batches dynamic sizes
per-batch — here every sample is resized/cropped to one static size).

Image IO: ``.npy`` side-cars, else PIL, imported only for such a file (no
imgaug dependency — the aug_strategy.py pipeline reduces to flip + crop
here). ``ADEBatches`` fills the batches of the JAX package's
``ade_batch_iterator`` into buffers the caller owns.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Dict, Iterator, List

import numpy as np


def _load_image(path: str) -> np.ndarray:
    npy = os.path.splitext(path)[0] + ".npy"
    if os.path.exists(npy):
        arr = np.load(npy)
    else:
        from PIL import Image  # type: ignore

        arr = np.asarray(Image.open(path))
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * img.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * img.shape[1] / w).astype(np.int64)
    return img[ys][:, xs]


IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255


class ADEOdgtDataset:
    def __init__(self, odgt_path: str, root: str = "", img_size: int = 256,
                 segm_downsampling_rate: int = 1, flip: bool = False, seed: int = 0):
        self.records: List[Dict] = []
        with open(odgt_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    self.records.append(json.loads(line))
        if not self.records:
            raise FileNotFoundError(f"no records in {odgt_path}")
        self.root = root
        self.img_size = img_size
        self.segm_rate = segm_downsampling_rate
        self.flip = flip
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rec = self.records[i]
        img = _load_image(os.path.join(self.root, rec["fpath_img"])).astype(np.float32)
        segm = _load_image(os.path.join(self.root, rec["fpath_segm"]))[..., 0]
        s = self.img_size
        img = _resize_nearest(img, s, s)
        segm = _resize_nearest(segm.astype(np.int32), s, s)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        img = (img[..., :3] - IMG_MEAN) / IMG_STD
        if self.flip and self.rng.random() < 0.5:
            img = img[:, ::-1]
            segm = segm[:, ::-1]
        if self.segm_rate > 1:
            segm = segm[:: self.segm_rate, :: self.segm_rate]
        return {"image": np.ascontiguousarray(img),
                "label": np.ascontiguousarray(segm)}


class ADEBatches:
    """The batches of ``ade_batch_iterator`` (JAX package ade_odgt.py:82-100):
    ``image`` [B, s, s, 3] float32 and ``label`` [B, s', s'] int32. Each
    epoch shuffles the index pool with ``np.random.default_rng(seed)``; the
    dataset's flips draw from its own generator, in sample order."""

    def __init__(self, ds: ADEOdgtDataset, batch_size: int, shuffle: bool = True, seed: int = 0):
        if len(ds) < batch_size:
            raise ValueError(f"{len(ds)} odgt records, fewer than a batch of {batch_size}")
        self.ds, self.batch_size, self.shuffle = ds, batch_size, shuffle
        self.rng = np.random.default_rng(seed)
        self.order = np.arange(len(ds))
        self.pos = len(ds)  # an epoch starts on the first batch
        s0 = copy.deepcopy(ds)[0]  # a copy: the dataset's flip generator draws nothing for it
        self.specs = {k: ((batch_size,) + v.shape, v.dtype) for k, v in s0.items()}

    def fill(self, out: Dict[str, np.ndarray]) -> None:
        if self.pos + self.batch_size > len(self.ds):
            if self.shuffle:
                self.rng.shuffle(self.order)
            self.pos = 0
        idx = self.order[self.pos:self.pos + self.batch_size]
        self.pos += self.batch_size
        samples = [self.ds[int(i)] for i in idx]
        for k in samples[0]:
            np.stack([s[k] for s in samples], out=out[k])

    def close(self) -> None:
        pass


def ade_batch_iterator(ds: ADEOdgtDataset, batch_size: int, shuffle: bool = True,
                       seed: int = 0, prefetch: int = 2
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite batches, the JAX package's batch for batch: ``ADEBatches``
    filled on a producer thread."""
    from .loader import host_batches

    return host_batches(ADEBatches(ds, batch_size, shuffle, seed), prefetch)
