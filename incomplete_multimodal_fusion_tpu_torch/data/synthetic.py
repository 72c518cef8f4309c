"""Synthetic multimodal raster batches, numpy only (JAX package
data/synthetic.py, the same generator step for step).

``synthetic_batch`` stands in for the DFC2023-layout GeoTIFF pipeline
(reference pretraining/utils/multimodal_dfc2023.py): smooth shared structure
plus per-modality noise, roughly z-scored like the real data.
``synthetic_instances`` gives the downstream trainer's synthetic instance
targets (scripts/train_downstream.py:70-93).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from .. import modalities as modreg
from .targets import SegTargets


def synthetic_batch(
    rng: np.random.Generator,
    in_domains: Tuple[str, ...],
    batch_size: int,
    input_size: int,
) -> Dict[str, np.ndarray]:
    """Smooth correlated fields so reconstructions/PSNR are meaningful."""
    out = {}
    base = rng.standard_normal((batch_size, input_size // 8, input_size // 8, 1)).astype(np.float32)
    up = np.repeat(np.repeat(base, 8, axis=1), 8, axis=2)
    for d in in_domains:
        spec = modreg.get(d)
        if spec.adapter == "semseg":
            cls = rng.integers(0, spec.num_classes, (batch_size, input_size, input_size))
            out[d] = cls.astype(np.int32)
        else:
            noise = 0.3 * rng.standard_normal(
                (batch_size, input_size, input_size, spec.num_channels)
            ).astype(np.float32)
            out[d] = up + noise  # shared structure + modality noise, ~z-scored
    return out


def synthetic_iterator(
    seed: int,
    in_domains: Tuple[str, ...],
    batch_size: int,
    input_size: int,
) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    while True:
        yield synthetic_batch(rng, in_domains, batch_size, input_size)


def synthetic_instances(rng: np.random.Generator, b: int, s: int, num_classes: int,
                        g: int = 8) -> Tuple[Dict[str, np.ndarray], SegTargets]:
    """Random s1 / s2 / dem rasters [b, s, s, C] and rectangular instance
    targets, 1 to 3 an image among ``g`` padded columns, each object painted
    into every raster (+2 + its label) so it is learnable; the draws of
    scripts/train_downstream.py:70-93 in the same order, so one seed gives
    the same arrays bit for bit. The targets are numpy ``SegTargets``."""
    x = {
        "s1": rng.standard_normal((b, s, s, 1)).astype(np.float32),
        "s2": rng.standard_normal((b, s, s, 3)).astype(np.float32),
        "dem": rng.standard_normal((b, s, s, 1)).astype(np.float32),
    }
    labels = np.full((b, g), -1, np.int32)
    masks = np.zeros((b, g, s, s), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        n = rng.integers(1, 4)
        for j in range(n):
            h0, w0 = rng.integers(0, s // 2, 2)
            hh, ww = rng.integers(s // 8, s // 2, 2)
            masks[i, j, h0: h0 + hh, w0: w0 + ww] = 1.0
            labels[i, j] = rng.integers(0, num_classes)
            valid[i, j] = True
            for k in x:
                x[k][i, h0: h0 + hh, w0: w0 + ww] += 2.0 + labels[i, j]
    return x, SegTargets(labels, masks, valid)
