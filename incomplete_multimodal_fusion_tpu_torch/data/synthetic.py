"""Synthetic multimodal raster batches, numpy only (JAX package
data/synthetic.py, the same generator step for step).

Stands in for the DFC2023-layout GeoTIFF pipeline
(reference pretraining/utils/multimodal_dfc2023.py): smooth shared structure
plus per-modality noise, roughly z-scored like the real data.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from .. import modalities as modreg


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
