"""The host data path: synthetic batches, the dataset readers (DFC2023,
COCO instances, quadruplets, ADE odgt lists, SEN12MS), the TIFF codec, the
native raster ops, augmentation and the loader that feeds the card. The
submodules load on first use."""
import importlib

import numpy as np

_SUBMODULES = ("ade_metadata", "ade_odgt", "augment", "coco_instance", "dfc2023", "loader", "native",
               "quadruplet", "sample_trees", "sen12ms", "synthetic", "targets", "tiff")
__all__ = [*_SUBMODULES, "patchify_batch"]


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def patchify_batch(batch, patch_size: int):
    """Host-side patchify (JAX package data/__init__.py:9-30): {d: [B, H, W, C]
    float} -> {d: [B, N, p*p*C]} in the pixel order (ph, pw, c) of
    ``ops.patches.patchify``, the layout ``PatchedInputAdapter`` embeds with
    one product and the patch-space losses take as their target. Integer
    semantic maps and already-patchified entries pass through unchanged."""
    p = patch_size
    out = {}
    for d, x in batch.items():
        if x.ndim == 4 and np.issubdtype(np.asarray(x).dtype, np.floating):
            b, h, w, c = x.shape
            nh, nw = h // p, w // p
            xp = np.asarray(x).reshape(b, nh, p, nw, p, c).transpose(0, 1, 3, 2, 4, 5)
            out[d] = np.ascontiguousarray(xp).reshape(b, nh * nw, p * p * c)
        else:
            out[d] = x
    return out
