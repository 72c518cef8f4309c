"""DFC2023-layout GeoTIFF pipeline (JAX package data/dfc2023.py; reference
pretraining/utils/multimodal_dfc2023.py).

Layout: ``{path}/rgb/*.tiff`` with sibling ``sar/`` and ``dsm/`` dirs derived
by directory-name replacement (multimodal_dfc2023.py:211-217). Per-modality
normalization matches the reference exactly:

  * SAR  -> 10*log10(x + 1e-7), clip [-25, 0], z-score mu=-7.9447875
    sigma=2.777256 (multimodal_dfc2023.py:130-141, 36-41)
  * RGB  -> per-channel z-score with the DFC2023 stats
    (multimodal_dfc2023.py:27-33, 116-126)
  * DSM  -> nan_to_num, per-image standardize (multimodal_dfc2023.py:99-112)

Rasters are read with the port's own TIFF codec (``data/tiff.py``) or from
``.npy`` side-cars. ``native=True`` (the default) normalizes through the C++
library of ``data/native.py`` where the raster's shape allows it (the JAX
package's shape rules); ``native=False`` takes the numpy versions, the plain
path. ``DFC2023Batches`` fills NHWC float32 batches in the order of the JAX
package's ``dfc2023_iterator`` (the same shuffle, the same drop-last rule),
into any buffer the caller gives it: ``data/loader.py`` gives it pinned host
memory.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

RGB_MEAN = np.array([81.29692, 87.93711, 72.041306], np.float32)
RGB_STD = np.array([39.61512, 35.407978, 35.84708], np.float32)
SAR_MEAN, SAR_STD = -7.9447875, 2.777256
DEM_MEAN, DEM_STD = 5.0160093, 7.6128364  # published stats (unused: per-image std)


def raster_source(path: str) -> Tuple[str, str]:
    """Where a raster's pixels are read from: ("npy", the side-car) when
    ``path`` is a ``.npy`` file or is missing beside its ``.npy`` side-car,
    else ("tiff", path)."""
    npy = os.path.splitext(path)[0] + ".npy"
    if path.endswith(".npy") or (os.path.exists(npy) and not os.path.exists(path)):
        return "npy", npy
    return "tiff", path


def _read_raster(path: str) -> np.ndarray:
    """Read a raster as [C, H, W] float32 from its TIFF or ``.npy`` side-car
    (``raster_source``)."""
    kind, src = raster_source(path)
    if kind == "npy":
        arr = np.load(src)
    elif not os.path.exists(path):
        raise FileNotFoundError(f"{path} (and no {os.path.splitext(path)[0]}.npy side-car)")
    else:
        from .tiff import read_tiff

        arr = read_tiff(path)
        if arr.ndim == 3 and arr.shape[-1] <= 8:  # HWC -> CHW
            arr = arr.transpose(2, 0, 1)
    if arr.ndim == 2:
        arr = arr[None]
    return arr.astype(np.float32)


def _resize_area(img: np.ndarray, size: int) -> np.ndarray:
    """Channel-wise area resize [C, H, W] -> [C, size, size]
    (resiz_4pl, multimodal_dfc2023.py:10-16). Pure-numpy box average when the
    source is an integer multiple; nearest otherwise (cv2 not assumed)."""
    c, h, w = img.shape
    if (h, w) == (size, size):
        return img
    if h % size == 0 and w % size == 0:
        fh, fw = h // size, w // size
        return img.reshape(c, size, fh, size, fw).mean(axis=(2, 4))
    ys = (np.arange(size) * h / size).astype(np.int64)
    xs = (np.arange(size) * w / size).astype(np.int64)
    return img[:, ys][:, :, xs]


def load_sar(path: str, size: int = 256, native: bool = True) -> np.ndarray:
    # native calls run single-threaded here: per-sample parallelism comes
    # from the batch filler's thread pool
    sar = _read_raster(path)
    if native and sar.shape[1] % size == 0 and sar.shape[2] % size == 0:
        from . import native as lib

        return lib.box_resize(lib.sar_normalize(sar, 1), size, 1) \
            if sar.shape[1:] != (size, size) else lib.sar_normalize(sar, 1)
    sar = 10.0 * np.log10(sar + 1e-7)
    sar = np.clip(sar, -25, 0)
    sar = np.nan_to_num(sar)
    sar = _resize_area(sar, size)
    return ((sar - SAR_MEAN) / SAR_STD).astype(np.float32)


def load_rgb(path: str, size: int = 256, native: bool = True) -> np.ndarray:
    rgb = _read_raster(path)
    if native and rgb.shape[0] == 3 and rgb.shape[1:] == (size, size):
        from . import native as lib

        return lib.rgb_normalize(rgb, 1)
    rgb = np.nan_to_num(rgb)
    rgb = _resize_area(rgb, size)
    return ((rgb - RGB_MEAN[:, None, None]) / RGB_STD[:, None, None]).astype(np.float32)


def load_dsm(path: str, size: int = 256, native: bool = True) -> np.ndarray:
    dsm = _read_raster(path)[:1]
    if native and dsm.shape[1:] == (size, size):
        from . import native as lib

        return lib.dsm_standardize(dsm, 1)
    dsm = np.nan_to_num(dsm)
    dsm = _resize_area(dsm, size)
    return ((dsm - dsm.mean()) / np.sqrt(dsm.var() + 1e-6)).astype(np.float32)


# the fused path's domains and the directories their rasters sit in
_FUSED_DIRS = {"s1": "sar", "s2": "rgb", "dem": "dsm"}


class DFC2023Dataset:
    """Sample index over the rgb/sar/dsm tree (multimodal_dfc2023.py:180-238).

    ``transform=True`` enables the consistent multimodal RandomCrop
    (multimodal_dfc2023.py:54-94, 201-205): rasters load at ``size`` and a
    shared ``crop_size`` window is cut from every modality (+ label).
    ``native`` picks the C++ normalizations (True) or the numpy ones.
    """

    def __init__(self, path: str, size: int = 256, unlabeled: bool = True,
                 transform: bool = False, crop_size: Optional[int] = None,
                 seed: int = 0, native: bool = True):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.size = size
        self.unlabeled = unlabeled
        self.transform = transform
        self.crop_size = crop_size or size
        self.native = native
        # per-sample generators are derived from (seed, index) on demand:
        # __getitem__ runs on a thread pool and a shared np.random.Generator
        # is not thread-safe
        self._seed = seed
        rgb_locs = sorted(
            glob.glob(os.path.join(path, "rgb/*.tiff"))
            + glob.glob(os.path.join(path, "rgb/*.tif"))
            + glob.glob(os.path.join(path, "rgb/*.npy"))
        )
        self.samples: List[Dict[str, str]] = []
        for rgb_loc in rgb_locs:
            rec = {
                "rgb": rgb_loc,
                "sar": rgb_loc.replace("rgb", "sar"),
                "dsm": rgb_loc.replace("rgb", "dsm"),
                "id": os.path.basename(rgb_loc),
            }
            if not unlabeled:
                rec["lc"] = rgb_loc.replace("rgb", "lc")
            self.samples.append(rec)
        if not self.samples:
            raise FileNotFoundError(f"no rgb rasters under {path}/rgb/")

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        s = self.samples[i]
        out = {
            "s1": load_sar(s["sar"], self.size, self.native),
            "s2": load_rgb(s["rgb"], self.size, self.native),
            "dem": load_dsm(s["dsm"], self.size, self.native),
        }
        if not self.unlabeled:
            out["label"] = _read_raster(s["lc"])[0].astype(np.int32)
        if self.transform and self.crop_size < self.size:
            from .augment import random_crop_multimodal

            rng = np.random.default_rng((self._seed, i))
            out = random_crop_multimodal(out, (self.crop_size, self.crop_size), rng)
        return out

    def load_into(self, i: int, dst: Dict[str, np.ndarray]) -> bool:
        """Fused fast path: decode the raw TIFF strips and normalize in one
        C++ pass straight into preallocated HWC batch-buffer slots (``dst``:
        {'s1': [H,W,1], 's2': [H,W,3], 'dem': [H,W,1]} float32 views): two
        memory passes a modality where ``__getitem__`` takes about seven.
        Compressed trees work too (``read_tiff`` inflates the strips).

        Returns False, and writes nothing, where the sample takes
        ``__getitem__`` instead, decided on what the config and the files
        are: the numpy path (``native=False``), cropped or labeled configs,
        ``.npy`` side-car rasters, rasters of another size than ``size`` and
        RGB of a dtype without a fused kernel. A read error raises."""
        if self.transform or not self.unlabeled or not self.native:
            return False
        from . import native as lib
        from .tiff import read_tiff

        s = self.samples[i]
        unknown = sorted(set(dst) - set(_FUSED_DIRS))
        if unknown:
            raise KeyError(f"DFC2023 samples hold s1, s2 and dem, not {unknown}")
        paths = {k: s[_FUSED_DIRS[k]] for k in dst}
        if any(raster_source(p)[0] != "tiff" for p in paths.values()):
            return False
        raw = {k: read_tiff(p) for k, p in paths.items()}
        size = self.size
        if "s2" in raw and (raw["s2"].shape != (size, size, 3) or raw["s2"].dtype not in lib.HWC_RGB_DTYPES):
            return False  # needs resize or the generic normalize
        if any(raw[k].shape[:2] != (size, size) for k in ("s1", "dem") if k in raw):
            return False
        if "s2" in raw:
            lib.rgb_hwc_normalize_into(raw["s2"], dst["s2"])
        if "s1" in raw:
            lib.sar_normalize_into(raw["s1"], dst["s1"])
        if "dem" in raw:
            d = raw["dem"]
            lib.standardize_into(d if d.ndim == 2 else d[..., 0], dst["dem"])
        return True


class DFC2023Batches:
    """The batches of ``dfc2023_iterator`` (JAX package dfc2023.py:276-321),
    written into buffers the caller owns: NHWC float32 [B, H, W, C] a domain.
    Each epoch shuffles the index pool in place with
    ``np.random.default_rng(seed)`` and cuts it into whole batches (the
    last partial batch dropped). ``random_crop`` loads at ``load_size``
    (default 2x input) and cuts a shared ``input_size`` window a sample.

    ``fill(out)`` writes the next batch: a pool of ``num_threads`` threads
    (at most the host's cores less one) writes each sample into its slot,
    through ``load_into`` where it can. ``skip(n)`` passes over n batches
    without reading them. ``specs`` is {domain: ((B, H, W, C), float32)}."""

    def __init__(self, path: str, in_domains: Sequence[str], batch_size: int, input_size: int = 256,
                 seed: int = 0, shuffle: bool = True, num_threads: int = 4, load_size: Optional[int] = None,
                 random_crop: bool = False, native: bool = True):
        from concurrent.futures import ThreadPoolExecutor

        if random_crop:
            self.ds = DFC2023Dataset(path, size=load_size or 2 * input_size, transform=True,
                                     crop_size=input_size, seed=seed, native=native)
        else:
            self.ds = DFC2023Dataset(path, size=input_size, native=native)
        if len(self.ds) < batch_size:
            raise ValueError(f"{path}: {len(self.ds)} samples, fewer than a batch of {batch_size}")
        self.in_domains = tuple(in_domains)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.order = np.arange(len(self.ds))
        self.pos = len(self.ds)  # an epoch starts on the first batch
        self.num_threads = min(num_threads, max(1, (os.cpu_count() or 1) - 1))
        self.pool = ThreadPoolExecutor(max_workers=self.num_threads) if self.num_threads > 1 else None
        # output shapes discovered once (crop changes H/W)
        s0 = self.ds[0]
        self.specs = {k: ((batch_size, s0[k].shape[1], s0[k].shape[2], s0[k].shape[0]), np.dtype(np.float32))
                      for k in self.in_domains}

    def next_indices(self) -> np.ndarray:
        if self.pos + self.batch_size > len(self.ds):
            if self.shuffle:
                self.rng.shuffle(self.order)
            self.pos = 0
        idx = self.order[self.pos:self.pos + self.batch_size]
        self.pos += self.batch_size
        return idx

    def skip(self, n: int) -> None:
        for _ in range(n):
            self.next_indices()

    def fill(self, out: Dict[str, np.ndarray]) -> None:
        def one(job):
            slot, i = job
            dst = {k: out[k][slot] for k in self.in_domains}
            if self.ds.load_into(int(i), dst):
                return
            s = self.ds[int(i)]
            for k in self.in_domains:
                out[k][slot] = s[k].transpose(1, 2, 0)

        jobs = list(enumerate(self.next_indices()))
        if self.pool is None:
            for job in jobs:
                one(job)
        else:
            list(self.pool.map(one, jobs))  # raises the first sample's error

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)


def dfc2023_iterator(
    path: str,
    in_domains: Tuple[str, ...],
    batch_size: int,
    input_size: int = 256,
    seed: int = 0,
    shuffle: bool = True,
    prefetch: int = 2,
    num_threads: int = 4,
    load_size: Optional[int] = None,
    random_crop: bool = False,
    native: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite shuffled NHWC numpy batch iterator with background prefetch
    (the JAX package's, batch for batch): ``DFC2023Batches`` filled on a
    producer thread. A producer error is raised here."""
    from .loader import host_batches

    return host_batches(DFC2023Batches(path, in_domains, batch_size, input_size, seed, shuffle, num_threads,
                                       load_size, random_crop, native), prefetch)
