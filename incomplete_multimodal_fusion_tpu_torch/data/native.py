"""ctypes bindings for the native raster-preprocessing library
(``native/raster_ops.cc``; JAX package data/native.py): multithreaded
SAR / RGB / DSM normalization and box resize for the host side of the input
pipeline.

The library is built from ``native/raster_ops.cc`` with ``g++`` and the
flags of ``native/Makefile`` into ``build/native/`` at the root of the
checkout (git-ignored), the first time a function here is called. Its file
is named after a hash of the source, the flags and the host's CPU (the
flags hold ``-march=native``), so an edited source is rebuilt and a library
built on another CPU is never loaded; the prebuilt ``native/libraster_ops.so``
is never loaded either. A failed build or load raises: the numpy versions in
``data/dfc2023.py`` are the plain versions, and a caller picks them with an
argument (``native=False``), never because the library is missing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from .dfc2023 import RGB_MEAN, RGB_STD, SAR_MEAN, SAR_STD

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "raster_ops.cc"
BUILD_DIR = ROOT / "build" / "native"
# native/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-fno-math-errno", "-fno-trapping-math",
            "-funroll-loops")
LDFLAGS = ("-shared", "-lpthread")
# the raw HWC RGB dtypes the fused normalize-into kernels take
HWC_RGB_DTYPES = (np.dtype(np.uint8), np.dtype(np.uint16))

_lib: Optional[ctypes.CDLL] = None
_F32P = ctypes.POINTER(ctypes.c_float)


def _cpu_id() -> bytes:
    """The host CPU's model and feature flags (what ``-march=native``
    compiles for), from the first processor of /proc/cpuinfo."""
    try:
        with open("/proc/cpuinfo") as f:
            text = f.read().split("\n\n")[0]
    except OSError:
        import platform

        return f"{platform.machine()} {platform.processor()}".encode()
    return "\n".join(ln for ln in text.splitlines() if ln.startswith(("model name", "flags"))).encode()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS + LDFLAGS).encode() + _cpu_id())
    return BUILD_DIR / f"libraster_ops-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles the library if it is not built yet and returns its path;
    raises if the compiler is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: it is needed to build native/raster_ops.cc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXXFLAGS, str(SOURCE), *LDFLAGS, "-o", str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE} ({r.returncode}): {r.stderr[-3000:]}")
    os.replace(tmp, out)  # another process may have built it meanwhile: the same file
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.sar_normalize.argtypes = [_F32P, _F32P, ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int]
    lib.channel_zscore.argtypes = [_F32P, _F32P, ctypes.c_int64, ctypes.c_int64, _F32P, _F32P, ctypes.c_int]
    lib.standardize.argtypes = [_F32P, _F32P, ctypes.c_int64, ctypes.c_int]
    lib.box_resize.argtypes = [_F32P, _F32P] + [ctypes.c_int64] * 5 + [ctypes.c_int]
    lib.sar_normalize_batch.argtypes = [_F32P, _F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                                        ctypes.c_float, ctypes.c_int]
    lib.standardize_batch.argtypes = [_F32P, _F32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    lib.rgb_u8_hwc_normalize.argtypes = [ctypes.POINTER(ctypes.c_uint8), _F32P, ctypes.c_int64, _F32P, _F32P]
    lib.rgb_u16_hwc_normalize.argtypes = [ctypes.POINTER(ctypes.c_uint16), _F32P, ctypes.c_int64, _F32P, _F32P]
    for name in ("sar_normalize", "channel_zscore", "standardize", "box_resize", "sar_normalize_batch",
                 "standardize_batch", "rgb_u8_hwc_normalize", "rgb_u16_hwc_normalize"):
        getattr(lib, name).restype = None
    _lib = lib
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _prep(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _check_out(out: np.ndarray, size: int) -> None:
    if out.dtype != np.float32 or not out.flags.c_contiguous or out.size != size:
        raise ValueError(f"the output must be contiguous float32 of {size} elements, got {out.dtype} "
                         f"{out.shape} (contiguous: {out.flags.c_contiguous})")


def sar_normalize(x: np.ndarray, num_threads: int = 4) -> np.ndarray:
    lib = load_library()
    x = _prep(x)
    out = np.empty_like(x)
    lib.sar_normalize(_fp(x), _fp(out), x.size, SAR_MEAN, SAR_STD, num_threads)
    return out


def rgb_normalize(x: np.ndarray, num_threads: int = 4) -> np.ndarray:
    """x: [3, H, W]."""
    lib = load_library()
    x = _prep(np.nan_to_num(x))
    out = np.empty_like(x)
    mean = _prep(RGB_MEAN)
    std = _prep(RGB_STD)
    lib.channel_zscore(_fp(x), _fp(out), x.shape[0], x.size // x.shape[0], _fp(mean), _fp(std), num_threads)
    return out


def dsm_standardize(x: np.ndarray, num_threads: int = 4) -> np.ndarray:
    lib = load_library()
    x = _prep(x)
    out = np.empty_like(x)
    lib.standardize(_fp(x), _fp(out), x.size, num_threads)
    return out


def box_resize(x: np.ndarray, size: int, num_threads: int = 4) -> np.ndarray:
    """x: [C, H, W] -> [C, size, size]: the box average where H and W are
    multiples of ``size``, else the nearest sample."""
    lib = load_library()
    x = _prep(x)
    c, h, w = x.shape
    out = np.empty((c, size, size), np.float32)
    lib.box_resize(_fp(x), _fp(out), c, h, w, size, size, num_threads)
    return out


def rgb_hwc_normalize_into(x: np.ndarray, out: np.ndarray) -> None:
    """Fused raw-HWC-RGB -> normalized float32 HWC, written into ``out`` (a
    contiguous [H, W, 3] batch-buffer slot): one read and one write pass.
    ``x`` is uint8 or uint16 (``HWC_RGB_DTYPES``)."""
    lib = load_library()
    if x.dtype == np.uint8:
        fn, ptr = lib.rgb_u8_hwc_normalize, ctypes.POINTER(ctypes.c_uint8)
    elif x.dtype == np.uint16:
        fn, ptr = lib.rgb_u16_hwc_normalize, ctypes.POINTER(ctypes.c_uint16)
    else:
        raise TypeError(f"rgb_hwc_normalize_into takes {HWC_RGB_DTYPES}, got {x.dtype}")
    if not x.flags.c_contiguous or x.ndim != 3 or x.shape[-1] != 3 or x.shape != out.shape:
        raise ValueError(f"rgb_hwc_normalize_into: contiguous [H, W, 3] in and out, got {x.shape} -> {out.shape}")
    _check_out(out, x.size)
    mean = _prep(RGB_MEAN)
    std = _prep(RGB_STD)
    fn(x.ctypes.data_as(ptr), _fp(out), x.size // 3, _fp(mean), _fp(std))


def sar_normalize_into(x: np.ndarray, out: np.ndarray) -> None:
    """SAR normalize into a preallocated slot (layout-free elementwise)."""
    lib = load_library()
    x = _prep(x)
    _check_out(out, x.size)
    lib.sar_normalize(_fp(x), _fp(out), x.size, SAR_MEAN, SAR_STD, 1)


def standardize_into(x: np.ndarray, out: np.ndarray) -> None:
    """Per-image standardize into a preallocated slot."""
    lib = load_library()
    x = _prep(x)
    _check_out(out, x.size)
    lib.standardize(_fp(x), _fp(out), x.size, 1)


def sar_normalize_batch(x: np.ndarray, num_threads: int = 8) -> np.ndarray:
    lib = load_library()
    x = _prep(x)
    out = np.empty_like(x)
    b = x.shape[0]
    lib.sar_normalize_batch(_fp(x), _fp(out), b, x.size // b, SAR_MEAN, SAR_STD, num_threads)
    return out


def dsm_standardize_batch(x: np.ndarray, num_threads: int = 8) -> np.ndarray:
    lib = load_library()
    x = _prep(x)
    out = np.empty_like(x)
    b = x.shape[0]
    lib.standardize_batch(_fp(x), _fp(out), b, x.size // b, num_threads)
    return out
