"""Builds the hand-written CUDA kernels of ``csrc/`` and loads them.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. A library is
named after a hash of its source and flags, so an edited source is rebuilt
and a stale build is never loaded. Builds land in ``build/kernels/`` at the
root of the checkout (git-ignored). Nothing is built when this module is
imported: a kernel is built the first time its wrapper launches it, or all of
them at once by :func:`build_all`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("zorro_attention.cu", "fused_ffn.cu", "fused_ffn_bwd.cu", "fusion_row_attention.cu",
           "ms_deform_attn.cu", "point_sample.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def _build(sources) -> None:
    """Compiles the libraries of ``sources`` that are not built yet, in
    parallel; raises if any compilation fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source in sources:
        out = library_path(source)
        if not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            jobs.append((source, out, tmp, subprocess.Popen(cmd)))
    failed = []
    for source, out, tmp, proc in jobs:
        if proc.wait() != 0:
            failed.append(source)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}")


def build_all() -> List[Path]:
    """Builds every kernel library that is not built yet and returns their
    paths."""
    _build(SOURCES)
    return [library_path(s) for s in SOURCES]


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _LOADED.get(source)
    if lib is None:
        _build([source])
        lib = ctypes.CDLL(str(library_path(source)))
        _LOADED[source] = lib
    return lib


def bind(source: str, name: str, argtypes):
    """The C entry point ``name`` of ``source``'s library, with its argument
    types declared (every pointer and the stream as c_void_p, or ctypes
    would pass them as 32-bit ints) and an int (cudaError_t) result."""
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
