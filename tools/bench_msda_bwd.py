"""Times builds of kernel K4b (the deformable-attention backward,
csrc/ms_deform_attn.cu), or with ``--forward`` of K4 (the forward), against
each other in one process on one GPU.

Each argument is ``label=path`` to a version of ms_deform_attn.cu (default:
the repo's own, labelled ``repo``). Each is compiled with the port's build
flags (``-I csrc``, so a copy elsewhere finds the headers) into
``build/bench_msda/``, all in parallel, and its ``ms_deform_attn_bwd_f32``
(``ms_deform_attn_fwd_f32``) is called through ctypes on chip_smoke.py's
phase-3 inputs: B = 1 and 30, Lq = S = 1344, 8 heads x 32, levels 8^2 /
16^2 / 32^2, 4 points, random locations and near the reference points. A
library that exports ``ms_deform_attn_bwd_scratch_floats`` gets the scratch
it asks for; one that does not is called without a scratch argument, with
dV zeroed before each call (the atomic design of earlier trees). For each
version and input it prints the relative L2 error of each output against
the plain version, the device time of one call (torch.profiler: the
kernels whose name holds ``ms_deform_attn``, mean of 10 calls after 3
warm-ups, split by kernel) and the time by CUDA events (median of 20); the
versions run in the order given, then again in reverse, and both passes
print.

    python3 tools/bench_msda_bwd.py [--forward] [label=path.cu ...]

Needs a CUDA card and nvcc; imports nothing of the JAX package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (MSDA_LEVELS, SEED, cuda_ms, kernel_name, msda_inputs, profiled_ms, rel_l2)
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_build, cuda_msda

OUT = cuda_build.BUILD_DIR.parent / "bench_msda"


def build(versions):
    """{label: loaded library}, the sources compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for label, path in versions:
        src = open(path, "rb").read()
        lib = OUT / f"{label}-{hashlib.sha256(src).hexdigest()[:12]}.so"
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-o", str(lib), path]
        jobs.append((label, lib, subprocess.Popen(cmd)))
    libs = {}
    for label, lib, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {label}")
        libs[label] = ctypes.CDLL(str(lib))
    return libs


def caller(lib):
    """fn(value, locs, aw, dout) -> (dvalue, dloc, daw) through the library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    hw = (ctypes.c_int * (2 * len(MSDA_LEVELS)))(*[v for shape in MSDA_LEVELS for v in shape])
    fn = lib.ms_deform_attn_bwd_f32
    fn.restype = ctypes.c_int
    scratch_fn = getattr(lib, "ms_deform_attn_bwd_scratch_floats", None)
    if scratch_fn is not None:
        scratch_fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
        scratch_fn.restype = ctypes.c_longlong
        fn.argtypes = [p] * 8 + [i] * 7 + [ctypes.POINTER(ctypes.c_int), p]
    else:
        fn.argtypes = [p] * 7 + [i] * 7 + [ctypes.POINTER(ctypes.c_int), p]

    def run(value, locs, aw, dout):
        b, s, m, d = value.shape
        lq, l, pts = locs.shape[1], locs.shape[3], locs.shape[4]
        dv, dl, da = torch.empty_like(value), torch.empty_like(locs), torch.empty_like(aw)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (value, locs, aw, dout, dv, dl, da)]
        if scratch_fn is None:
            dv.zero_()
            err = fn(*ptrs, b, s, lq, m, d, l, pts, hw, stream)
        else:
            floats = scratch_fn(b, s, lq, m, d, l, pts, hw)
            scratch = torch.empty(max(floats, 1), device=value.device) if floats > 0 else None
            err = fn(*ptrs, None if scratch is None else scratch.data_ptr(), b, s, lq, m, d, l, pts, hw, stream)
        cuda_build.check_launch(err, "ms_deform_attn_bwd_f32")
        return dv, dl, da
    return run


def forward_caller(lib):
    """fn(value, locs, aw) -> (out,) through the library's forward."""
    p, i = ctypes.c_void_p, ctypes.c_int
    hw = (ctypes.c_int * (2 * len(MSDA_LEVELS)))(*[v for shape in MSDA_LEVELS for v in shape])
    fn = lib.ms_deform_attn_fwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [p] * 4 + [i] * 7 + [ctypes.POINTER(ctypes.c_int), p]

    def run(value, locs, aw):
        b, s, m, d = value.shape
        lq, l, pts = locs.shape[1], locs.shape[3], locs.shape[4]
        out = torch.empty((b, lq, m * d), device=value.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(value.data_ptr(), locs.data_ptr(), aw.data_ptr(), out.data_ptr(), b, s, lq, m, d, l, pts, hw,
                 stream)
        cuda_build.check_launch(err, "ms_deform_attn_fwd_f32")
        return (out,)
    return run


def main(argv) -> int:
    forward = "--forward" in argv
    argv = [a for a in argv if a != "--forward"]
    versions = [tuple(a.split("=", 1)) for a in argv] or [("repo", str(cuda_build.CSRC / "ms_deform_attn.cu"))]
    libs = build(versions)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = []
    shapes = ((1, False), (30, False), (30, True)) if forward else ((1, False), (30, False), (1, True), (30, True))
    for b, near in shapes:
        value, locs, aw = msda_inputs(dev, g, b, near_reference=near)
        if forward:
            args, want = (value, locs, aw), (cuda_msda.ms_deform_attn_core(value, MSDA_LEVELS, locs, aw),)
        else:
            dout = torch.randn(b, locs.shape[1], value.shape[2] * value.shape[3], device=dev, generator=g)
            args = (value, locs, aw, dout)
            want = cuda_msda.ms_deform_attn_backward_reference(value, MSDA_LEVELS, locs, aw, dout)
        cases.append((f"B={b}" + (" near" if near else ""), args, want))
    order = [label for label, _ in versions]
    for pass_no, labels in enumerate((order, order[::-1])):
        for label in labels:
            run = (forward_caller if forward else caller)(libs[label])
            for name, args, want in cases:
                got = run(*args)
                err = max(rel_l2(a, w) for a, w in zip(got, want))
                ms, _, per_name = profiled_ms(lambda: run(*args), own="ms_deform_attn")
                split = " + ".join(f"{kernel_name(k)} {v:.6g}" for k, v in sorted(per_name.items()))
                print(f"pass {pass_no} {label:12s} {name:9s} rel_l2 {err:.3g} device {ms:.6g} ms ({split}) "
                      f"events {cuda_ms(lambda: run(*args)):.6g} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
