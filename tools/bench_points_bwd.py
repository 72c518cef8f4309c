"""Times designs of kernel K5b (the point-sample backward's dmasks,
csrc/point_sample.cu) against each other in one process on one GPU.

The versions: the repo's point_sample.cu (``repo``) and the designs of
tools/point_sample_bwd_variants.cu (``v0`` .. ``v25``, see that file), all
of them or those named on the command line, plus any ``label=path.cu``
(another point_sample.cu, such as a parent tree's). Each is compiled with the port's
build flags (``-I csrc``) into ``build/bench_points/``, all in parallel, and
its ``point_sample_bwd_f32`` is called through ctypes on chip_smoke.py's
phase-3 input of K5b -- masks [240, 64^2] f32, 12544 points a mask, dS
random -- with the points uniform in [-0.05, 1.05] on random masks, and
on smooth logits at the points the set criterion draws on them
(``chip_smoke.criterion_points``). A version whose
``point_sample_bwd_writes_all`` says 0 gets dmasks zeroed before each call,
and that zeroing is part of its time. For each version and input it prints
the relative L2 error against the plain backward, whether two calls give
bitwise the same dmasks, the device time of one call (torch.profiler: every
device kernel of the call, mean of 10 calls after 3 warm-ups) and the time
by CUDA events (median of 20); the versions run in the order given, then
again in reverse, and both passes print.

    python3 tools/bench_points_bwd.py [repo] [v0 .. v25] [label=path.cu ...]

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
from chip_smoke import SEED, criterion_points, cuda_ms, profiled_ms, rel_l2
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_build, cuda_points

OUT = cuda_build.BUILD_DIR.parent / "bench_points"
VARIANTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "point_sample_bwd_variants.cu")


def build(versions):
    """{label: loaded library}: (label, source, extra nvcc flags), compiled
    in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for label, path, flags in versions:
        digest = hashlib.sha256(open(path, "rb").read() + " ".join(flags).encode())
        for header in sorted(cuda_build.CSRC.glob("*")):
            digest.update(header.read_bytes())
        lib = OUT / f"{label}-{digest.hexdigest()[:12]}.so"
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-I", str(cuda_build.CSRC), "-o", str(lib), path]
        jobs.append((label, lib, subprocess.Popen(cmd)))
    libs = {}
    for label, lib, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {label}")
        libs[label] = ctypes.CDLL(str(lib))
    return libs


def caller(lib):
    """fn(masks, coords, ds) -> dmasks through the library's backward."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.point_sample_bwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [p] * 5 + [i] * 5 + [p]
    writes_all = lib.point_sample_bwd_writes_all
    writes_all.argtypes = [i] * 3

    def run(masks, coords, ds):
        n, h, w = masks.shape
        pts = coords.shape[1]
        dm = torch.empty_like(masks) if writes_all(pts, h, w) else torch.zeros_like(masks)
        err = fn(masks.data_ptr(), coords.data_ptr(), ds.data_ptr(), dm.data_ptr(), None, n, pts, h, w, 1,
                 torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(err, "point_sample_bwd_f32")
        return dm
    return run


def versions_of(argv):
    named = {"repo": ("repo", str(cuda_build.CSRC / "point_sample.cu"), [])}
    named.update({f"v{k}": (f"v{k}", VARIANTS, [f"-DVARIANT={k}"]) for k in range(26)})
    out = []
    for a in argv or ["repo", *(f"v{k}" for k in range(26))]:
        if "=" in a:
            label, path = a.split("=", 1)
            out.append((label, path, []))
        else:
            out.append(named[a])
    return out


def main(argv) -> int:
    versions = versions_of(argv)
    libs = build(versions)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    n, size, pts = 240, 64, 12544
    masks = torch.randn(n, size, size, device=dev, generator=g)
    ds = torch.randn(n, pts, device=dev, generator=g)
    logits, crit = criterion_points(dev, g, n, size, pts)
    cases = [("uniform", masks, -0.05 + 1.1 * torch.rand(n, pts, 2, device=dev, generator=g)),
             ("criterion", logits, crit)]
    wants = {name: cuda_points.point_sample_backward_reference(m, coords, ds)[0] for name, m, coords in cases}
    order = [label for label, _, _ in versions]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for pass_no, labels in enumerate((order, order[::-1])):
        for label in labels:
            run = caller(libs[label])
            for name, m, coords in cases:
                got = run(m, coords, ds)
                same = bool(torch.equal(got, run(m, coords, ds)))
                ms, events, _ = profiled_ms(lambda: run(m, coords, ds))
                print(f"pass {pass_no} {label:6s} {name:9s} rel_l2 {rel_l2(got, wants[name]):.3g} bitwise repeat "
                      f"{same} device {ms:.6g} ms ({events:g} kernels) events "
                      f"{cuda_ms(lambda: run(m, coords, ds)):.6g} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
