"""Times builds of kernel K6 / K6b (the fused attention half-block,
csrc/fused_block_attn.cu) against each other in one process on one GPU.

Each argument is ``label=path`` to a version of fused_block_attn.cu
(default: the repo's own, labelled ``repo``). Each is compiled with the
port's build flags (``-I csrc``, so a copy elsewhere finds the headers) into
``build/bench_block_attn/``, all in parallel, and its forward and backward
entry points are called through ctypes on chip_smoke.py's phase-3 inputs
(N = 640, B = 60, D = I = 192, 3 heads x 64, the pretraining masks). For
each version it prints the largest relative L2 error of the outputs against
the plain versions, the device time of one call (torch.profiler: the
kernels whose name holds ``block_attn``, ``zorro_attention`` or ``wgrad``,
mean of 10 calls after 3 warm-ups, split by kernel) and the time by CUDA
events (median of 20); the versions run in the order given, then again in
reverse, and both passes print.

With ``--f32`` the f32 instance instead (fused_block_attn_fwd_f32 /
fused_block_attn_bwd_f32, the workspace each version asks for itself) on
the same inputs in f32, TF32 off: the device time split by kernel (the
kernels whose name holds ``ffn_tf32_wide``, ``simt_f32`` or
``zorro_attention_f32``), the CUDA-event time, and the rel-L2 of every
output against the f32 plain version (what chip_smoke.py holds to 1e-5) and
against the plain version in f64 (the worst output, and each), beside the
f32 plain version's own against f64. A version from before a change is its
tree's fused_block_attn.cu (the quoted includes resolve beside it), e.g.
the parent unpacked by ``git archive`` into ``build/parent``.

    python3 tools/bench_block_attn.py [--f32] [label=path.cu ...]

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
from chip_smoke import SEED, cuda_ms, kernel_name, packed_types, profiled_ms, rel_l2
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_block_attn, cuda_build, masking

OUT = cuda_build.BUILD_DIR.parent / "bench_block_attn"
OWN = ("block_attn", "zorro_attention", "wgrad")
OWN_F32 = ("ffn_tf32_wide", "simt_f32", "zorro_attention_f32")
GRADS = ("dx", "dg1", "dg2", "dwq", "dwkv", "dwo")


def rel64(a, b) -> float:
    """rel-L2 of a against an f64 reference, taken in f64."""
    return float((a.double() - b.double()).norm() / b.double().norm())


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


def callers(lib, heads: int, fusion: int):
    """(forward(x, types, *w), backward(x, types, *w, dy)) through the
    library, with the workspaces the wrapper allocates."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, bwd = lib.fused_block_attn_fwd_bf16, lib.fused_block_attn_bwd_bf16
    fwd.argtypes = [p] * 10 + [i] * 5 + [f, i, p]
    bwd.argtypes = [p] * 23 + [i] * 5 + [f, i, i, p]
    fwd.restype = bwd.restype = ctypes.c_int
    lib.fused_block_attn_bwd_splits.argtypes = [i] * 3
    lib.fused_block_attn_row_block.argtypes = []
    lib.fused_block_attn_bwd_dh_floats.argtypes = [i] * 2
    lib.fused_block_attn_bwd_dh_floats.restype = ctypes.c_longlong

    def forward(x, types, g1, g2, wq, wkv, wo):
        b, n, d = x.shape
        inner = wq.shape[0]
        y = torch.empty_like(x)
        qkv = torch.empty((b, n, 3 * inner), dtype=x.dtype, device=x.device)
        out = torch.empty((b, n, inner), dtype=x.dtype, device=x.device)
        err = fwd(*[t.data_ptr() for t in (x, types, g1, g2, wq, wkv, wo, y, qkv, out)], b, n, d, heads,
                  inner // heads, (inner // heads) ** -0.5, fusion, torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(err, "fused_block_attn")
        return (y,)

    def backward(x, types, g1, g2, wq, wkv, wo, dy):
        b, n, d = x.shape
        inner, m, dev, bf = wq.shape[0], b * n, x.device, x.dtype
        splits = lib.fused_block_attn_bwd_splits(m, d, inner)
        dx, dg1, dg2 = torch.empty_like(x), torch.empty_like(g1), torch.empty_like(g2)
        dw_qkv, dwo = torch.empty((3 * inner, d), dtype=bf, device=dev), torch.empty_like(wo)
        qkv, dqkv = (torch.empty((b, n, 3 * inner), dtype=bf, device=dev) for _ in range(2))
        h = torch.empty_like(x)
        out, dout = (torch.empty((b, n, inner), dtype=bf, device=dev) for _ in range(2))
        lse, delta = (torch.empty((b, heads, n), dtype=torch.float32, device=dev) for _ in range(2))
        dhid = torch.empty((max(lib.fused_block_attn_bwd_dh_floats(m, d), 1),), dtype=torch.float32, device=dev)
        part = torch.empty((splits * (3 * inner * d + d * inner),), dtype=torch.float32, device=dev)
        vec = torch.empty((-(-m // lib.fused_block_attn_row_block()), 2 * d), dtype=torch.float32, device=dev)
        tensors = (x, types, g1, g2, wq, wkv, wo, dy, dx, dg1, dg2, dw_qkv, dwo, qkv, h, out, dout, lse, delta,
                   dqkv, dhid, part, vec)
        err = bwd(*[t.data_ptr() for t in tensors], b, n, d, heads, inner // heads, (inner // heads) ** -0.5,
                  fusion, splits, torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(err, "fused_block_attn_backward")
        return dx, dg1, dg2, dw_qkv[:inner], dw_qkv[inner:], dwo

    return forward, backward


def callers_f32(lib, heads: int, fusion: int):
    """(forward, backward) of the f32 instance through the library, with
    the one f32 workspace it sizes itself."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, bwd = lib.fused_block_attn_fwd_f32, lib.fused_block_attn_bwd_f32
    fwd.argtypes = [p] * 9 + [i] * 5 + [f, i, p]
    bwd.argtypes = [p] * 14 + [i] * 5 + [f, i, p]
    fwd.restype = bwd.restype = ctypes.c_int
    floats = lib.fused_block_attn_f32_scratch_floats
    floats.argtypes, floats.restype = [i] * 6, ctypes.c_longlong

    def scratch(x, backward, inner):
        b, n, d = x.shape
        return torch.empty((floats(int(backward), b, n, d, inner, heads),), dtype=torch.float32, device=x.device)

    def forward(x, types, g1, g2, wq, wkv, wo):
        b, n, d = x.shape
        inner = wq.shape[0]
        y = torch.empty_like(x)
        ws = scratch(x, False, inner)
        err = fwd(*[t.data_ptr() for t in (x, types, g1, g2, wq, wkv, wo, y, ws)], b, n, d, heads, inner // heads,
                  (inner // heads) ** -0.5, fusion, torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(err, "fused_block_attn f32")
        return (y,)

    def backward(x, types, g1, g2, wq, wkv, wo, dy):
        b, n, d = x.shape
        inner = wq.shape[0]
        dx, dg1, dg2, dwo = torch.empty_like(x), torch.empty_like(g1), torch.empty_like(g2), torch.empty_like(wo)
        dw_qkv = torch.empty((3 * inner, d), dtype=x.dtype, device=x.device)
        ws = scratch(x, True, inner)
        err = bwd(*[t.data_ptr() for t in (x, types, g1, g2, wq, wkv, wo, dy, dx, dg1, dg2, dw_qkv, dwo, ws)], b, n, d,
                  heads, inner // heads, (inner // heads) ** -0.5, fusion, torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(err, "fused_block_attn_backward f32")
        return dx, dg1, dg2, dw_qkv[:inner], dw_qkv[inner:], dwo

    return forward, backward


def main(argv) -> int:
    f32 = "--f32" in argv
    argv = [a for a in argv if a != "--f32"]
    versions = [tuple(a.split("=", 1)) for a in argv] or [("repo", str(cuda_build.CSRC / "fused_block_attn.cu"))]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = build(versions)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    doms, f = ("s1", "s2", "dem"), 256
    mi = masking.generate_random_masks(torch.Generator().manual_seed(SEED), doms, (f,) * 3, 384, 60, device=dev)
    types = packed_types(mi, 384, f, 3)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(torch.bfloat16)

    x, dy = randn(60, 640, 192), randn(60, 640, 192)
    w = ((1 + 0.1 * torch.randn(192, device=dev, generator=g)).to(torch.bfloat16),
         (1 + 0.1 * torch.randn(192, device=dev, generator=g)).to(torch.bfloat16),
         randn(192, 192, scale=192 ** -0.5), randn(384, 192, scale=192 ** -0.5), randn(192, 192, scale=192 ** -0.5))
    names = {"forward": ("y",), "backward": GRADS}
    if f32:
        x, dy, w = x.float(), dy.float(), tuple(t.float() for t in w)
        want64 = {"forward": (cuda_block_attn.fused_block_attn_reference(x.double(), types, *(t.double() for t in w),
                                                                         3, 3),),
                  "backward": cuda_block_attn.fused_block_attn_backward_reference(
                      x.double(), types, *(t.double() for t in w), dy.double(), 3, 3)}
    want = {"forward": (cuda_block_attn.fused_block_attn_reference(x, types, *w, 3, 3),),
            "backward": cuda_block_attn.fused_block_attn_backward_reference(x, types, *w, dy, 3, 3)}
    if f32:
        for name in ("forward", "backward"):
            print(f"plain f32 {name:8s} vs f64: " + " ".join(f"{o} {rel64(a, b):.3g}" for o, a, b in zip(
                names[name], want[name], want64[name])), flush=True)
    order = [label for label, _ in versions]
    for pass_no, labels in enumerate((order, order[::-1])):
        for label in labels:
            forward, backward = (callers_f32 if f32 else callers)(libs[label], 3, 3)
            for name, run in (("forward", lambda: forward(x, types, *w)),
                              ("backward", lambda: backward(x, types, *w, dy))):
                got = run()
                err = max(rel_l2(a, b) for a, b in zip(got, want[name]))
                ms, _, per_name = profiled_ms(run, own=OWN_F32 if f32 else OWN)
                split = " + ".join(f"{kernel_name(k)} {v:.6g}" for k, v in sorted(per_name.items()))
                acc = ""
                if f32:
                    errs = [rel64(a, b) for a, b in zip(got, want64[name])]
                    acc = (f" vs f64 {max(errs):.3g} (" + " ".join(f"{o} {e:.3g}" for o, e in zip(names[name], errs))
                           + ")")
                print(f"pass {pass_no} {label:12s} {name:8s} rel_l2 {err:.3g}{acc} device {ms:.6g} ms ({split}) "
                      f"events {cuda_ms(run):.6g} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
