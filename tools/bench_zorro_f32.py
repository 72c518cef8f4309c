"""Times versions of K1 / K1b's f32 instance (csrc/zorro_attention_f32.cuh)
against each other in one process on one GPU.

Each argument is ``label=path`` to a version of zorro_attention_f32.cuh
(default: the repo's own, labelled ``repo``). Each is compiled, in parallel,
into its own build of zorro_attention.cu (a copy of csrc/ with that header in
place, the port's build flags, under ``build/bench_zorro_f32/``); its f32
entries are then bound in place of the repo's and called through
``ops.cuda_attn``'s wrappers on chip_smoke.py's phase-3 f32 shapes: N = 640,
B = 60 with the pretraining masks, N = 1024, B = 30 and B = 1 with every
modality, and the decoder's unmasked n = 256, 8 x 32, B = 60. For each
version and shape it prints the largest relative L2 error against the f32
plain version (TF32 off) and the device time of one call, forward and
backward (torch.profiler: the kernels whose name holds
``zorro_attention_f32``, mean of 10 calls after 3 warm-ups, split by
kernel); the versions run in the order given, then again in reverse.

    python3 tools/bench_zorro_f32.py [label=path.cuh ...]

Needs a CUDA card and nvcc; imports nothing of the JAX package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import SEED, kernel_name, packed_types, profiled_ms, rel_l2
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_attn, cuda_build, masking

OUT = cuda_build.BUILD_DIR.parent / "bench_zorro_f32"
HEADER = "zorro_attention_f32.cuh"


def build(versions):
    """{label: loaded library}, the copies compiled in parallel."""
    jobs = []
    for label, path in versions:
        src = open(path, "rb").read()
        tree = OUT / f"{label}-{hashlib.sha256(src).hexdigest()[:12]}"
        tree.mkdir(parents=True, exist_ok=True)
        for name in os.listdir(cuda_build.CSRC):
            if name.endswith((".cuh", ".cu")) and name != HEADER:
                shutil.copy(cuda_build.CSRC / name, tree / name)
        (tree / HEADER).write_bytes(src)
        lib = tree / "zorro_attention.so"
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(tree / "zorro_attention.cu")]
        jobs.append((label, lib, subprocess.Popen(cmd)))
    libs = {}
    for label, lib, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {label}")
        libs[label] = ctypes.CDLL(str(lib))
    return libs


def use(lib, argtypes):
    """Binds cuda_attn's f32 entries to ``lib``'s (``argtypes``: the
    forward's and the backward's, as the repo's library declares them)."""
    fwd, bwd = lib.zorro_attention_f32, lib.zorro_attention_bwd_f32
    fwd.argtypes, bwd.argtypes = argtypes
    fwd.restype = bwd.restype = ctypes.c_int
    cuda_attn._forward_entry = lambda dtype: fwd
    cuda_attn._backward_entry = lambda dtype: bwd


def main(argv) -> int:
    versions = [tuple(a.split("=", 1)) for a in argv] or [("repo", str(cuda_build.CSRC / HEADER))]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    argtypes = (cuda_attn._forward_entry(torch.float32).argtypes, cuda_attn._backward_entry(torch.float32).argtypes)
    libs = build(versions)
    g = torch.Generator(device=dev).manual_seed(SEED)
    doms, f = ("s1", "s2", "dem"), 256
    mi = masking.generate_random_masks(torch.Generator().manual_seed(SEED), doms, (f,) * 3, 384, 60, device=dev)
    every = {d: torch.zeros((30, f), device=dev) for d in doms}
    all_types = packed_types(masking.mask_info_from_task_masks(every, doms, 3 * f), 3 * f, f, 3)
    shapes = [("N=640 B=60 train masks", torch.randn(60, 640, 576, device=dev, generator=g), 3,
               packed_types(mi, 384, f, 3)),
              ("N=1024 B=30 all", torch.randn(30, 1024, 576, device=dev, generator=g), 3, all_types),
              ("N=1024 B=1 all", torch.randn(1, 1024, 576, device=dev, generator=g), 3, all_types[:1]),
              ("n=256 8x32 B=60", torch.randn(60, 256, 768, device=dev, generator=g), 8, None)]
    cases = []
    for label, qkv, heads, types in shapes:
        ref, ref_lse = cuda_attn.zorro_attention_qkv_reference(qkv, heads, types, 3, return_lse=True)
        do = torch.randn(*ref.shape, device=dev, generator=g)
        ref_d = cuda_attn.zorro_attention_qkv_backward_reference(qkv, types, ref, ref_lse, do, heads, 3)
        cases.append((label, qkv, heads, types, do, ref, ref_d))
    order = [label for label, _ in versions]
    for pass_no, labels in enumerate((order, order[::-1])):
        for label in labels:
            use(libs[label], argtypes)
            for shape, qkv, heads, types, do, ref, ref_d in cases:
                out, lse = cuda_attn.zorro_attention_qkv(qkv, heads, types, 3, return_lse=True)
                runs = (("forward", lambda: cuda_attn.zorro_attention_qkv(qkv, heads, types, 3), (ref,)),
                        ("backward", lambda: cuda_attn.zorro_attention_qkv_backward(qkv, types, out, lse, do,
                                                                                    heads, 3),
                         ref_d.chunk(3, dim=-1)))
                for name, run, want in runs:
                    got = run()
                    got = got.chunk(3, dim=-1) if name == "backward" else (got,)
                    err = max(rel_l2(a, b) for a, b in zip(got, want))
                    ms, _, per_name = profiled_ms(run, own="zorro_attention_f32")
                    split = " + ".join(f"{kernel_name(k)} {v:.6g}" for k, v in sorted(per_name.items()))
                    print(f"pass {pass_no} {label:10s} {shape:24s} {name:8s} rel_l2 {err:.3g} device {ms:.6g} ms "
                          f"({split})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
