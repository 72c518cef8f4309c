"""How far versions of K1 / K1b's f32 instance (csrc/zorro_attention_f32.cuh)
stray from an f64 computation of the same function, on the model's own
activations: the qkv slabs of the 12 encoder blocks of chip_smoke.py phase
9's f32 pretraining step (PretrainConfig(), B = 60, N = 640, seeded weights,
batch and masks), with phase 9's seeded output gradient.

Each argument is ``label=path`` to a version of zorro_attention_f32.cuh
(default: the repo's own), built as tools/bench_zorro_f32.py builds them.
For the dense mode (K1 / K1b as the model calls them) and the tile-skip
mode, the script prints, for each version and for the f32 plain version (TF32
off), the relative L2 error of O, dQ, dK and dV against the f64 plain
version, the worst over the slabs, and each slab's worst against the f32
plain version (the comparison chip_smoke.py holds to 1e-5).

    python3 tools/accuracy_zorro_f32.py [label=path.cuh ...]

Needs a CUDA card and nvcc; imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.config import PretrainConfig  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_attn, cuda_build, cuda_zorro_sparse, masking  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.train import pretrain  # noqa: E402

_spec = importlib.util.spec_from_file_location("bench_zorro_f32", os.path.join(ROOT, "tools", "bench_zorro_f32.py"))
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)

MODES = {  # (forward, backward, plain forward, plain backward) of each mode, as f(qkv, heads, types, ...)
    "dense": (cuda_attn.zorro_attention_qkv, cuda_attn.zorro_attention_qkv_backward,
              cuda_attn.zorro_attention_qkv_reference, cuda_attn.zorro_attention_qkv_backward_reference),
    "tile-skip": (lambda qkv, h, t, f, **kw: cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv, t, h, f, **kw),
                  cuda_zorro_sparse.zorro_sparse_attention_qkv_backward,
                  lambda qkv, h, t, f, **kw: cuda_zorro_sparse.zorro_sparse_attention_qkv_reference(qkv, t, h, f,
                                                                                                    **kw),
                  cuda_zorro_sparse.zorro_sparse_attention_qkv_backward_reference),
}


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def errors(o, d, ref_o, ref_d):
    """Relative L2 errors of (O, dQ, dK, dV)."""
    return [rel(o, ref_o)] + [rel(a, b) for a, b in zip(d.chunk(3, dim=-1), ref_d.chunk(3, dim=-1))]


def phase9_slabs(dev):
    """Phase 9's qkv slabs and types, its heads and fusion type, and its
    seeded output gradients."""
    cfg = PretrainConfig()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    doms = tuple(cfg.data.in_domains)
    b = cfg.data.batch_size
    model, _, _ = pretrain.create_train_state(cfg, smoke.SEED, total_steps=1000, device=dev)
    batch = {d: torch.from_numpy(v).to(dev)
             for d, v in smoke.synthetic_batch(np.random.default_rng(smoke.SEED), doms, b,
                                               cfg.data.input_size).items()}
    mi = masking.generate_random_masks(torch.Generator().manual_seed(smoke.SEED), doms,
                                       (cfg.data.num_patches,) * len(doms), cfg.mask.num_encoded_tokens, b,
                                       device=dev)
    slabs = smoke.capture_qkv_slabs(model, pretrain.make_loss_fn(model, cfg), batch, mi)
    g = torch.Generator(device=dev).manual_seed(smoke.SEED + 9)
    dos = [torch.randn(q.shape[0], q.shape[1], q.shape[2] // 3, device=dev, generator=g) for q, _ in slabs]
    return slabs, model.blocks[0].attn.heads, model.fusion_type, dos


def main(argv) -> int:
    versions = [tuple(a.split("=", 1)) for a in argv] or [("repo", str(cuda_build.CSRC / bench.HEADER))]
    dev = torch.device("cuda", 0)
    smoke.phase_device()  # TF32 off
    argtypes = (cuda_attn._forward_entry(torch.float32).argtypes, cuda_attn._backward_entry(torch.float32).argtypes)
    libs = bench.build(versions)
    slabs, heads, fusion, dos = phase9_slabs(dev)
    for mode, (fwd, bwd, plain_fwd, plain_bwd) in MODES.items():
        refs = []
        for (qkv, types), do in zip(slabs, dos):
            o64, lse64 = plain_fwd(qkv.double(), heads, types, fusion, return_lse=True)
            o32, lse32 = plain_fwd(qkv, heads, types, fusion, return_lse=True)
            refs.append((o64, plain_bwd(qkv.double(), types, o64, lse64, do.double(), heads, fusion), o32,
                         plain_bwd(qkv, types, o32, lse32, do, heads, fusion)))
        rows = {"plain f32": [(errors(o32, d32, o64, d64), [0.0] * 4) for o64, d64, o32, d32 in refs]}
        for label, _ in versions:
            bench.use(libs[label], argtypes)
            rows[label] = []
            for (qkv, types), do, (o64, d64, o32, d32) in zip(slabs, dos, refs):
                o, lse = fwd(qkv, heads, types, fusion, return_lse=True)
                d = bwd(qkv, types, o, lse, do, heads, fusion)
                rows[label].append((errors(o, d, o64, d64), errors(o, d, o32, d32)))
        for label, rs in rows.items():
            vs64 = np.array([r[0] for r in rs]).max(axis=0)
            vs32 = [max(r[1]) for r in rs]
            print(f"[accuracy] {mode:9s} {label:10s} vs f64, worst over the slabs: O {vs64[0]:.3g} dQ {vs64[1]:.3g} "
                  f"dK {vs64[2]:.3g} dV {vs64[3]:.3g}; each slab's worst vs f32 plain: "
                  + " ".join(f"{x:.3g}" for x in vs32), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
