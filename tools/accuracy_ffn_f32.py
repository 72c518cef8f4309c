"""How far versions of K2 / K2b's f32 instance (csrc/fused_ffn.cu,
csrc/fused_ffn_bwd.cu) stray from an f64 computation of the same function,
on the model's own activations: the inputs of every FFN call (GEGLU and
MLP) of one forward of chip_smoke.py phase 9's f32 pretraining step
(PretrainConfig(), B = 60, seeded weights, batch and masks), each with a
seeded output gradient.

Each argument is ``label=tree``, a source tree whose two f32 FFN libraries
are built and called as tools/bench_ffn_f32.py does (default: this tree);
``ffma=TREE`` with a tree from before the tensor-core instance gives the
FFMA chain. For each mode, version and the f32 plain version (TF32 off) the
script prints the relative L2 error of the output and of every gradient
against the f64 plain version, the worst over the calls, and each version's
worst against the f32 plain version (the comparison chip_smoke.py holds to
1e-5).

    python3 tools/accuracy_ffn_f32.py [label=tree ...]

Needs a CUDA card and nvcc; imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.config import PretrainConfig  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_ffn, masking  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.train import pretrain  # noqa: E402

_spec = importlib.util.spec_from_file_location("bench_ffn_f32", os.path.join(ROOT, "tools", "bench_ffn_f32.py"))
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)

# (version method forward, backward, plain forward, plain backward, names of the outputs)
MODES = {"geglu": ("geglu", "geglu_bwd", cuda_ffn.geglu_ffn_reference, cuda_ffn.geglu_ffn_backward_reference,
                   ("y", "dx", "dgamma", "dW_in", "dW_out")),
         "mlp": ("mlp", "mlp_bwd", cuda_ffn.mlp_ffn_reference, cuda_ffn.mlp_ffn_backward_reference,
                 ("y", "dx", "dW1", "db1", "dW2", "db2"))}


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def phase9_calls(dev):
    """{mode: [operands]} of every FFN call of one forward of phase 9's f32
    step (the task axis's MLP split into its tasks), recorded as the model
    makes them."""
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
    calls = {"geglu": [], "mlp": []}
    originals = {name: getattr(cuda_ffn, name) for name in ("geglu_ffn", "mlp_ffn", "mlp_ffn_tasks")}

    def recorder(name):
        def call(*args):
            ops = [a.detach().clone() for a in args]
            if name == "mlp_ffn_tasks":
                calls["mlp"].extend([[v[t] for v in ops] for t in range(ops[0].shape[0])])
            else:
                calls["geglu" if name == "geglu_ffn" else "mlp"].append(ops)
            return originals[name](*args)
        return call

    for name in originals:
        setattr(cuda_ffn, name, recorder(name))
    try:
        with torch.no_grad():
            pretrain.make_loss_fn(model, cfg)(dict(model.named_parameters()), batch, mi)
    finally:
        for name, fn in originals.items():
            setattr(cuda_ffn, name, fn)
    return calls


def main(argv) -> int:
    dev = torch.device("cuda", 0)
    smoke.phase_device()  # TF32 off
    trees = [a.split("=", 1) for a in argv] or [["repo", ROOT]]
    calls = phase9_calls(dev)
    print("[accuracy] FFN calls of one f32 step's forward: "
          + ", ".join(f"{m} {len(c)} (M = {sorted({ops[0].shape[0] for ops in c})})" for m, c in calls.items()),
          flush=True)
    g = torch.Generator(device=dev).manual_seed(smoke.SEED + 17)
    with tempfile.TemporaryDirectory() as tmp:
        versions = {label: bench.Version(bench.build(os.path.abspath(tree), tmp)) for label, tree in trees}
        for mode, (fwd, bwd, plain_fwd, plain_bwd, names) in MODES.items():
            rows = {"plain f32": [], **{label: [] for label in versions}}
            for ops in calls[mode]:
                d_out = ops[3].shape[0] if mode == "mlp" else ops[0].shape[1]
                dy = torch.randn(ops[0].shape[0], d_out, device=dev, generator=g)
                ref64 = [plain_fwd(*(v.double() for v in ops)), *plain_bwd(*(v.double() for v in ops), dy.double())]
                ref32 = [plain_fwd(*ops), *plain_bwd(*ops, dy)]
                rows["plain f32"].append(([rel(a, b) for a, b in zip(ref32, ref64)], 0.0))
                for label, version in versions.items():
                    got = [getattr(version, fwd)(*ops), *getattr(version, bwd)(*ops, dy)]
                    rows[label].append(([rel(a, b) for a, b in zip(got, ref64)],
                                        max(rel(a, b) for a, b in zip(got, ref32))))
            for label, rs in rows.items():
                vs64 = np.array([r[0] for r in rs]).max(axis=0)
                print(f"[accuracy] {mode:5s} {label:10s} vs f64, worst over {len(rs)} calls: "
                      + " ".join(f"{n} {e:.3g}" for n, e in zip(names, vs64))
                      + (f"; worst vs f32 plain {max(r[1] for r in rs):.3g}" if label != "plain f32" else ""),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
