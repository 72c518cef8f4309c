"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the
hand-written CUDA kernels from ``incomplete_multimodal_fusion_tpu_torch/
csrc/`` with nvcc, holds each against its plain PyTorch version at the
serving shapes, then drives the full-width ``tiny`` MultiMAE (PretrainConfig
defaults, seeded random weights, bf16) through the serving entry points and
checks what comes out.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. device   -- the card's name and power limit; fails without CUDA.
  2. build    -- nvcc for sm_90a into build/kernels/, timed.
  3. kernels  -- each kernel against its plain version in bf16 at the
                 slice's shapes: max abs error and relative L2 error (bound
                 KERNEL_REL_L2), kernel and plain times (CUDA events, median
                 of 20 after warm-up).
  4. serving  -- four requests through serving.infer_closure / infer.infer:
                 launch counts per forward, finite outputs, invariance to
                 the pixels the request drops or masks, relative L2 against
                 the plain path (attn_impl='xla') on the card (bound
                 SERVING_REL_L2), p50 latency per request kind.
Prints one JSON line of per-kernel results, the card's nvidia-smi line, and
last the JSON device line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from incomplete_multimodal_fusion_tpu_torch import infer, ops, serving
from incomplete_multimodal_fusion_tpu_torch.config import PretrainConfig
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch
from incomplete_multimodal_fusion_tpu_torch.models.multimae import build_multimae
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_attn, cuda_build, cuda_ffn, cuda_fusion_attn
from incomplete_multimodal_fusion_tpu_torch.ops import masking
from incomplete_multimodal_fusion_tpu_torch.ops.attention import packed_token_types, packed_valid

KERNEL_REL_L2 = 2e-2  # bf16 kernel vs bf16 plain version, same inputs
SERVING_REL_L2 = 5e-2  # whole bf16 forward, kernels vs plain path
SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "incomplete_multimodal_fusion_tpu_torch"


def log(*args):
    print(*args, flush=True)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke runs only on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    t0 = time.time()
    paths = cuda_build.build_all()
    for s in cuda_build.SOURCES:  # load (and bind) every library now
        cuda_build.load(s)
    log(f"[build] {len(paths)} kernel libraries in {time.time() - t0:.2f} s: "
        + ", ".join(os.path.relpath(p, ROOT) for p in paths))


def packed_types(mi: masking.MaskInfo, e: int, f: int, n_dom: int) -> torch.Tensor:
    """The PAD-coded token types the model hands kernel K1 (multimae.forward)."""
    types = packed_token_types(mi.order, (f,) * n_dom, e, f, n_dom)
    valid = packed_valid(mi.num_visible, e, f)
    return torch.where(valid, types, torch.full_like(types, cuda_attn.PAD_TYPE))


def phase_kernels(dev):
    """Each kernel against its plain version at the serving shapes."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    doms, f = ("s1", "s2", "dem"), 256

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(bf)

    def drop_types(b, dropped):
        masks = {d: torch.full((b, f), int(d in dropped), device=dev) for d in doms}
        return packed_types(masking.mask_info_from_task_masks(masks, doms, 3 * f), 3 * f, f, 3)

    rand_mi = masking.generate_random_masks(torch.Generator().manual_seed(SEED), doms, (f,) * 3,
                                            256, 8, batch_shared=False, device=dev)
    d, inner_ff, dd, hid = 192, 512, 256, 1024
    w_in, w_out = randn(2 * inner_ff, d, scale=d ** -0.5), randn(d, inner_ff, scale=inner_ff ** -0.5)
    gamma = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(bf)
    w1, b1 = randn(hid, dd, scale=dd ** -0.5), randn(hid, scale=0.1)
    w2, b2 = randn(dd, hid, scale=hid ** -0.5), randn(dd, scale=0.1)

    # (entry, shape label, kernel call, plain call, main shape of the entry?)
    cases = []
    for label, b, types in (("N=1024 B=1 all modalities", 1, drop_types(1, ())),
                            ("N=1024 B=1 dem dropped", 1, drop_types(1, ("dem",))),
                            ("N=1024 B=4 s2 dropped", 4, drop_types(4, ("s2",))),
                            ("N=512 B=8 random masks e=256", 8, packed_types(rand_mi, 256, f, 3))):
        qkv = randn(b, types.shape[1], 3 * 192)
        cases.append(("zorro_attention_qkv/zorro", label,
                      lambda qkv=qkv, t=types: cuda_attn.zorro_attention_qkv(qkv, 3, t, 3),
                      lambda qkv=qkv, t=types: cuda_attn.zorro_attention_qkv_reference(qkv, 3, t, 3),
                      b == 1 and "all" in label))
    for b in (1, 8):
        qkv = randn(b, 256, 3 * 256)
        cases.append(("zorro_attention_qkv/none", f"n=256 8x32 B={b}",
                      lambda qkv=qkv: cuda_attn.zorro_attention_qkv(qkv, 8),
                      lambda qkv=qkv: cuda_attn.zorro_attention_qkv_reference(qkv, 8), b == 8))
    for m in (1024, 256, 4096):
        x = randn(m, d)
        cases.append(("fused_ffn/geglu", f"M={m} d=192 I=512",
                      lambda x=x: cuda_ffn.geglu_ffn(x, gamma, w_in, w_out),
                      lambda x=x: cuda_ffn.geglu_ffn_reference(x, gamma, w_in, w_out), m == 1024))
    for m in (256, 2048):
        x = randn(m, dd)
        cases.append(("fused_ffn/mlp", f"M={m} d=256 H=1024",
                      lambda x=x: cuda_ffn.mlp_ffn(x, w1, b1, w2, b2),
                      lambda x=x: cuda_ffn.mlp_ffn_reference(x, w1, b1, w2, b2), m == 2048))
    for b in (1, 8):
        q, kvg, kvf = randn(b, f, 192), randn(b, 3 * f, 384), randn(b, f, 384)
        cases.append(("fusion_row_attention/fusion_row", f"F=256 T=3 3x64 B={b}",
                      lambda q=q, kvg=kvg, kvf=kvf: cuda_fusion_attn.fusion_row_attention(
                          q, kvg, kvf, 3, 64),
                      lambda q=q, kvg=kvg, kvf=kvf: cuda_fusion_attn.fusion_row_attention_reference(
                          q, kvg, kvf, 3, 64), b == 8))

    results = {}
    for entry, label, kernel, plain, main in cases:
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise RuntimeError(f"[kernels] {entry} {label}: bad output {tuple(out.shape)}")
        err = float((out.float() - ref.float()).abs().max())
        rel = rel_l2(out, ref)
        ms_k = cuda_ms(kernel)
        ms_p = cuda_ms(plain)
        log(f"[kernels] {entry:32s} {label:30s} max_abs_err {err:.6g} rel_l2 {rel:.6g} "
            f"kernel {ms_k:.6g} ms plain {ms_p:.6g} ms")
        if not rel <= KERNEL_REL_L2:
            raise RuntimeError(f"[kernels] {entry} {label}: rel L2 {rel} > {KERNEL_REL_L2}")
        r = results.setdefault(entry, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            r.update(ms=ms_k, plain_ms=ms_p, shape=label)
    return results


PER_FORWARD = {"zorro_attention_qkv/zorro": 12, "zorro_attention_qkv/none": 6,
               "fused_ffn/geglu": 24, "fused_ffn/mlp": 6, "fusion_row_attention/fusion_row": 12}


def serving_model(dev):
    """The full-width ``tiny`` MultiMAE (PretrainConfig defaults), seeded
    random weights, bf16 on ``dev``."""
    model = build_multimae(PretrainConfig()).init_weights(torch.Generator().manual_seed(SEED))
    return model.to(device=dev, dtype=torch.bfloat16).eval()


def serve_request(model, closure, rng, b, dropped):
    """A serving request at full capacity with ``dropped`` modalities masked
    out; returns ``(run, perturbed)``: ``run(x)`` answers it, ``perturbed()``
    gives its rasters with the dropped pixels changed (None if none)."""
    doms, n = model.in_domains, model.num_patches
    x = synthetic_batch(rng, doms, b, model.image_size)
    masks = {d: np.full((b, n), int(d in dropped), np.int64) for d in doms}

    def run(x=x):
        out = closure(*[x[d] for d in doms], *[masks[d] for d in doms])
        return out["preds"], out["pooled"]

    def perturbed():
        return {d: (v * 0.0 + 123.0 if d in dropped else v) for d, v in x.items()}

    return run, (perturbed if dropped else None)


def random_request(model, rng, b, e):
    """An infer_mmae-style request with seeded random masks of ``e``
    visible tokens; ``perturbed()`` changes the pixels of every masked patch."""
    x = synthetic_batch(rng, model.in_domains, b, model.image_size)
    p, side = model.patch_size, model.image_size // model.patch_size

    def run(x=x):
        res = infer.infer(model, None, x, e, generator=torch.Generator().manual_seed(SEED))
        return res.preds, res.pooled

    def perturbed():
        res = infer.infer(model, None, x, e, generator=torch.Generator().manual_seed(SEED))
        out = {}
        for d, v in x.items():
            m = res.task_masks[d].cpu().numpy().reshape(b, side, side)
            m = np.repeat(np.repeat(m, p, axis=1), p, axis=2)[..., None]
            out[d] = np.where(m == 1, 123.0, v).astype(np.float32)
        return out

    return run, perturbed


def serving_requests(model, closure, rng):
    """The smoke's four request kinds, each as ``(run, perturbed)``."""
    return {
        "B=1 all modalities (N=1024)": serve_request(model, closure, rng, 1, ()),
        "B=1 dem dropped (N=1024)": serve_request(model, closure, rng, 1, ("dem",)),
        "B=4 s2 dropped (N=1024)": serve_request(model, closure, rng, 4, ("s2",)),
        "B=8 random masks e=256 (N=512)": random_request(model, rng, 8, 256),
    }


def phase_serving(dev):
    model = serving_model(dev)
    closure = serving.infer_closure(model, None, model.in_domains)
    requests = serving_requests(model, closure, np.random.default_rng(SEED))

    # the main path's run: every request once, launch counters from 0
    ops.reset_kernel_launches()
    outputs, per_request = {}, {}
    for kind, (run, _) in requests.items():
        before = ops.kernel_launches()
        outputs[kind] = run()
        torch.cuda.synchronize()
        after = ops.kernel_launches()
        per_request[kind] = {k: after[k] - before[k] for k in after}
    launches = ops.kernel_launches()
    log(f"[serving] launches in the main-path run: {launches}")
    for kind, counts in per_request.items():
        if counts != PER_FORWARD:
            raise RuntimeError(f"[serving] {kind}: launches per forward {counts}, "
                               f"expected {PER_FORWARD}")

    for kind, (run, perturbed) in requests.items():
        preds, pooled = outputs[kind]
        for d, p in preds.items():
            if not torch.isfinite(p).all():
                raise RuntimeError(f"[serving] {kind}: non-finite preds[{d}]")
        if not torch.isfinite(pooled).all():
            raise RuntimeError(f"[serving] {kind}: non-finite pooled")
        worst_inv = 0.0
        if perturbed is not None:
            preds2, pooled2 = run(perturbed())
            worst_inv = max([float((preds[d].float() - preds2[d].float()).abs().max())
                             for d in preds] + [float((pooled.float() - pooled2.float()).abs().max())])
            if not worst_inv <= 1e-6:
                raise RuntimeError(f"[serving] {kind}: output moved by {worst_inv} with dropped pixels")
        model.attn_impl = "xla"
        preds_p, pooled_p = run()
        model.attn_impl = "auto"
        rel = max([rel_l2(preds[d], preds_p[d]) for d in preds] + [rel_l2(pooled, pooled_p)])
        if not rel <= SERVING_REL_L2:
            raise RuntimeError(f"[serving] {kind}: rel L2 vs plain path {rel} > {SERVING_REL_L2}")
        lat = []
        for _ in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        model.attn_impl = "xla"
        lat_p = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            lat_p.append((time.perf_counter() - t0) * 1e3)
        model.attn_impl = "auto"
        log(f"[serving] {kind:32s} finite ok, dropped-pixel max change {worst_inv:.3g}, "
            f"rel_l2 vs plain path {rel:.6g}, p50 {statistics.median(lat[3:]):.6g} ms "
            f"(plain path p50 {statistics.median(lat_p[2:]):.6g} ms)")
    return launches


REPLACES = {
    "zorro_attention_qkv/zorro": ("csrc/zorro_attention.cu",
                                  "incomplete_multimodal_fusion_tpu/ops/pallas_attn.py:707"),
    "zorro_attention_qkv/none": ("csrc/zorro_attention.cu",
                                 "incomplete_multimodal_fusion_tpu/ops/pallas_small_attn.py:136"),
    "fused_ffn/geglu": ("csrc/fused_ffn.cu", "incomplete_multimodal_fusion_tpu/ops/pallas_ffn.py:200"),
    "fused_ffn/mlp": ("csrc/fused_ffn.cu", "incomplete_multimodal_fusion_tpu/ops/pallas_ffn.py:374"),
    "fusion_row_attention/fusion_row": ("csrc/fusion_row_attention.cu",
                                        "incomplete_multimodal_fusion_tpu/ops/pallas_fusion_attn.py:171"),
}


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernel_results = phase_kernels(dev)
    launches = phase_serving(dev)
    entries = []
    for name, (src, replaces) in REPLACES.items():
        r = kernel_results[name]
        if launches[name] <= 0:
            raise RuntimeError(f"{name} was not launched by the main path")
        entries.append({"name": name, "route": "cuda", "source": f"{PKG}/{src}",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "shape": r["shape"]})
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
