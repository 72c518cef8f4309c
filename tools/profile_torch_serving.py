"""Where the time of the PyTorch port's serving forward goes, on one GPU.

Drives the model and the request kinds of chip_smoke.py (full-width
``tiny``, seeded random weights, bf16), plus one all-modality request at
B = LARGE_BATCH, with the hand-written kernels (attn_impl='auto') and with
the plain PyTorch path ('xla'), and prints per request kind:
  * wall ms per forward, p50 of 10 without the profiler (host clock around
    work ending in torch.cuda.synchronize());
  * device ms per forward: the sum of the device kernels' and copies'
    durations from torch.profiler over 5 forwards, and how many there were;
  * busy share = device ms / wall ms (one stream, so the sum is the busy
    time), and the top device kernels.

    python3 tools/profile_torch_serving.py

Needs a CUDA card; imports nothing of the JAX package.
"""
from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import SEED, device_breakdown, serve_request, serving_model, serving_requests
from incomplete_multimodal_fusion_tpu_torch import serving
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_build

LARGE_BATCH = 32  # batch back-filling of archives: the card near its load


def wall_p50(fn, reps=10, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all()
    model = serving_model(torch.device("cuda", 0))
    closure = serving.infer_closure(model, None, model.in_domains)
    rng = np.random.default_rng(SEED)
    reqs = {kind: run for kind, (run, _) in serving_requests(model, closure, rng).items()}
    reqs[f"B={LARGE_BATCH} all modalities (N=1024)"] = serve_request(
        model, closure, rng, LARGE_BATCH, ())[0]
    print(f"card: {torch.cuda.get_device_name(0)}")
    for mode in ("auto", "xla"):
        model.attn_impl = mode
        for kind, fn in reqs.items():
            wall = wall_p50(fn)
            dev, n_kernels, _, top = device_breakdown(fn)
            print(f"== attn_impl={mode} {kind}: wall p50 {wall:.3f} ms, device {dev:.3f} ms "
                  f"in {n_kernels:.0f} kernels/copies, busy {dev / wall:.3f}", flush=True)
            for name, ms in top:
                print(f"     {ms:8.4f} ms  {name[:100]}")


if __name__ == "__main__":
    main()
