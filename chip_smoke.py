"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the
hand-written CUDA kernels from ``incomplete_multimodal_fusion_tpu_torch/
csrc/`` with nvcc, holds each, forward and backward, against its plain
PyTorch version at the shapes of the model, then drives the full-width
``tiny`` MultiMAE (PretrainConfig defaults, seeded random weights) through
the serving entry points (bf16) and through the pretraining step (bf16
compute over f32 master weights, B = 60), and the full-width downstream
MaskFormer (MaskFormerConfig defaults, seeded random weights, bf16 backbone
and f32 head) through the segmentation entry points, and checks what comes
out.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. device   -- the card's name and power limit; fails without CUDA.
  2. build    -- nvcc for sm_90a into build/kernels/, all sources in
                 parallel, timed.
  3. kernels  -- each kernel against its plain version in bf16 (K4 in f32)
                 at the serving, training and segmentation shapes: max abs
                 error and relative L2 error (bound KERNEL_REL_L2, K4
                 MSDA_REL_L2), kernel, plain and library times
                 (CUDA events, median of 20 after warm-up) and the least time
                 the card could take (bound_ms, from the bytes and operations
                 of these inputs).
  4. serving  -- four requests through serving.infer_closure / infer.infer:
                 launch counts per forward, finite outputs, invariance to
                 the pixels the request drops or masks, relative L2 against
                 the plain path (attn_impl='xla') on the card (bound
                 SERVING_REL_L2), p50 latency per request kind.
  5. train    -- train.pretrain.create_train_state / make_train_step at
                 B = 60: loss and gradients of the kernel path against the
                 plain path on one set of masks (bounds TRAIN_LOSS_REL,
                 TRAIN_GRAD_REL_L2), exact launch counts per step, 3 warm-up
                 and 10 timed steps (finite loss, weights moved, optimizer
                 count advanced), p50 step time of both paths, host time of
                 the mask sampling, peak device memory.
  6. segment  -- four requests through infer_segmentation.
                 forward_segmentation / forward_instance_segmentation
                 (semantic B = 1, semantic B = 1 with dem dropped, instance
                 B = 8, semantic B = 30): exact launch counts per forward,
                 finite outputs, the dem-dropped answer bitwise unmoved by the
                 dem pixels, pred_logits, pred_masks and the class
                 probabilities within SEG_REL_L2 of the plain path, p50 wall
                 time of both paths, images/s at B = 30, peak device memory,
                 and the device time of a forward from the profiler.
Prints one JSON line of per-kernel results, the card's nvidia-smi line, and
last the JSON device line.
"""
from __future__ import annotations

import collections
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from incomplete_multimodal_fusion_tpu_torch import infer, infer_segmentation, ops, serving
from incomplete_multimodal_fusion_tpu_torch.config import PretrainConfig
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch
from incomplete_multimodal_fusion_tpu_torch.models.maskformer import MaskFormerConfig, build_maskformer
from incomplete_multimodal_fusion_tpu_torch.models.msda_module import MSDeformAttn
from incomplete_multimodal_fusion_tpu_torch.models.multimae import build_multimae
from incomplete_multimodal_fusion_tpu_torch.models.pixel_decoder import reference_points_for
from incomplete_multimodal_fusion_tpu_torch.ops import (cuda_attn, cuda_build, cuda_ffn, cuda_fusion_attn,
                                                        cuda_msda)
from incomplete_multimodal_fusion_tpu_torch.ops import masking
from incomplete_multimodal_fusion_tpu_torch.ops.attention import (packed_token_types, packed_valid,
                                                                   zorro_mask_from_padded_types)
from incomplete_multimodal_fusion_tpu_torch.train import pretrain

KERNEL_REL_L2 = 2e-2  # bf16 kernel vs bf16 plain version, same inputs
SERVING_REL_L2 = 5e-2  # whole bf16 forward, kernels vs plain path
# train step, kernels vs plain path on the same weights and masks: bf16
# rounding at other places, and the order of the gathers' scatter-add
# backward on the card varies from run to run
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL_L2 = 5e-2
# K4 in f32 against its f32 plain version: only the order of the sums differs
MSDA_REL_L2 = 1e-4
# segmentation forward (bf16 backbone, f32 head), kernels vs plain path
SEG_REL_L2 = 5e-2
SEED = 0
# an H100 SXM's published peaks (NVIDIA data sheet): dense bf16 tensor-core
# and f32 CUDA-core operations per second, HBM3 bytes per second
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_HBM = 3.35e12
ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "incomplete_multimodal_fusion_tpu_torch"


def log(*args):
    print(*args, flush=True)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative L2 error; a reference that is zero in exact arithmetic (a
    gradient at a single token) is measured against a norm of 1e-3."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-3))


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


HAND_WRITTEN = ("zorro_attention", "fused_ffn", "ffn_bwd", "wgrad", "fusion_row", "ms_deform_attn")
MATMUL_LIBRARY = ("gemm", "cutlass", "xmma", "cublas", "nvjet")


def device_breakdown(fn, reps: int = 5, top_n=8):
    """Device time of one call of ``fn`` from torch.profiler over ``reps``
    calls: total ms of the device kernels and copies (one stream, so their
    sum is the busy time), their count, ms by kind (the hand-written
    kernels, the matmul library, everything else) and the top ``top_n`` by
    name (all of them for None)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_name = collections.Counter()
    count = 0
    for evt in prof.events():
        # device kernels and copies; not the ranges that annotate them
        # (``Optimizer.step`` appears on the device timeline too)
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            per_name[evt.name] += evt.device_time_total
            count += 1
    by_kind = collections.Counter()
    for name, us in per_name.items():
        low = name.lower()
        kind = ("hand-written" if any(k in low for k in HAND_WRITTEN) else
                "matmul library" if any(k in low for k in MATMUL_LIBRARY) else "other")
        by_kind[kind] += us / reps / 1e3
    total = sum(per_name.values()) / reps / 1e3
    top = [(name, us / reps / 1e3) for name, us in per_name.most_common(top_n)]
    return total, count / reps, dict(by_kind), top


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, n_bytes: float, peak: float):
    """The least time in ms the card could take for ``flops`` operations at
    ``peak`` and ``n_bytes`` of device memory traffic, and which bounds it."""
    ops_ms, bytes_ms = flops / peak * 1e3, n_bytes / PEAK_HBM * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


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


def heads_layout(qkv, heads):
    """q, k, v of a fused [B, N, 3I] slab as contiguous [B, H, N, dh], the
    layout scaled_dot_product_attention takes."""
    b, n, three_i = qkv.shape
    return [t.reshape(b, n, heads, -1).transpose(1, 2).contiguous() for t in qkv.chunk(3, dim=-1)]


def sdpa_case(qkv, heads, types, part: str):
    """One PyTorch call computing K1's function (``part`` 'forward'), its
    gradient ('backward', on a retained graph) or both in turn
    ('forward+backward'): scaled_dot_product_attention with the zorro mask
    as a boolean mask, or with none. Timed as library_ms; the port never
    calls it."""
    F = torch.nn.functional
    q, k, v = (t.requires_grad_(part != "forward") for t in heads_layout(qkv, heads))
    mask = None if types is None else zorro_mask_from_padded_types(types, 3, cuda_attn.PAD_TYPE)[:, None]
    if part == "forward":
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    do = torch.randn_like(out)
    if part == "backward":
        return lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    return lambda: torch.autograd.grad(F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                                       (q, k, v), do)


def attention_work(qkv, heads, types, backward: bool):
    """Operations and bytes of K1 (or K1b) on these inputs: 4 (10 backward)
    flops per allowed (query, key) pair and head dim element -- the products
    over pairs the mask allows, what these types need -- against the qkv
    (and o, dO, lse, dqkv) bytes."""
    b, n, three_i = qkv.shape
    dh = three_i // 3 // heads
    pairs = b * n * n if types is None else int(
        zorro_mask_from_padded_types(types, 3, cuda_attn.PAD_TYPE).sum())
    if not backward:
        return 4.0 * pairs * dh * heads, nbytes(qkv) * 4 / 3, PEAK_BF16
    return 10.0 * pairs * dh * heads, nbytes(qkv) * 2 + nbytes(qkv) * 2 / 3 + b * heads * n * 4, PEAK_BF16


MSDA_LEVELS = ((8, 8), (16, 16), (32, 32))  # the pixel decoder's levels at 256^2, low -> high


def msda_inputs(dev, g, b, heads=8, dim=32, points=4, near_reference=False):
    """K4's operands at the pixel decoder's shapes, f32: locations uniform in
    [-0.1, 1.1], or with ``near_reference`` each query's level reference
    point plus N(0, 2 pixels) offsets, as a trained decoder's samples lie."""
    s = sum(h * w for h, w in MSDA_LEVELS)
    l = len(MSDA_LEVELS)
    value = torch.randn(b, s, heads, dim, device=dev, generator=g)
    if near_reference:
        ref = reference_points_for(MSDA_LEVELS, device=dev)[None, :, None, :, None, :]
        size = torch.tensor([[w, h] for h, w in MSDA_LEVELS], dtype=torch.float32, device=dev)
        noise = 2.0 * torch.randn(b, s, heads, l, points, 2, device=dev, generator=g)
        locs = ref + noise / size[None, None, None, :, None, :]
    else:
        locs = -0.1 + 1.2 * torch.rand(b, s, heads, l, points, 2, device=dev, generator=g)
    aw = torch.softmax(torch.randn(b, s, heads, l * points, device=dev, generator=g), dim=-1)
    return value, locs, aw.reshape(b, s, heads, l, points).contiguous()


def msda_work(value, locs, aw):
    """Operations and bytes of K4 on these inputs: 10 f32 operations per
    channel of each sample with a tap inside its level (4 corner products
    and adds, the weighting; a sample wholly outside contributes nothing
    and is not counted), against value, locations, weights and the output
    each moved once."""
    b, s, m, d = value.shape
    live = 0
    for lid, (h, w) in enumerate(MSDA_LEVELS):
        px = locs[:, :, :, lid, :, 0] * w - 0.5
        py = locs[:, :, :, lid, :, 1] * h - 0.5
        live += int(((px > -1) & (px < w) & (py > -1) & (py < h)).sum())
    out_bytes = b * locs.shape[1] * m * d * 4
    return 10.0 * live * d, nbytes(value, locs, aw) + out_bytes, PEAK_F32


def outputs(r):
    return list(r) if isinstance(r, (tuple, list)) else [r]


def phase_kernels(dev):
    """Each kernel, forward and backward, against its plain version at the
    serving and training shapes."""
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
    train_mi = masking.generate_random_masks(torch.Generator().manual_seed(SEED), doms, (f,) * 3,
                                             384, 60, device=dev)
    d, inner_ff, dd, hid = 192, 512, 256, 1024
    w_in, w_out = randn(2 * inner_ff, d, scale=d ** -0.5), randn(d, inner_ff, scale=inner_ff ** -0.5)
    gamma = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(bf)
    w1, b1 = randn(hid, dd, scale=dd ** -0.5), randn(hid, scale=0.1)
    w2, b2 = randn(dd, hid, scale=hid ** -0.5), randn(dd, scale=0.1)
    geglu_w, mlp_w = (gamma, w_in, w_out), (w1, b1, w2, b2)

    # (entry, shape label, kernel call, plain call, (flops, bytes, peak),
    #  library call or None, main shape of the entry?)
    cases = []
    fwd_bwd = {}  # SDPA forward and backward in turn, beside the K1b rows' library_ms

    def zorro_cases(entry_mode, label, qkv, heads, types, main):
        cases.append((f"zorro_attention_qkv/{entry_mode}", label,
                      lambda: cuda_attn.zorro_attention_qkv(qkv, heads, types, 3),
                      lambda: cuda_attn.zorro_attention_qkv_reference(qkv, heads, types, 3),
                      attention_work(qkv, heads, types, False),
                      sdpa_case(qkv, heads, types, "forward"), main))

    def zorro_bwd_cases(entry_mode, label, qkv, heads, types, main):
        o, lse = cuda_attn.zorro_attention_qkv(qkv, heads, types, 3, return_lse=True)
        do = randn(*o.shape)
        entry = f"zorro_attention_qkv/{entry_mode}_backward"
        cases.append((entry, label,
                      lambda: cuda_attn.zorro_attention_qkv_backward(qkv, types, o, lse, do, heads, 3),
                      lambda: cuda_attn.zorro_attention_qkv_backward_reference(qkv, types, o, lse, do,
                                                                               heads, 3),
                      attention_work(qkv, heads, types, True),
                      sdpa_case(qkv, heads, types, "backward"), main))
        fwd_bwd[entry, label] = sdpa_case(qkv, heads, types, "forward+backward")

    # serving shapes (the forward kernels' main shapes in the kernels line)
    for label, b, types in (("N=1024 B=1 all modalities", 1, drop_types(1, ())),
                            ("N=1024 B=1 dem dropped", 1, drop_types(1, ("dem",))),
                            ("N=1024 B=4 s2 dropped", 4, drop_types(4, ("s2",))),
                            ("N=512 B=8 random masks e=256", 8, packed_types(rand_mi, 256, f, 3))):
        zorro_cases("zorro", label, randn(b, types.shape[1], 3 * 192), 3, types,
                    b == 1 and "all" in label)
    for b in (1, 8):
        zorro_cases("none", f"n=256 8x32 B={b}", randn(b, 256, 3 * 256), 8, None, b == 8)
    # training shapes: forward and backward
    train_types = packed_types(train_mi, 384, f, 3)
    qkv_train = randn(60, 640, 3 * 192)
    zorro_cases("zorro", "N=640 B=60 train masks e=384", qkv_train, 3, train_types, False)
    zorro_bwd_cases("zorro", "N=640 B=60 train masks e=384", qkv_train, 3, train_types, True)
    s2_types = drop_types(4, ("s2",))
    zorro_bwd_cases("zorro", "N=1024 B=4 s2 dropped", randn(4, 1024, 3 * 192), 3, s2_types, False)
    qkv_dec = randn(60, 256, 3 * 256)
    zorro_cases("none", "n=256 8x32 B=60", qkv_dec, 8, None, False)
    zorro_bwd_cases("none", "n=256 8x32 B=60", qkv_dec, 8, None, True)

    def ffn_work(m, backward, geglu):
        if geglu:
            weights = 3 * inner_ff * d + d
            flops = (16 if backward else 6) * m * d * inner_ff
            acts = (3 if backward else 2) * m * d
        else:
            weights = 2 * hid * dd + hid + dd
            flops = (6 if backward else 2) * m * dd * hid + (4 if backward else 2) * m * hid * dd
            acts = (3 if backward else 2) * m * dd
        return flops, 2 * (acts + (2 if backward else 1) * weights), PEAK_BF16

    for m in (1024, 256, 4096, 38400, 15360):
        x = randn(m, d)
        cases.append(("fused_ffn/geglu", f"M={m} d=192 I=512",
                      lambda x=x: cuda_ffn.geglu_ffn(x, *geglu_w),
                      lambda x=x: cuda_ffn.geglu_ffn_reference(x, *geglu_w),
                      ffn_work(m, False, True), None, m == 1024))
    for m in (38400, 15360):
        x, dy = randn(m, d), randn(m, d)
        cases.append(("fused_ffn/geglu_backward", f"M={m} d=192 I=512",
                      lambda x=x, dy=dy: cuda_ffn.geglu_ffn_backward(x, *geglu_w, dy),
                      lambda x=x, dy=dy: cuda_ffn.geglu_ffn_backward_reference(x, *geglu_w, dy),
                      ffn_work(m, True, True), None, m == 38400))
    for m in (256, 2048, 15360):
        x = randn(m, dd)
        cases.append(("fused_ffn/mlp", f"M={m} d=256 H=1024",
                      lambda x=x: cuda_ffn.mlp_ffn(x, *mlp_w),
                      lambda x=x: cuda_ffn.mlp_ffn_reference(x, *mlp_w),
                      ffn_work(m, False, False), None, m == 2048))
    x, dy = randn(15360, dd), randn(15360, dd)
    cases.append(("fused_ffn/mlp_backward", "M=15360 d=256 H=1024",
                  lambda: cuda_ffn.mlp_ffn_backward(x, *mlp_w, dy),
                  lambda: cuda_ffn.mlp_ffn_backward_reference(x, *mlp_w, dy),
                  ffn_work(15360, True, False), None, True))

    for b in (1, 8, 60):
        q, kvg, kvf = randn(b, f, 192), randn(b, 3 * f, 384), randn(b, f, 384)
        work = (4.0 * 64 * 4 * b * f * 3, nbytes(q, kvg, kvf, q), PEAK_F32)
        cases.append(("fusion_row_attention/fusion_row", f"F=256 T=3 3x64 B={b}",
                      lambda q=q, kvg=kvg, kvf=kvf: cuda_fusion_attn.fusion_row_attention(
                          q, kvg, kvf, 3, 64),
                      lambda q=q, kvg=kvg, kvf=kvf: cuda_fusion_attn.fusion_row_attention_reference(
                          q, kvg, kvf, 3, 64), work, None, b == 8))
        if b == 60:
            do = randn(b, f, 192)
            work = (8.0 * 64 * 4 * b * f * 3, 2 * nbytes(q, kvg, kvf) + nbytes(do), PEAK_F32)
            cases.append(("fusion_row_attention/fusion_row_backward", "F=256 T=3 3x64 B=60",
                          lambda: cuda_fusion_attn.fusion_row_attention_backward(q, kvg, kvf, do, 3, 64),
                          lambda: cuda_fusion_attn.fusion_row_attention_backward_reference(
                              q, kvg, kvf, do, 3, 64), work, None, True))

    # K4 (f32) at the pixel decoder's shapes: levels 8^2, 16^2, 32^2, 8 heads
    # x 32, 4 points, every position a query; random locations in
    # [-0.1, 1.1] and random softmaxed weights, so the samples fall between
    # pixel centres and past the borders; at B = 30 also samples near each
    # query's reference points, to see whether the gathers' locality matters
    for b, near in ((1, False), (30, False), (30, True)):
        value, locs, aw = msda_inputs(dev, g, b, near_reference=near)
        label = f"B={b} Lq=S=1344 8x32 L=3 P=4" + (" near reference" if near else "")
        cases.append(("ms_deform_attn/forward", label,
                      lambda v=value, lc=locs, a=aw: cuda_msda.ms_deform_attn(v, MSDA_LEVELS, lc, a),
                      lambda v=value, lc=locs, a=aw: cuda_msda.ms_deform_attn_core(v, MSDA_LEVELS, lc, a),
                      msda_work(value, locs, aw), None, b == 30 and not near))

    results = {}
    for entry, label, kernel, plain, (flops, n_bytes, peak), library, main in cases:
        outs, refs = outputs(kernel()), outputs(plain())
        torch.cuda.synchronize()
        if entry.startswith("zorro_attention_qkv/") and entry.endswith("_backward"):
            outs, refs = outs[0].chunk(3, dim=-1), refs[0].chunk(3, dim=-1)  # dq, dk, dv
        for o, r in zip(outs, refs):
            if o.shape != r.shape or not torch.isfinite(o).all():
                raise RuntimeError(f"[kernels] {entry} {label}: bad output {tuple(o.shape)}")
        err = max(float((o.float() - r.float()).abs().max()) for o, r in zip(outs, refs))
        rel = max(rel_l2(o, r) for o, r in zip(outs, refs))
        ms_k, ms_p = cuda_ms(kernel), cuda_ms(plain)
        ms_lib = cuda_ms(library) if library is not None else None
        bound_ms, bound_by = bound(flops, n_bytes, peak)
        fb = f" library fwd+bwd {cuda_ms(fwd_bwd[entry, label]):.6g} ms" if (entry, label) in fwd_bwd else ""
        log(f"[kernels] {entry:40s} {label:30s} max_abs_err {err:.6g} rel_l2 {rel:.6g} "
            f"kernel {ms_k:.6g} ms plain {ms_p:.6g} ms library "
            f"{'-' if ms_lib is None else f'{ms_lib:.6g} ms'}{fb} bound {bound_ms:.6g} ms ({bound_by})")
        rel_bound = MSDA_REL_L2 if entry.startswith("ms_deform_attn/") else KERNEL_REL_L2
        if not rel <= rel_bound:
            raise RuntimeError(f"[kernels] {entry} {label}: rel L2 {rel} > {rel_bound}")
        r = results.setdefault(entry, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            r.update(ms=ms_k, plain_ms=ms_p, library_ms=ms_lib, bound_ms=bound_ms, bound_by=bound_by,
                     shape=label)
    return results


PER_FORWARD = {"zorro_attention_qkv/zorro": 12, "zorro_attention_qkv/none": 6,
               "fused_ffn/geglu": 24, "fused_ffn/mlp": 6, "fusion_row_attention/fusion_row": 12}


def serving_model(dev):
    """The full-width ``tiny`` MultiMAE (PretrainConfig defaults), seeded
    random weights, bf16 on ``dev``."""
    model = build_multimae(PretrainConfig(), device=dev, generator=torch.Generator().manual_seed(SEED))
    return model.to(torch.bfloat16).eval()


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


def wall_ms(run, reps: int, warmup: int):
    """Host-clock ms of ``reps`` calls after ``warmup``, each ending in a
    synchronize."""
    times = []
    for i in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return times


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
        if {k: n for k, n in counts.items() if n} != PER_FORWARD:
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
        lat = wall_ms(run, reps=10, warmup=3)
        model.attn_impl = "xla"
        lat_p = wall_ms(run, reps=5, warmup=2)
        model.attn_impl = "auto"
        log(f"[serving] {kind:32s} finite ok, dropped-pixel max change {worst_inv:.3g}, "
            f"rel_l2 vs plain path {rel:.6g}, p50 {statistics.median(lat):.6g} ms "
            f"(plain path p50 {statistics.median(lat_p):.6g} ms)")
    return launches


PER_STEP = {**PER_FORWARD, **{f"{k}_backward": n for k, n in PER_FORWARD.items()}}


def flat_grads(model):
    """Every parameter's gradient in f32; zeros where none arrives (the
    teacher pool's tokens, whose gradient the DINO term stops)."""
    return {n: (p.grad.detach().float().clone() if p.grad is not None
                else torch.zeros_like(p, dtype=torch.float32))
            for n, p in model.named_parameters()}


def step_times(run, steps: int, warmup: int):
    """Host-clock ms of ``steps`` calls after ``warmup`` untimed ones, each
    ending in a synchronize; ``run`` returns the step's metrics."""
    times, losses = [], []
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = run()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    return times, losses


def phase_train(dev):
    """The pretraining step at PretrainConfig() defaults (B = 60, bf16
    compute over f32 masters) through create_train_state / make_train_step."""
    cfg = PretrainConfig()
    doms = tuple(cfg.data.in_domains)
    nums = (cfg.data.num_patches,) * len(doms)
    e, b = cfg.mask.num_encoded_tokens, cfg.data.batch_size
    model, state, optimizer = pretrain.create_train_state(cfg, SEED, total_steps=1000, device=dev)
    step = pretrain.make_train_step(model, cfg, optimizer)
    batch = {d: torch.from_numpy(v).to(dev)
             for d, v in synthetic_batch(np.random.default_rng(SEED), doms, b, cfg.data.input_size).items()}

    # kernel path against the plain path: the same weights, batch and masks
    mi = masking.generate_random_masks(torch.Generator().manual_seed(SEED), doms, nums, e, b, device=dev)
    loss_fn = pretrain.make_loss_fn(model, cfg)
    results = {}
    for impl in ("auto", "xla"):
        model.attn_impl = impl
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(dict(model.named_parameters()), batch, mi)
        loss.backward()
        results[impl] = (float(loss.detach()), flat_grads(model))
    model.attn_impl = "auto"
    model.zero_grad(set_to_none=True)
    (loss_k, g_k), (loss_p, g_p) = results["auto"], results["xla"]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    diff = torch.cat([(g_k[n] - g_p[n]).reshape(-1) for n in g_p])
    grad_rel = float(diff.norm() / torch.cat([g.reshape(-1) for g in g_p.values()]).norm())
    worst = sorted(((rel_l2(g_k[n], g_p[n]), n) for n in g_p), reverse=True)[:5]
    log(f"[train] loss kernel path {loss_k:.6g}, plain path {loss_p:.6g}, rel diff {loss_rel:.3g}; "
        f"flat gradient rel_l2 {grad_rel:.3g}; worst parameters: "
        + ", ".join(f"{n} {r:.3g}" for r, n in worst))
    if not (math.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2):
        raise RuntimeError(f"[train] kernel path vs plain path: loss rel {loss_rel} "
                           f"(bound {TRAIN_LOSS_REL}), gradient rel L2 {grad_rel} (bound {TRAIN_GRAD_REL_L2})")
    del results, g_k, g_p, diff

    # the main path's run: one step with masks from the state's generator
    ops.reset_kernel_launches()
    step(state, batch)
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    log(f"[train] launches in one step: {launches}")
    if {k: n for k, n in launches.items() if n} != PER_STEP:
        raise RuntimeError(f"[train] launches per step {launches}, expected {PER_STEP}")

    before = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    count = optimizer.count
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = step_times(lambda: step(state, batch)[1], steps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated(dev)
    after = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    moved = float((after - before).abs().max())
    if not all(math.isfinite(x) for x in losses) or moved == 0.0 or optimizer.count != count + 13:
        raise RuntimeError(f"[train] losses {losses}, max weight change {moved}, "
                           f"optimizer count {optimizer.count} (was {count})")
    model.attn_impl = "xla"
    times_p, _ = step_times(lambda: step(state, batch)[1], steps=5, warmup=2)
    model.attn_impl = "auto"
    for impl, wall in (("auto", times), ("xla", times_p)):
        model.attn_impl = impl
        dev_ms, n_kernels, by_kind, top = device_breakdown(lambda: step(state, batch), reps=3)
        log(f"[train] profile attn_impl={impl}: device {dev_ms:.6g} ms a step in {n_kernels:.0f} "
            f"kernels/copies, busy {dev_ms / statistics.median(wall):.3f} of the p50 wall; by kind "
            + ", ".join(f"{k} {v:.6g} ms" for k, v in sorted(by_kind.items())))
        for name, ms in top:
            log(f"[train]     {ms:9.4f} ms  {name[:100]}")
    model.attn_impl = "auto"
    mask_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        masking.generate_random_masks(state.generator, doms, nums, e, b, device=dev)
        torch.cuda.synchronize()
        mask_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[train] B={b} N={e + cfg.model.num_fusion_tokens}: losses {[round(x, 4) for x in losses]}, "
        f"max weight change {moved:.3g}, optimizer count {optimizer.count}; step p50 "
        f"{statistics.median(times):.6g} ms (plain path p50 {statistics.median(times_p):.6g} ms); "
        f"mask sampling p50 {statistics.median(mask_ms):.6g} ms on the host; "
        f"peak device memory {peak / 2 ** 30:.4g} GiB")
    return launches


SEG_PER_FORWARD = {"ms_deform_attn/forward": 2, "zorro_attention_qkv/zorro": 12, "fused_ffn/geglu": 24}
SEG_CLASSES = 10  # the 9 Dynamic-World land-cover classes and the dead channel 0


def segment_model(dev, num_classes: int):
    """The full-width MaskFormer (MaskFormerConfig defaults) with seeded
    random weights: backbone bf16, head f32. Two changes to the JAX
    initializers: seeded N(0, 0.02) noise on the zero sampling-offset and
    attention-weight kernels, so the samples leave the pixel centres, and
    mask_embed.layer2 x 6, so the mask logits leave the hard 0.5
    threshold of the masked attention (test_full_maskformer_parity.py:139)."""
    model = build_maskformer(MaskFormerConfig(num_classes=num_classes), device=dev,
                             generator=torch.Generator().manual_seed(SEED))
    model.backbone.to(torch.bfloat16)
    noise = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MSDeformAttn):
                for lin in (m.sampling_offsets, m.attention_weights):
                    lin.weight.add_(0.02 * torch.randn(lin.weight.shape, generator=noise).to(dev))
        layer2 = model.predictor.mask_embed.layer2
        layer2.weight.mul_(6.0)
        layer2.bias.mul_(6.0)
    return model.eval()


def segment_requests(dev, rng):
    """The four segmentation requests as {kind: (model, run, x, dropped)}:
    ``run(x)`` answers the request through its entry point."""
    sem, inst = segment_model(dev, SEG_CLASSES), segment_model(dev, 1)
    doms = sem.cfg.in_domains
    size = sem.cfg.image_size

    def semantic(dropped):
        return lambda x: infer_segmentation.forward_segmentation(sem, None, x, SEG_CLASSES, dropped)

    def instance(x):
        return infer_segmentation.forward_instance_segmentation(inst, None, x, topk=100)

    x1 = synthetic_batch(rng, doms, 1, size)
    return {
        "semantic B=1 all modalities": (sem, semantic(()), x1, ()),
        "semantic B=1 dem dropped": (sem, semantic(("dem",)), x1, ("dem",)),
        "instance B=8 topk=100": (inst, instance, synthetic_batch(rng, doms, 8, size), ()),
        "semantic B=30": (sem, semantic(()), synthetic_batch(rng, doms, 30, size), ()),
    }


def phase_segment(dev):
    """The downstream segmentation forward at MaskFormerConfig() widths
    through forward_segmentation / forward_instance_segmentation."""
    requests = segment_requests(dev, np.random.default_rng(SEED))

    # the main path's run: every request once, launch counters from 0
    ops.reset_kernel_launches()
    answers = {}
    for kind, (model, run, x, _) in requests.items():
        before = ops.kernel_launches()
        answers[kind] = run(x)
        torch.cuda.synchronize()
        after = ops.kernel_launches()
        counts = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        log(f"[segment] {kind:28s} launches per forward {counts}")
        if counts != SEG_PER_FORWARD:
            raise RuntimeError(f"[segment] {kind}: launches per forward {counts}, "
                               f"expected {SEG_PER_FORWARD}")
    launches = ops.kernel_launches()
    log(f"[segment] launches in the main-path run: {launches}")

    for kind, (model, run, x, dropped) in requests.items():
        answer = answers[kind]
        if kind.startswith("semantic"):
            if not (answer.min() >= 1 and answer.max() <= SEG_CLASSES):
                raise RuntimeError(f"[segment] {kind}: labels outside 1..{SEG_CLASSES}")
        else:
            for inst in answer:
                if not (torch.isfinite(inst["scores"]).all() and len(inst["scores"]) == 100):
                    raise RuntimeError(f"[segment] {kind}: bad instance scores")
        hw = (model.cfg.image_size, model.cfg.image_size)
        out_k = infer_segmentation.segmentation_outputs(model, None, x, dropped)
        model.attn_impl = "xla"
        out_p = infer_segmentation.segmentation_outputs(model, None, x, dropped)
        model.attn_impl = "auto"
        compared = {k: (out_k[k], out_p[k]) for k in ("pred_logits", "pred_masks")}
        if kind.startswith("semantic"):
            compared["probabilities"] = (infer_segmentation.semantic_probabilities(out_k, hw),
                                         infer_segmentation.semantic_probabilities(out_p, hw))
        for key, (a, b) in compared.items():
            if not torch.isfinite(a).all():
                raise RuntimeError(f"[segment] {kind}: non-finite {key}")
        rels = {key: rel_l2(a, b) for key, (a, b) in compared.items()}
        if not max(rels.values()) <= SEG_REL_L2:
            raise RuntimeError(f"[segment] {kind}: rel L2 vs plain path {rels} > {SEG_REL_L2}")
        note = ""
        if dropped:
            moved = {d: (v * 0.0 + 123.0 if d in dropped else v) for d, v in x.items()}
            out_m = infer_segmentation.segmentation_outputs(model, None, moved, dropped)
            same = all(torch.equal(out_k[k], out_m[k]) for k in ("pred_logits", "pred_masks"))
            if not (same and torch.equal(run(moved), answer)):
                raise RuntimeError(f"[segment] {kind}: the answer moved with the dropped pixels")
            note = ", bitwise unmoved by the dropped pixels"
        b = next(iter(x.values())).shape[0]
        torch.cuda.reset_peak_memory_stats(dev)
        lat = wall_ms(lambda: run(x), reps=10, warmup=3)
        peak = torch.cuda.max_memory_allocated(dev)
        model.attn_impl = "xla"
        lat_p = wall_ms(lambda: run(x), reps=5, warmup=2)
        model.attn_impl = "auto"
        p50 = statistics.median(lat)
        log(f"[segment] {kind:28s} finite ok{note}; rel_l2 vs plain path "
            + ", ".join(f"{k} {v:.6g}" for k, v in rels.items())
            + f"; p50 {p50:.6g} ms ({b / p50 * 1e3:.6g} images/s; plain path p50 "
            f"{statistics.median(lat_p):.6g} ms); peak device memory {peak / 2 ** 30:.4g} GiB")
        if kind.startswith("semantic B=1 all") or kind == "semantic B=30":
            dev_ms, n_kernels, by_kind, top = device_breakdown(lambda: run(x), reps=3, top_n=None)
            log(f"[segment] {kind:28s} profile: device {dev_ms:.6g} ms a forward in {n_kernels:.0f} "
                f"kernels/copies, busy {dev_ms / p50:.3f} of the p50 wall; by kind "
                + ", ".join(f"{k} {v:.6g} ms" for k, v in sorted(by_kind.items())))
            for name, ms in top[:8] + [t for t in top[8:] if "ms_deform_attn" in t[0]]:
                log(f"[segment]     {ms:9.4f} ms  {name[:100]}")
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
    "zorro_attention_qkv/zorro_backward": ("csrc/zorro_attention.cu",
                                           "incomplete_multimodal_fusion_tpu/ops/pallas_attn.py:739"),
    "zorro_attention_qkv/none_backward": ("csrc/zorro_attention.cu",
                                          "incomplete_multimodal_fusion_tpu/ops/pallas_small_attn.py:156"),
    "fused_ffn/geglu_backward": ("csrc/fused_ffn_bwd.cu",
                                 "incomplete_multimodal_fusion_tpu/ops/pallas_ffn.py:222"),
    "fused_ffn/mlp_backward": ("csrc/fused_ffn_bwd.cu",
                               "incomplete_multimodal_fusion_tpu/ops/pallas_ffn.py:397"),
    "fusion_row_attention/fusion_row_backward": (
        "csrc/fusion_row_attention.cu", "incomplete_multimodal_fusion_tpu/ops/pallas_fusion_attn.py:195"),
    "ms_deform_attn/forward": ("csrc/ms_deform_attn.cu",
                               "incomplete_multimodal_fusion_tpu/ops/pallas_msda.py:170"),
}


def main() -> int:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernel_results = phase_kernels(dev)
    # the two main paths, each run with the counts set to 0 just before it
    served = phase_serving(dev)
    trained = phase_train(dev)
    segmented = phase_segment(dev)
    entries = []
    for name, (src, replaces) in REPLACES.items():
        r = kernel_results[name]
        launches = served[name] + trained[name] + segmented[name]
        if launches <= 0:
            raise RuntimeError(f"{name} was not launched by the main paths")
        entries.append({"name": name, "route": "cuda", "source": f"{PKG}/{src}",
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"]})
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
