"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the
hand-written CUDA kernels from ``incomplete_multimodal_fusion_tpu_torch/
csrc/`` with nvcc, holds each, forward and backward, against its plain
PyTorch version at the shapes of the model, then drives the full-width
``tiny`` MultiMAE (PretrainConfig defaults, seeded random weights) through
the serving entry points (bf16) and through the pretraining step (bf16
compute over f32 master weights, B = 60), and the full-width downstream
MaskFormer (MaskFormerConfig defaults, seeded random weights, bf16 backbone
and f32 head) through the segmentation entry points and through the
downstream instance-segmentation training step (B = 30, exact Hungarian
matching, PointRend criterion, bf16 compute over f32 master weights), then
the f32 paths through the kernels' f32 instances, the semantic
downstream training step, the pretraining state (balancer, EMA, the
K-step CUDA graph, checkpoints through the CLI, the reference converter)
and the command line (convert, infer, fine-tune, a learning run), and
checks what comes out; then the serving forward as an exported program
reloaded without model code, the batched decoder trunk and the
segmentation extras; the other downstream backbones (the ViT-Adapter,
ResNet, Swin, the 'sup' fusion mode) and the standard decoder; last, the
host data path: the readers, the native raster ops and the pinned ring
feeding the steps and the CLIs from trees on disk.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # phases 1-3 alone, no result line

Phases (any failure raises; the exit code is then non-zero):
  1. device   -- the card's name and power limit; fails without CUDA.
  2. build    -- nvcc for sm_90a into build/kernels/, all sources in
                 parallel, timed.
  3. kernels  -- each kernel against its plain version in bf16 (K4, K4b,
                 K5 and K5b in f32) at the serving, training and
                 segmentation shapes (K1's separate-q/k/v and tile-skip
                 modes and the fused attention half-block K6 at the
                 pretraining shape; K2 and K2b also at the `base` and
                 `large` widths, K4 and K4b also near the reference points, and
                 beside each K2 row, for reference, the unfused cuBLAS
                 chain's time): max abs error and relative L2 error
                 (bound KERNEL_REL_L2, K4 and K4b MSDA_REL_L2, K5 and K5b
                 POINTS_REL_L2), kernel, plain and library times
                 (CUDA events, median of 20 after warm-up) and the least time
                 the card could take (bound_ms, from the bytes and operations
                 of these inputs); the f32 instances of K1 (every mode), K2,
                 K2b, K3, K3b, K6 and K6b at the f32 paths' shapes against
                 their f32 plain versions (bound F32_REL_L2, library calls
                 in f32); for every row also the device-only time
                 of the kernels and of the library call (SDPA for K1 / K1b,
                 grid_sample for K5 / K5b) from the profiler, its kernel
                 count checked against the wrappers' launch counts (CUDA
                 events around 20 back-to-back calls where the profiler
                 dropped events).
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
  7. segment-train -- train.downstream.create_downstream_optimizer /
                 make_downstream_train_step at MaskFormerConfig(num_classes=1)
                 widths, B = 30 with 8 padded targets, 12544 points, exact
                 matching, frozen_stages 11, clip 0.01, AdamW 1e-4, bf16
                 compute: loss and gradients of the kernel path against the
                 plain path on the same masks, matches and points, dropout
                 off (bounds TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2), exact launch
                 counts per step, 3 warm-up and 10 timed steps (finite loss,
                 trainable weights moved, frozen ones bitwise unchanged), p50
                 step time and images/s of both paths, host time of the
                 scipy matching, peak device memory, profiled device time.
  8. encoder-variants -- on phase 5's model, batch and masks: (a) the
                 pretraining step with EncoderBlock.fused_block on all 12
                 blocks (K6 / K6b) against the default kernel step (bounds
                 TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2), exact launch counts per
                 step, 3 warm-up and 10 timed steps beside the default step,
                 profiled device time of both steps, peak device memory; (b) on each
                 block's qkv slab of one step, K1's separate-q/k/v mode
                 against K1 / K1b on every row and its tile-skip mode against
                 K1 / K1b on the non-PAD rows and against its plain version on
                 every row, forward and backward with a seeded dO, the
                 share of 128 x 128 tiles skipped, and block 0's K1 + K1b
                 device time dense, with its tiles skipped and with every
                 tile active.
  9. f32      -- TF32 off in every part. (a) the pretraining step with
                 compute_dtype='float32' at B = 60, kernel path against
                 plain path on one set of masks (bounds F32_LOSS_REL,
                 F32_GRAD_REL_L2), exact launch counts of f32 keys only, 3
                 warm-up and 5 timed steps, peak memory, the fused_block
                 step (K6 / K6b f32) against the default f32 step and
                 timed beside it (device ms, busy, p50 wall, peak, top
                 kernels; neither profile may hold an FFMA product
                 kernel), and K1's two modes in f32 on each block's qkv
                 slab; (b) one f32
                 serving request against the plain path
                 (F32_FORWARD_REL_L2); (c) phase 7's downstream step with
                 compute_dtype='float32' on phase 7's weights, masks,
                 matches and points, kernel path against plain path, beside
                 phase 7's bf16 numbers, with the head's attention-mask bits
                 that differ between the two paths in both dtypes; (d) at
                 MODEL_SIZES['base'] (K2 / K2b's wide path): one B = 1
                 serving forward as cli.infer --model_size base runs it
                 (batched decoder, dem dropped) against its plain path
                 (F32_FORWARD_REL_L2), and the f32 pretraining step at depth
                 12, B = F32_BASE_BATCH, against its plain path (F32_LOSS_REL,
                 F32_GRAD_REL_L2), exact launches, F32_BASE_STEPS timed steps;
                 for both device ms, peak memory, wall p50, no
                 simt_f32_product kernel and the wide path's kernels.
 10. semantic-train -- train.downstream.make_downstream_train_step at
                 MaskFormerConfig(num_classes=10), B = 30, seeded label
                 maps through targets_from_semantic_labels (G = 10),
                 dense_masks=True, bf16 compute, exact matching: loss and
                 gradients against the plain path on the same masks and
                 matches, exact launch counts (K5 for the matcher, K5b
                 none), 3 warm-up and 10 timed steps, p50, images/s, peak
                 memory, profiled device time; then one step each with
                 'greedy' and 'auction' matching, whose assignments on the
                 card must equal the CPU's from the same costs.
 11. pretrain-state -- PretrainConfig() (B = 60, bf16 over f32 masters) with
                 task_balancer='uncertainty' and use_ema=True: (a)
                 train.pretrain.make_multi_step (K = 4: the step captured in
                 one CUDA graph and replayed) against 4 eager steps from the
                 same state, twice eager: masters, moments, counts, balancer,
                 EMA, generator and metrics bitwise equal where two eager
                 runs are, else within twice the eager runs' spread; exact
                 launch counts; (b) per step, eager and graph: wall p50,
                 profiled device ms, busy share, kernels and copies, peak
                 memory, and the graph's trace holding the eager step's
                 hand-written kernels; (c) the pretraining CLI in
                 subprocesses, 2 epochs of 4 steps (K = 4) straight through,
                 and from its first checkpoint in a fresh process with
                 --auto_resume: the last checkpoints equal under (a)'s rule;
                 (d) tests/golden/fullmodel_golden.npz's weights through
                 utils.torch_convert and one bf16 serving request at the
                 golden's config (the plain path: its head dim 16 is not one
                 of K1's) within SERVING_REL_L2 of full::*.
 12. cli      -- the port's command line, in a temporary directory under
                 build/, removed after: (a) cli.convert_checkpoint on the
                 golden's reference weights as a .pth, in a fresh process,
                 restored bit for bit as (d)'s convert_multimae_state output;
                 (b) cli.infer in this process on a PretrainConfig()
                 checkpoint (create_train_state, save_checkpoint), seeded
                 masks (e = 256, seed 1) and --drop dem: finite PSNR for each
                 masked modality, "fully visible" for the kept ones, a PNG
                 grid of at least 3 x 256 by 3 x 256, one f32 serving
                 forward's launches a call (the CLI computes in f32); (c) cli.train_downstream in this process at
                 its defaults (tiny, 256^2, B = 30, 12544 points, exact,
                 frozen 11, bf16) with --pretrained (b)'s checkpoint, 2 epochs
                 of 3 steps, eval and a checkpoint each epoch: the backbone
                 tensors copied equal those the pretraining model shares at
                 equal shape, finite losses, a finite dice >= 0 (the
                 reference's dice passes 1 where the queries' summed
                 probabilities do), checkpoint-2
                 restored bitwise into a fresh model and optimizer, phase 7's
                 launches a step x 6 plus two f32 eval forwards', the CLI's
                 wall p50 a step; then --task semantic (10 classes, greedy, 1
                 epoch of 2 steps): AA and mIoU in [0, 1]; (d)
                 tools/train_downstream_synthetic_torch.py for LEARN_STEPS
                 steps in a subprocess (B = 8, frozen 11, auction): the mean
                 loss of the last 25 steps at most half the first step's,
                 mAP / AP50 / AP75 / foreground IoU beside DOWNSTREAM_E2E.json.
 13. export   -- (a) the full-width ``tiny`` serving model (bf16, seeded
                 weights) through serving.export_infer at B = 1 and B = 8,
                 each artifact reloaded by serving.load_exported in a fresh
                 python3 process that imports the loader alone (no module of
                 models/, train/ or losses/ loaded) and answers two requests
                 (all visible, s2 dropped): launches per forward exactly
                 PER_FORWARD, outputs bitwise the live closure's (else within
                 rel-L2 1e-3), wall p50 of the reloaded program and of the
                 live closure, the artifact's MB; (b) the same weights with
                 decoder_batch_tasks=True: launches BATCHED_PER_FORWARD (K1
                 unmasked and K2's task-axis MLP twice, not six times), preds
                 within SERVING_REL_L2 of the per-task decoder's, device ms of
                 both; the same request in f32 against its plain path
                 (F32_FORWARD_REL_L2); one B = 60 pretraining step's loss and
                 gradients, batched against per-task decoder (TRAIN_LOSS_REL,
                 TRAIN_GRAD_REL_L2); (c) at MaskFormerConfig(num_classes=10),
                 B = 1: semantic_inference_with_tta (twice the forward's
                 launches, within SEG_REL_L2 of the mean of the two forwards
                 by hand), panoptic_inference on the card's outputs equal to
                 the host's, save_segmentation_png read back.
 14. pretrain-variants -- the zorro, lstm and crossattn_v1 fusion modes,
                 crossattn with the full MAE decoder and the quadruplet
                 (s1_2ch, s2_4ch, dem, dnw) crossattn at PretrainConfig()
                 widths, B = 60, bf16 over f32 masters: (a) per variant the
                 loss and gradients against the plain path (TRAIN_LOSS_REL,
                 TRAIN_GRAD_REL_L2), exact launches a step, p50, device ms,
                 busy share, peak memory; one lstm make_multi_step group (K =
                 2) against 2 eager steps; (b) the trained weights in bf16
                 serving one B = 1 request with dem dropped (exact launches,
                 bitwise unmoved by dem's pixels, SERVING_REL_L2), one f32
                 cli.infer --fusion_mode lstm (f32 keys only); (c) a 3-step
                 cli.pretrain --fusion_mode lstm --log_wandb --profile_dir
                 (B = 12) in a subprocess (a wandb fallback line a step, K1 and K2 in the
                 trace). Phase 3 holds K1 / K1b over the 2E layout, K2 / K2b
                 at M = 46,080 and K3 / K3b at T = 4 for it.
 15. backbones -- the other downstream backbones and decoders at full
                 width (seeded weights; the ViT-Adapter's injector gamma and
                 every deformable attention's sampling kernels drawn
                 non-zero): (a) MaskFormerConfig(backbone_type='vit_adapter',
                 num_classes=10), bf16 backbone and f32 head, through
                 forward_segmentation at B = 1, B = 1 with dem dropped
                 (bitwise unmoved by dem's pixels) and B = 30: exact
                 launches a forward (K4 8 in the injectors and extractors,
                 2 in the pixel decoder; K1 12, K2 24), outputs within
                 SEG_REL_L2 of the plain path; (b) the B = 30 instance step
                 on the adapter (phase 7's settings): loss and gradients
                 against the plain path with the head's attention-mask bits
                 pinned to the kernel path's (TRAIN_LOSS_REL,
                 TRAIN_GRAD_REL_L2), the free plain path's loss and flipped
                 bits (FREE_LOSS_REL, FREE_MASK_BITS) beside an f64
                 deformable-attention control, exact launches a step (K4b
                 8 + 2); (c) resnet50, resnet18,
                 swin, the 'sup' fusion mode and the vit backbone with the
                 'standard' decoder: one such step each and one B = 30
                 forward_instance_segmentation on its weights with the
                 backbone in bf16 (K4 / K4b in the pixel decoder, K5 / K5b
                 in the criterion, K1 unmasked and K2 in 'sup'); for each,
                 p50, device ms, busy share and peak memory. Phase 3 holds
                 K4 / K4b at the injector's and extractor's shapes for it,
                 and K1 / K1b unmasked and K2 / K2b GEGLU at 'sup''s.
 16. data     -- the host data path, on trees written with the port's
                 write_tiff under build/ (removed after): a DFC2023 tree of
                 120 256^2 uncompressed tiles (u8 RGB, f32 SAR and DSM), a
                 deflate 512^2 copy, a COCO, a quadruplet and an ADE .npy
                 tree. (a) The first B = 60 pretraining batch through the
                 pinned ring (data.loader.DeviceLoader over
                 data.dfc2023.DFC2023Batches): the device batch bitwise its
                 pinned host batch, the host batch within NATIVE_ATOL of the
                 numpy path, the first step's loss bitwise the same step fed
                 by torch.from_numpy(batch).cuda(); (b) exact launches of
                 every path: the eager and K = 4 pretraining steps fed from
                 disk, cli.pretrain --data_path --steps_per_call 4,
                 cli.infer --data_path (f32), cli.train_downstream's instance
                 step from COCO (and once with --aug) and semantic steps from
                 the quadruplet and ADE trees (B = 30); (c) the host ms to
                 build a batch (thread count, os.cpu_count()) on the fused
                 path, the resize path (the 512^2 copy read at 256) and the
                 random crop (the 512^2 copy cut to 256), each native
                 against numpy within NATIVE_ATOL; the ms each step waited
                 for its batch, wall p50 a step and busy share fed from disk
                 beside one device batch and the CLI's synthetic stream,
                 eager and K = 4, and the pinned MB.
 17. parallel -- parallel/ at full width, each mode held against the
                 one-process step on the same weights, batch and masks
                 (loss TRAIN_LOSS_REL, the first step's global gradient
                 TRAIN_GRAD_REL_L2, FlatAdamW's first moment after it
                 PARALLEL_MU_REL_L2, the change of the weights over the
                 steps PARALLEL_DELTA_REL_L2 (weights left unchanged read 1;
                 each mode with data ranks also reads what a rank that
                 skipped the all-reduce would, above both limits) with its
                 launches exactly the one-process step's: (a) two gloo
                 ranks on cuda:0 (NCCL takes one rank a device; this script
                 re-run with --parallel-worker): data parallel pretraining
                 2 x 30 rows, ZeRO, tensor parallel at tp = 2 (the 3 heads
                 replicated, K2 at I = 256, the decoder's 4 heads and H =
                 512 a rank),
                 tensor + sequence parallel, the data-parallel downstream
                 step 2 x 15 rows; (b) one NCCL rank in this process: the
                 data-parallel step graphed at K = 4 (its all-reduces inside
                 the CUDA graph), ZeRO, the pipelined trunk at 2
                 microbatches; (c) names what gloo cannot take on CUDA
                 tensors; (d) the class-map backbone (dnw, K1 at N = 1280):
                 a B = 30 forward and a step's loss and gradient against the
                 plain path. For each mode device ms a step, its
                 collectives' ms and peak memory a rank: two ranks share
                 one card, so none is a multi-GPU figure.
Prints one JSON line of per-kernel results, the card's nvidia-smi line, and
last the JSON device line.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import struct
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from incomplete_multimodal_fusion_tpu_torch import infer, infer_segmentation, ops, serving
from incomplete_multimodal_fusion_tpu_torch.config import MODEL_SIZES, DataConfig, PretrainConfig
from incomplete_multimodal_fusion_tpu_torch.data import dfc2023, sample_trees
from incomplete_multimodal_fusion_tpu_torch.data.loader import DeviceLoader
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch, synthetic_instances
from incomplete_multimodal_fusion_tpu_torch.models.maskformer import MaskFormerConfig, MaskFormerModel, build_maskformer
from incomplete_multimodal_fusion_tpu_torch.models import msda_module
from incomplete_multimodal_fusion_tpu_torch.models.msda_module import MSDeformAttn
from incomplete_multimodal_fusion_tpu_torch.models.multimae import MultiMAE, build_multimae, gathered_layout
from incomplete_multimodal_fusion_tpu_torch.models.pixel_decoder import reference_points_for
from incomplete_multimodal_fusion_tpu_torch.models.vit_baseline import interaction_groups
from incomplete_multimodal_fusion_tpu_torch.losses import set_criterion
from incomplete_multimodal_fusion_tpu_torch.losses.set_criterion import SegTargets, scipy_assign_host
from incomplete_multimodal_fusion_tpu_torch.ops import (cuda_attn, cuda_block_attn, cuda_build, cuda_ffn,
                                                        cuda_fusion_attn, cuda_msda, cuda_points, cuda_zorro_sparse)
from incomplete_multimodal_fusion_tpu_torch.ops import masking
from incomplete_multimodal_fusion_tpu_torch.parallel import dist as pdist
from incomplete_multimodal_fusion_tpu_torch.parallel.mesh import downstream_layout, make_layout, shard_rows
from incomplete_multimodal_fusion_tpu_torch.ops.attention import (packed_token_types, packed_valid,
                                                                   zorro_mask_from_padded_types)
from incomplete_multimodal_fusion_tpu_torch.cli import infer as cli_infer
from incomplete_multimodal_fusion_tpu_torch.cli import pretrain as cli_pretrain
from incomplete_multimodal_fusion_tpu_torch.cli import train_downstream as cli_downstream
from incomplete_multimodal_fusion_tpu_torch.train import downstream, pretrain
from incomplete_multimodal_fusion_tpu_torch.utils import checkpoint as ckpt_lib
from incomplete_multimodal_fusion_tpu_torch.utils import torch_convert

KERNEL_REL_L2 = 2e-2  # bf16 kernel vs bf16 plain version, same inputs
SERVING_REL_L2 = 5e-2  # whole bf16 forward, kernels vs plain path
# train step, kernels vs plain path on the same weights and masks: bf16
# rounding at other places, and the order of the gathers' scatter-add
# backward on the card varies from run to run
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL_L2 = 5e-2
# K4 / K4b in f32 against their f32 plain versions: only the order of the
# sums differs (K4b's dV sums in an order its shared-memory adds set, run
# to run)
MSDA_REL_L2 = 1e-4
# K5 / K5b in f32 against the plain point sample: the same four taps
POINTS_REL_L2 = 1e-5
# segmentation forward (bf16 backbone, f32 head), kernels vs plain path
SEG_REL_L2 = 5e-2
# the f32 instances of K1-K3 / K6 against their f32 plain versions: f32
# operands, products and sums on both sides, only the order differs (TF32
# off: phase_device sets both flags)
F32_REL_L2 = 1e-5
# a whole f32 step, kernel path vs plain path on the same weights and
# masks: f32 throughout; the gathers' scatter-add backward on the card sums
# in an order that varies from run to run
F32_LOSS_REL = 1e-4
F32_GRAD_REL_L2 = 1e-3
SEED = 0
# an H100 SXM's published peaks (NVIDIA data sheet): dense bf16 and TF32
# tensor-core and f32 CUDA-core operations per second, HBM3 bytes per
# second. The f32 instances' products have two routes to f32 accuracy: the
# CUDA cores (PEAK_F32) or the tensor cores in three TF32 parts (3xTF32,
# PEAK_TF32 / 3); their rows' bound takes the faster, PEAK_F32_PRODUCTS
# (K4 / K5's sampling is no product: PEAK_F32)
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
PEAK_F32_PRODUCTS = max(PEAK_F32, PEAK_TF32 / 3)
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


def back_to_back_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call, CUDA events around ``reps`` calls launched
    back to back: the host runs ahead, so this is the device's time unless
    the host's launch work per call is the longer."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(fn, own=None, reps: int = 10, warmup: int = 3):
    """Device time of one call of ``fn`` from torch.profiler: the summed
    durations of the device kernels and copies (one stream, so their sum is
    the busy time) whose name holds ``own`` (a string or a tuple of strings,
    any of which; all of them for None) over ``reps`` calls, per call; how
    many such events a call had; and the ms per call by name."""
    if isinstance(own, str):
        own = (own,)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_name = collections.Counter()
    count = 0
    for evt in prof.events():
        # device kernels and copies; not the ranges that annotate them
        # (``Optimizer.step`` appears on the device timeline too)
        if (evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation
                and (own is None or any(o in evt.name for o in own))):
            per_name[evt.name] += evt.device_time_total / reps / 1e3
            count += 1
    return sum(per_name.values()), count / reps, per_name


def kernel_name(name: str) -> str:
    """A device kernel's name without return type, namespace, template and
    arguments."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].split(" ")[-1]


WIDE = "(base, wide path)"  # the label of K2 / K2b rows past their row paths' widths
WIDE_LARGE = "(large, wide path)"


def entry_kernels(entry: str, label: str = ""):
    """The device kernels of one call of a phase-3 entry's wrapper (on the
    row ``label``): the substrings of their names, and how many the call
    launches (K4, K3 and K3b: one kernel at every shape, its instantiation
    chosen by the operands' widths and alignment; K5b one, its fixed-point
    kernel or, past shared memory, the global-atomics one). K2's forward and K4b
    launch 1 here; phase 3 takes their count
    on a row from their libraries' plans (``cuda_ffn.forward_kernels``,
    ``cuda_msda.backward_kernels``), which split the work over more kernels
    at some shapes."""
    backward = entry.endswith("backward")
    if is_f32(entry):  # the f32 instances (ffn_tf32.cuh, simt_f32.cuh, zorro_attention_f32.cuh, K3 on float)
        if entry.startswith(("zorro_attention_qkv/", "zorro_attention_packed/", "zorro_sparse/")):
            return ("zorro_attention_f32",), 2 if backward else 1  # K1b: dq, dk/dv
        if entry.startswith("fused_ffn/"):  # ffn_tf32.cuh: the weights' split and the row kernel (forward;
            # with the hidden split's reduction 3), + the weight gradients and simt_f32's reduction (backward);
            # past d 256 the wide path (ffn_tf32_wide.cuh with simt_f32's LayerNorm, column sums and
            # reduction; cuda_ffn.forward_kernels_f32 / backward_kernels_f32 on a row)
            return ("ffn_tf32", "simt_f32"), 4 if backward else 2
        if entry.startswith("fused_block_attn/"):  # fused_block_attn.cu: ffn_tf32_wide.cuh's products and
            # weight splits, simt_f32's LayerNorms and reduction, K1 / K1b f32; forward 6, backward 13
            return ("ffn_tf32_wide", "simt_f32", "zorro_attention_f32"), 13 if backward else 6
    if entry.startswith("fused_ffn/") and backward and label.endswith("wide path)"):  # K2b's wide path (WIDE,
        # WIDE_LARGE): (norm), rows, dx, (LN), wgrad's two
        return ("ffn_bwd", "wgrad"), 6 if entry.startswith("fused_ffn/geglu") else 4
    if entry.startswith(("zorro_attention_qkv/", "zorro_attention_packed/", "zorro_sparse/")):
        return ("zorro_attention",), 2 if backward else 1  # K1b: dq, dk/dv
    if entry.startswith("fused_ffn/"):  # K2b: row pass, weight-gradient product, reduction
        return (("ffn_bwd", "wgrad"), 3) if backward else (("ffn_fwd",), 1)
    if entry.startswith("fusion_row_attention/"):
        return ("fusion_row_bwd",) if backward else ("fusion_row_kernel",), 1
    if entry.startswith("ms_deform_attn/"):
        return ("ms_deform_attn_bwd",) if backward else ("ms_deform_attn_fwd",), 1
    if entry.startswith("point_sample/"):
        return ("point_sample_bwd",) if backward else ("point_sample_fwd",), 1
    if entry.startswith("fused_block_attn/"):  # K6: projection, K1, out projection; K6b: projection, dout,
        # K1 with its D epilogue, K1b's two, the row pass, wgrad's two
        return (("block_attn", "zorro_attention", "wgrad"), 8) if backward else (("block_attn", "zorro_attention"), 3)
    raise KeyError(entry)


def is_f32(entry: str) -> bool:
    """Whether a launch key is an f32 instance's ("zorro_f32",
    "geglu_f32_backward", "f32_forward", ...)."""
    return "f32" in entry.split("/")[1]


def f32_key(entry: str) -> str:
    """The launch key of the f32 instance of a bf16 entry: "zorro" ->
    "zorro_f32", "zorro_backward" -> "zorro_f32_backward", "forward" ->
    "f32_forward"."""
    kernel, mode = entry.split("/")
    if mode in ("forward", "backward"):
        return f"{kernel}/f32_{mode}"
    if mode.endswith("_backward"):
        return f"{kernel}/{mode[:-len('_backward')]}_f32_backward"
    return f"{kernel}/{mode}_f32"


def device_only_ms(fn, names, per_call: int, tries: int = 3):
    """The kernels' own device time of one call ``fn`` of a wrapper from the
    profiler, apart from the wrapper's host work: the device kernels whose
    name holds any of ``names``, ``per_call`` of them a call, their event
    count checked against the wrappers' launch counters. The profiler may
    drop events, so it is run up to ``tries`` times; where every run falls
    short the time is None, never a time taken another way. Returns (ms or
    None, how it was measured, with a multi-kernel call's split by
    kernel)."""
    for _ in range(tries):
        before = sum(ops.kernel_launches().values())
        ms, events, per_name = profiled_ms(fn, own=names)
        launched = (sum(ops.kernel_launches().values()) - before) / 13  # 3 warm-ups and 10 profiled calls
        if events == launched * per_call:
            split = " = " + " + ".join(f"{kernel_name(k)} {v:.6g}" for k, v in sorted(per_name.items())) \
                if per_call > 1 else ""
            return ms, "profiler" + split
    return None, f"not measured: the profiler saw {events:g} of {launched * per_call:g} kernels, {tries} runs"


def library_device_ms(fn, tries: int = 3):
    """The device time of one library call (all its kernels) from the
    profiler, up to ``tries`` runs; None where it saw no kernel in any."""
    for _ in range(tries):
        ms, events, _ = profiled_ms(fn)
        if events > 0:
            return ms, "profiler"
    return None, f"not measured: the profiler saw no kernel, {tries} runs"


def fmt_ms(ms) -> str:
    return "-" if ms is None else f"{ms:.6g} ms"


HAND_WRITTEN = ("zorro_attention", "ffn_fwd", "ffn_bwd", "wgrad", "fusion_row", "ms_deform_attn",
                "point_sample", "block_attn", "simt_f32", "ffn_tf32")
MATMUL_LIBRARY = ("gemm", "cutlass", "xmma", "cublas", "nvjet")


def device_breakdown(fn, reps: int = 5, top_n=8):
    """Device time of one call of ``fn`` from torch.profiler over ``reps``
    calls (``profiled_ms``, no warm-up): total ms, the count of device
    kernels and copies, ms by kind (the hand-written kernels, the matmul
    library, everything else) and the top ``top_n`` by name (all of them for
    None)."""
    total, count, per_name = profiled_ms(fn, reps=reps, warmup=0)
    by_kind = collections.Counter()
    for name, ms in per_name.items():
        low = name.lower()
        kind = ("hand-written" if any(k in low for k in HAND_WRITTEN) else
                "matmul library" if any(k in low for k in MATMUL_LIBRARY) else "other")
        by_kind[kind] += ms
    return total, count, dict(by_kind), per_name.most_common(top_n)


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
    """The PAD-coded int32 token types the model hands kernel K1
    (multimae.pack_tokens)."""
    types = packed_token_types(mi.order, (f,) * n_dom, e, f, n_dom)
    valid = packed_valid(mi.num_visible, e, f)
    return torch.where(valid, types, torch.full_like(types, cuda_attn.PAD_TYPE)).to(torch.int32)


def heads_layout(qkv, heads):
    """q, k, v of a fused [B, N, 3I] slab as contiguous [B, H, N, dh], the
    layout scaled_dot_product_attention takes."""
    b, n, three_i = qkv.shape
    return [t.reshape(b, n, heads, -1).transpose(1, 2).contiguous() for t in qkv.chunk(3, dim=-1)]


def zorro_mask(types):
    """The zorro mask [B, N, N] of PAD-coded types (fusion type 3), or None."""
    return None if types is None else zorro_mask_from_padded_types(types, 3, cuda_attn.PAD_TYPE)


def sdpa_case(qkv, heads, mask, part: str):
    """One PyTorch call computing K1's function (``part`` 'forward'), its
    gradient ('backward', on a retained graph) or both in turn
    ('forward+backward'): scaled_dot_product_attention with ``mask`` [B, N, N]
    (the zorro mask, or that and the tile activity) as a boolean mask, or
    with none. Timed as library_ms; the port never calls it."""
    F = torch.nn.functional
    q, k, v = (t.requires_grad_(part != "forward") for t in heads_layout(qkv, heads))
    mask = None if mask is None else mask[:, None]
    if part == "forward":
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    do = torch.randn_like(out)
    if part == "backward":
        return lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    return lambda: torch.autograd.grad(F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                                       (q, k, v), do)


def sdpa_outputs(qkv, heads, mask, do=None):
    """``sdpa_case``'s library call as a function returning its result in the
    plain version's layout: the output [B, N, I], or with ``do`` [B, N, I]
    the gradient [B, N, 3I] of the output against it; to hold the yardstick
    itself against the plain version."""
    F = torch.nn.functional
    b, n, _ = qkv.shape
    mask = None if mask is None else mask[:, None]

    def flat(t):
        return t.transpose(1, 2).reshape(b, n, -1)

    def run():
        q, k, v = (t.requires_grad_(do is not None) for t in heads_layout(qkv, heads))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        if do is None:
            return flat(out)
        grads = torch.autograd.grad(out, (q, k, v), do.reshape(b, n, heads, -1).transpose(1, 2))
        return torch.cat([flat(t) for t in grads], dim=-1)
    return run


def peak_of(t: torch.Tensor) -> float:
    """The card's peak rate of products in t's dtype: bf16 on the tensor
    cores; f32 the faster of the CUDA cores and 3xTF32 (PEAK_F32_PRODUCTS)."""
    return PEAK_F32_PRODUCTS if t.dtype == torch.float32 else PEAK_BF16


def attention_work(qkv, heads, mask, backward: bool):
    """Operations and bytes of K1 (or K1b) on these inputs: 4 (10 backward)
    flops per allowed (query, key) pair and head dim element -- the products
    over pairs ``mask`` [B, N, N] allows, what these inputs need -- against
    the qkv (and o, dO, lse, dqkv) bytes; at the peak of qkv's dtype."""
    b, n, three_i = qkv.shape
    dh = three_i // 3 // heads
    pairs = b * n * n if mask is None else int(mask.sum())
    if not backward:
        return 4.0 * pairs * dh * heads, nbytes(qkv) * 4 / 3, peak_of(qkv)
    return 10.0 * pairs * dh * heads, nbytes(qkv) * 2 + nbytes(qkv) * 2 / 3 + b * heads * n * 4, peak_of(qkv)


def block_attn_work(x, inner, heads, mask, backward: bool):
    """Operations and bytes of K6 (or K6b) on these inputs: the projections
    (2 M D 3I), the attention over the allowed pairs (4 flops per pair and
    head dim element; 12 backward: the recomputed S and P.V, then dP, dV, dQ
    and dK) and the out projection (2 M I D); backward also dout = dy Wo,
    dWqkv, dWo and dhid (2 M D I + 2 M 3I D + 2 M D I + 2 M 3I D). Bytes: x
    and y (backward x, dy and dx), the weights (and their gradients) and the
    types, each moved once."""
    b, n, d = x.shape
    m, dh = b * n, inner // heads
    pairs = int(mask.sum())
    weights = (4 * inner * d + 2 * d) * x.element_size()
    proj = 2.0 * m * d * 3 * inner
    if not backward:
        return proj + 4.0 * pairs * dh * heads + 2.0 * m * inner * d, 2 * nbytes(x) + weights + m * 4, peak_of(x)
    flops = proj + 2.0 * m * d * inner + 12.0 * pairs * dh * heads + 2 * (2.0 * m * 3 * inner * d) \
        + 2.0 * m * d * inner
    return flops, 3 * nbytes(x) + 2 * weights + m * 4, peak_of(x)


MSDA_LEVELS = ((8, 8), (16, 16), (32, 32))  # the pixel decoder's levels at 256^2, low -> high


def msda_inputs(dev, g, b, heads=8, dim=32, points=4, near_reference=False, levels=MSDA_LEVELS, lq=None):
    """K4's operands, f32, at the pixel decoder's shapes (``levels``, every
    position a query) or another call site's (``levels``, ``lq`` queries):
    locations uniform in [-0.1, 1.1], or with ``near_reference`` each
    query's level reference point plus N(0, 2 pixels) offsets, as a trained
    decoder's samples lie."""
    s = sum(h * w for h, w in levels)
    lq = s if lq is None else lq
    l = len(levels)
    value = torch.randn(b, s, heads, dim, device=dev, generator=g)
    if near_reference:
        ref = reference_points_for(levels, device=dev)[None, :, None, :, None, :]
        size = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32, device=dev)
        noise = 2.0 * torch.randn(b, s, heads, l, points, 2, device=dev, generator=g)
        locs = ref + noise / size[None, None, None, :, None, :]
    else:
        locs = -0.1 + 1.2 * torch.rand(b, lq, heads, l, points, 2, device=dev, generator=g)
    aw = torch.softmax(torch.randn(b, lq, heads, l * points, device=dev, generator=g), dim=-1)
    return value, locs, aw.reshape(b, lq, heads, l, points).contiguous()


def msda_live(locs, levels=MSDA_LEVELS):
    """Samples of these locations with a tap inside their level."""
    live = 0
    for lid, (h, w) in enumerate(levels):
        px = locs[:, :, :, lid, :, 0] * w - 0.5
        py = locs[:, :, :, lid, :, 1] * h - 0.5
        live += int(((px > -1) & (px < w) & (py > -1) & (py < h)).sum())
    return live


def msda_work(value, locs, aw, levels=MSDA_LEVELS):
    """Operations and bytes of K4 on these inputs: 10 f32 operations per
    channel of each sample with a tap inside its level (4 corner products
    and adds, the weighting; a sample wholly outside contributes nothing
    and is not counted), against value, locations, weights and the output
    each moved once."""
    b, s, m, d = value.shape
    out_bytes = b * locs.shape[1] * m * d * 4
    return 10.0 * msda_live(locs, levels) * d, nbytes(value, locs, aw) + out_bytes, PEAK_F32


def msda_bwd_work(value, locs, aw, dout, levels=MSDA_LEVELS):
    """Operations and bytes of K4b on these inputs: 16 f32 operations per
    channel of each live sample (per tap: the <v, g> product and the dV
    term's product and add), against value, locations, weights and dOut
    read once and dV, dlocations, dweights written once."""
    d = value.shape[-1]
    return 16.0 * msda_live(locs, levels) * d, 2 * nbytes(value, locs, aw) + nbytes(dout), PEAK_F32


# the ViT-Adapter's interactions at 256^2, 6 heads x 32, 4 points: the
# injector's 256 fusion tokens over the priors' levels 32^2 / 16^2 / 8^2
# (high -> low resolution, S = 1344), the extractor's 1344 priors over the
# 16^2 token map (one level)
ADAPTER_MSDA = (("injector", ((32, 32), (16, 16), (8, 8)), 256), ("extractor", ((16, 16),), 1344))


# the criterion's point-sampling calls at B = 30, G = 8, 100 queries,
# 12544 points (set_criterion.py:162-163, :86, :242-244): (label, masks,
# coords rows, group)
POINT_SHAPES = (("matcher queries [3000, 64^2] x 12544, shared per image", (3000, 64, 64), 30, 100),
                ("matcher targets [240, 256^2] x 12544, shared per image", (240, 256, 256), 30, 8),
                ("targets [240, 256^2] x 12544", (240, 256, 256), 240, 1),
                ("uncertainty [240, 64^2] x 37632", (240, 64, 64), 240, 1),
                ("loss predictions [240, 64^2] x 12544", (240, 64, 64), 240, 1))


def grid_sample_case(masks, coords, group, ds=None):
    """One PyTorch call computing K5's function (K5b's dmasks with ``ds``):
    F.grid_sample of the masks at 2 * coords - 1, align_corners=False, the
    grid built (and repeated per group) beforehand. Timed as library_ms; the
    port never calls it."""
    F = torch.nn.functional
    grid = (2.0 * coords - 1.0).repeat_interleave(group, dim=0)[:, None]  # [N, 1, P, 2]
    if ds is None:
        return lambda: F.grid_sample(masks[:, None], grid, align_corners=False)
    m = masks.detach().clone().requires_grad_()
    out = F.grid_sample(m[:, None], grid, align_corners=False)[:, 0, 0]
    return lambda: torch.autograd.grad(out, m, ds, retain_graph=True)


def criterion_points(dev, g, n: int = 240, size: int = 64, points: int = 12544):
    """Mask logits [n, size, size] and the points the set criterion samples
    on them for its mask losses (losses/set_criterion.uncertain_point_coords:
    3 x oversampled uniform points, the 75% most uncertain kept, the rest
    fresh uniform ones; its point sampling runs K5): seeded logits that are
    smooth blobs (8^2 noise upsampled bilinearly, x 4), as predicted masks
    are, so the kept points cluster on the masks' edges."""
    low = torch.randn(n, 1, 8, 8, device=dev, generator=g)
    logits = 4.0 * torch.nn.functional.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
    logits = logits[:, 0].contiguous()
    return logits, set_criterion.uncertain_point_coords(g, logits, points)


def fusion_row_stacked(q, kv_grid, kv_f, heads: int):
    """K3's operands in scaled_dot_product_attention's layout: each fusion
    position's query [B * F, h, 1, dh] and the keys and values of its T + 1
    slots (the fusion token's own last) stacked to [B * F, h, T + 1, dh]."""
    b, f, inner = q.shape
    t_mod, dh = kv_grid.shape[1] // f, inner // heads
    k_g, v_g = kv_grid.reshape(b, t_mod, f, 2, heads, dh).permute(3, 0, 2, 4, 1, 5).unbind(0)  # [B, F, h, T, dh]
    k_f, v_f = kv_f.reshape(b, f, 2, heads, dh).permute(2, 0, 1, 3, 4)[..., None, :].unbind(0)
    k, v = (torch.cat([s_g, s_f], dim=3).reshape(b * f, heads, t_mod + 1, dh) for s_g, s_f in ((k_g, k_f), (v_g, v_f)))
    return q.reshape(b * f, heads, 1, dh), k, v


def fusion_row_sdpa_case(q, kv_grid, kv_f, heads: int, part: str):
    """One PyTorch call computing K3's function ('forward') or its gradient
    ('backward', on a retained graph, the output gradient drawn from the
    global generator): scaled_dot_product_attention on the operands stacked
    beforehand by ``fusion_row_stacked`` (the stacking is not timed). Timed
    as library_ms; the port never calls it."""
    F = torch.nn.functional
    qh, k, v = (t.detach().requires_grad_(part != "forward") for t in fusion_row_stacked(q, kv_grid, kv_f, heads))
    if part == "forward":
        return lambda: F.scaled_dot_product_attention(qh, k, v)
    out = F.scaled_dot_product_attention(qh, k, v)
    do = torch.randn_like(out)
    return lambda: torch.autograd.grad(out, (qh, k, v), do, retain_graph=True)


def gathered_types_case(dev, b: int = 60, e: int = 384, f: int = 256):
    """K1's PAD-coded types over the 2E layout of ``lstm`` / ``crossattn_v1``
    (models/multimae.gathered_layout) at B = 60, e = 384: seeded random
    masks whose rows keep 384, 300, 256 or 128 tokens, a modality dropped
    whole in every row that keeps fewer than 384, so the padding sits in
    the middle of the sequence and again at its end."""
    rng = np.random.default_rng(SEED + 14)
    flat = np.ones((b, 3 * f), np.int64)
    for row in range(b):
        keep = (384, 300, 256, 128)[row % 4]
        allowed = np.arange(3 * f)
        if keep < e:
            dropped = row % 3
            allowed = allowed[(allowed < dropped * f) | (allowed >= (dropped + 1) * f)]
        flat[row, rng.choice(allowed, size=keep, replace=False)] = 0
    mi = masking.mask_info_from_flat_mask(torch.from_numpy(flat).to(dev), ("s1", "s2", "dem"), (f,) * 3, e)
    return gathered_layout(mi, e, f, 3).kernel_types


def unfused_geglu(x, gamma, w_in, w_out):
    """K2's GEGLU function as the unfused PyTorch chain: F.layer_norm (no
    bias), F.linear, the GEGLU product, F.linear, in bf16 (cuBLAS). Printed
    beside the K2 rows for reference; not the library column, and the port
    never calls it."""
    F = torch.nn.functional
    inner = w_out.shape[1]

    def run():
        u = F.linear(F.layer_norm(x, (x.shape[1],), gamma, None, 1e-5), w_in)
        return F.linear(u[:, :inner] * F.gelu(u[:, inner:]), w_out)
    return run


def unfused_mlp(x, w1, b1, w2, b2):
    """K2's MLP function as the unfused chain F.linear, F.gelu, F.linear
    (bf16, cuBLAS), for reference beside the K2 rows."""
    F = torch.nn.functional
    return lambda: F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)


def unfused_backward(chain, operands, dy):
    """The autograd backward of an unfused chain (``unfused_geglu`` or
    ``unfused_mlp``) on ``operands``, every operand's gradient against
    ``dy``: the yardstick beside the bf16 K2b rows. The forward runs once
    here; each call replays the backward of its graph."""
    leaves = [t.detach().requires_grad_(True) for t in operands]
    y = chain(*leaves)()
    return lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)


def unfused_block_attn(types, heads: int, fusion_type: int):
    """K6's function as the unfused chain on these types: F.layer_norm twice
    (no bias), F.linear for q and kv, K1's operator, F.linear plus the
    residual, in the operands' dtype (f32 with TF32 off); its backward is
    autograd's (K1b for the attention). Returns chain(x, g1, g2, wq, wkv, wo)
    for ``unfused_backward``. Printed beside the K6 rows for reference; not
    the library column, and the port never calls it."""
    F = torch.nn.functional

    def chain(x, g1, g2, wq, wkv, wo):
        d = x.shape[-1]

        def run():
            h = F.layer_norm(F.layer_norm(x, (d,), g1, None, 1e-5), (d,), g2, None, 1e-5)
            qkv = torch.cat([F.linear(h, wq), F.linear(h, wkv)], dim=-1)
            return x + F.linear(cuda_attn.zorro_attention_qkv(qkv, heads, types, fusion_type), wo)
        return run
    return chain


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
    chains = {}  # the unfused chain beside the K2, K2b and K6 / K6b rows, for reference only
    separate = {}  # single-task K2 launches beside the task-axis rows, for reference only
    per_call = {}  # kernels a call of K2's forward and K4b, from their libraries' plans
    yardstick = {}  # the f32 attention rows' SDPA call in the plain version's layout (sdpa_outputs)

    def zorro_cases(entry_mode, label, qkv, heads, types, main):
        cases.append((f"zorro_attention_qkv/{entry_mode}", label,
                      lambda: cuda_attn.zorro_attention_qkv(qkv, heads, types, 3),
                      lambda: cuda_attn.zorro_attention_qkv_reference(qkv, heads, types, 3),
                      attention_work(qkv, heads, zorro_mask(types), False),
                      sdpa_case(qkv, heads, zorro_mask(types), "forward"), main))

    def zorro_bwd_cases(entry_mode, label, qkv, heads, types, main):
        o, lse = cuda_attn.zorro_attention_qkv(qkv, heads, types, 3, return_lse=True)
        do = randn(*o.shape)
        entry = f"zorro_attention_qkv/{entry_mode}_backward"
        cases.append((entry, label,
                      lambda: cuda_attn.zorro_attention_qkv_backward(qkv, types, o, lse, do, heads, 3),
                      lambda: cuda_attn.zorro_attention_qkv_backward_reference(qkv, types, o, lse, do,
                                                                               heads, 3),
                      attention_work(qkv, heads, zorro_mask(types), True),
                      sdpa_case(qkv, heads, zorro_mask(types), "backward"), main))
        fwd_bwd[entry, label] = sdpa_case(qkv, heads, zorro_mask(types), "forward+backward")

    # serving shapes (the forward kernels' main shapes in the kernels line)
    for label, b, types in (("N=1024 B=1 all modalities", 1, drop_types(1, ())),
                            ("N=1024 B=1 dem dropped", 1, drop_types(1, ("dem",))),
                            ("N=1024 B=4 s2 dropped", 4, drop_types(4, ("s2",))),
                            ("N=512 B=8 random masks e=256", 8, packed_types(rand_mi, 256, f, 3))):
        zorro_cases("zorro", label, randn(b, types.shape[1], 3 * 192), 3, types,
                    b == 1 and "all" in label)
    for b in (1, 8):
        zorro_cases("none", f"n=256 8x32 B={b}", randn(b, 256, 3 * 256), 8, None, b == 8)
    # the segmentation and segment-train shape: forward and backward
    qkv_seg, seg_types = randn(30, 1024, 3 * 192), drop_types(30, ())
    zorro_cases("zorro", "N=1024 B=30 all modalities", qkv_seg, 3, seg_types, False)
    zorro_bwd_cases("zorro", "N=1024 B=30 all modalities", qkv_seg, 3, seg_types, False)
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

    # K1's separate-q/k/v and tile-skip modes at the training shape and masks
    train_label = "N=640 B=60 train masks e=384"
    q_t, k_t, v_t = (t.contiguous() for t in qkv_train.chunk(3, dim=-1))
    sparse_mask = cuda_zorro_sparse.sparse_allowed(train_types, 3)
    o_p, lse_p = cuda_attn.zorro_attention_packed(q_t, k_t, v_t, train_types, 3, 3, return_lse=True)
    o_s, lse_s = cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv_train, train_types, 3, 3, return_lse=True)
    do_t = randn(*o_p.shape)
    cases.append(("zorro_attention_packed/zorro", train_label,
                  lambda: cuda_attn.zorro_attention_packed(q_t, k_t, v_t, train_types, 3, 3),
                  lambda: cuda_attn.zorro_attention_packed_reference(q_t, k_t, v_t, train_types, 3, 3),
                  attention_work(qkv_train, 3, zorro_mask(train_types), False),
                  sdpa_case(qkv_train, 3, zorro_mask(train_types), "forward"), True))
    cases.append(("zorro_attention_packed/zorro_backward", train_label,
                  lambda: cuda_attn.zorro_attention_packed_backward(q_t, k_t, v_t, train_types, o_p, lse_p, do_t,
                                                                    3, 3),
                  lambda: cuda_attn.zorro_attention_packed_backward_reference(q_t, k_t, v_t, train_types, o_p,
                                                                              lse_p, do_t, 3, 3),
                  attention_work(qkv_train, 3, zorro_mask(train_types), True),
                  sdpa_case(qkv_train, 3, zorro_mask(train_types), "backward"), True))
    cases.append(("zorro_sparse/forward", train_label,
                  lambda: cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv_train, train_types, 3, 3),
                  lambda: cuda_zorro_sparse.zorro_sparse_attention_qkv_reference(qkv_train, train_types, 3, 3),
                  attention_work(qkv_train, 3, sparse_mask, False), sdpa_case(qkv_train, 3, sparse_mask, "forward"),
                  True))
    cases.append(("zorro_sparse/backward", train_label,
                  lambda: cuda_zorro_sparse.zorro_sparse_attention_qkv_backward(qkv_train, train_types, o_s, lse_s,
                                                                                do_t, 3, 3),
                  lambda: cuda_zorro_sparse.zorro_sparse_attention_qkv_backward_reference(
                      qkv_train, train_types, o_s, lse_s, do_t, 3, 3),
                  attention_work(qkv_train, 3, sparse_mask, True), sdpa_case(qkv_train, 3, sparse_mask, "backward"),
                  True))
    fwd_bwd["zorro_attention_packed/zorro_backward", train_label] = sdpa_case(
        qkv_train, 3, zorro_mask(train_types), "forward+backward")
    fwd_bwd["zorro_sparse/backward", train_label] = sdpa_case(qkv_train, 3, sparse_mask, "forward+backward")

    # K6 / K6b, the fused attention half-block, at the training shape: the
    # encoder block's widths (D = I = 192, 3 heads x 64)
    x_blk, dy_blk = randn(60, 640, 192), randn(60, 640, 192)
    blk_w = ((1 + 0.1 * torch.randn(192, device=dev, generator=g)).to(bf),
             (1 + 0.1 * torch.randn(192, device=dev, generator=g)).to(bf),
             randn(192, 192, scale=192 ** -0.5), randn(384, 192, scale=192 ** -0.5),
             randn(192, 192, scale=192 ** -0.5))
    cases.append(("fused_block_attn/forward", train_label,
                  lambda: cuda_block_attn.fused_block_attn(x_blk, train_types, *blk_w, 3, 3),
                  lambda: cuda_block_attn.fused_block_attn_reference(x_blk, train_types, *blk_w, 3, 3),
                  block_attn_work(x_blk, 192, 3, zorro_mask(train_types), False), None, True))
    cases.append(("fused_block_attn/backward", train_label,
                  lambda: cuda_block_attn.fused_block_attn_backward(x_blk, train_types, *blk_w, dy_blk, 3, 3),
                  lambda: cuda_block_attn.fused_block_attn_backward_reference(x_blk, train_types, *blk_w, dy_blk,
                                                                              3, 3),
                  block_attn_work(x_blk, 192, 3, zorro_mask(train_types), True), None, True))
    chains["fused_block_attn/forward", train_label] = unfused_block_attn(train_types, 3, 3)(x_blk, *blk_w)
    chains["fused_block_attn/backward", train_label] = unfused_backward(unfused_block_attn(train_types, 3, 3),
                                                                        (x_blk, *blk_w), dy_blk)

    def ffn_work(m, backward, geglu, d=d, inner_ff=inner_ff, dd=dd, hid=hid, elem=2, peak=PEAK_BF16):
        if geglu:
            weights = 3 * inner_ff * d + d
            flops = (16 if backward else 6) * m * d * inner_ff
            acts = (3 if backward else 2) * m * d
        else:
            weights = 2 * hid * dd + hid + dd
            flops = (6 if backward else 2) * m * dd * hid + (4 if backward else 2) * m * hid * dd
            acts = (3 if backward else 2) * m * dd
        return flops, elem * (acts + (2 if backward else 1) * weights), peak

    def geglu_case(label, x, w, main, work):
        cases.append(("fused_ffn/geglu", label, lambda: cuda_ffn.geglu_ffn(x, *w),
                      lambda: cuda_ffn.geglu_ffn_reference(x, *w), work, None, main))
        chains["fused_ffn/geglu", label] = unfused_geglu(x, *w)
        per_call["fused_ffn/geglu", label] = cuda_ffn.forward_kernels(True, *x.shape, w[2].shape[1], x.shape[1])

    def mlp_case(label, x, w, main, work):
        cases.append(("fused_ffn/mlp", label, lambda: cuda_ffn.mlp_ffn(x, *w),
                      lambda: cuda_ffn.mlp_ffn_reference(x, *w), work, None, main))
        chains["fused_ffn/mlp", label] = unfused_mlp(x, *w)
        per_call["fused_ffn/mlp", label] = cuda_ffn.forward_kernels(False, *x.shape, w[0].shape[0], w[2].shape[0])

    for m in (1024, 256, 4096, 38400, 15360):
        geglu_case(f"M={m} d=192 I=512", randn(m, d), geglu_w, m == 1024, ffn_work(m, False, True))
    # an M that is not a multiple of the 128-row tile
    geglu_case("M=15300 d=192 I=512", randn(15300, d), geglu_w, False, ffn_work(15300, False, True))
    # beside each bf16 K2b row the chain: the unfused bf16 chain's autograd
    # backward (cuBLAS products), as the f32 rows carry the f32 chain's
    for m in (38400, 15360):
        x, dy = randn(m, d), randn(m, d)
        cases.append(("fused_ffn/geglu_backward", f"M={m} d=192 I=512",
                      lambda x=x, dy=dy: cuda_ffn.geglu_ffn_backward(x, *geglu_w, dy),
                      lambda x=x, dy=dy: cuda_ffn.geglu_ffn_backward_reference(x, *geglu_w, dy),
                      ffn_work(m, True, True), None, m == 38400))
        chains["fused_ffn/geglu_backward", f"M={m} d=192 I=512"] = unfused_backward(unfused_geglu, (x, *geglu_w), dy)
    for m in (256, 2048, 15360):
        mlp_case(f"M={m} d=256 H=1024", randn(m, dd), mlp_w, m == 2048, ffn_work(m, False, False))
    x, dy = randn(15360, dd), randn(15360, dd)
    cases.append(("fused_ffn/mlp_backward", "M=15360 d=256 H=1024",
                  lambda: cuda_ffn.mlp_ffn_backward(x, *mlp_w, dy),
                  lambda: cuda_ffn.mlp_ffn_backward_reference(x, *mlp_w, dy),
                  ffn_work(15360, True, False), None, True))
    chains["fused_ffn/mlp_backward", "M=15360 d=256 H=1024"] = unfused_backward(unfused_mlp, (x, *mlp_w), dy)

    # K2's and K2b's wide paths at the `base` widths (d = 768, I = 2048,
    # H = 3072), past the row paths' d <= 256; no main path runs them
    bd, b_inner, b_hid = 768, 2048, 3072
    base_geglu_w = ((1 + 0.1 * torch.randn(bd, device=dev, generator=g)).to(bf),
                    randn(2 * b_inner, bd, scale=bd ** -0.5), randn(bd, b_inner, scale=b_inner ** -0.5))
    base_mlp_w = (randn(b_hid, bd, scale=bd ** -0.5), randn(b_hid, scale=0.1), randn(bd, b_hid, scale=b_hid ** -0.5),
                  randn(bd, scale=0.1))
    x_base, dy_base = randn(8192, bd), randn(8192, bd)
    geglu_case(f"M=8192 d={bd} I={b_inner} {WIDE}", x_base, base_geglu_w, False,
               ffn_work(8192, False, True, d=bd, inner_ff=b_inner))
    mlp_case(f"M=8192 d={bd} H={b_hid} {WIDE}", x_base, base_mlp_w, False,
             ffn_work(8192, False, False, dd=bd, hid=b_hid))
    cases.append(("fused_ffn/geglu_backward", f"M=8192 d={bd} I={b_inner} {WIDE}",
                  lambda: cuda_ffn.geglu_ffn_backward(x_base, *base_geglu_w, dy_base),
                  lambda: cuda_ffn.geglu_ffn_backward_reference(x_base, *base_geglu_w, dy_base),
                  ffn_work(8192, True, True, d=bd, inner_ff=b_inner), None, False))
    cases.append(("fused_ffn/mlp_backward", f"M=8192 d={bd} H={b_hid} {WIDE}",
                  lambda: cuda_ffn.mlp_ffn_backward(x_base, *base_mlp_w, dy_base),
                  lambda: cuda_ffn.mlp_ffn_backward_reference(x_base, *base_mlp_w, dy_base),
                  ffn_work(8192, True, False, dd=bd, hid=b_hid), None, False))
    # the `large` widths: d = 1024 and the GEGLU inner width int(1024 * 8 / 3)
    # = 2730, not a multiple of 16, which the wrappers zero-pad to 2736
    ld, l_inner = 1024, 2730
    large_w = ((1 + 0.1 * torch.randn(ld, device=dev, generator=g)).to(bf),
               randn(2 * l_inner, ld, scale=ld ** -0.5), randn(ld, l_inner, scale=l_inner ** -0.5))
    x_large, dy_large = randn(4096, ld), randn(4096, ld)
    geglu_case(f"M=4096 d={ld} I={l_inner} {WIDE_LARGE}", x_large, large_w, False,
               ffn_work(4096, False, True, d=ld, inner_ff=l_inner))
    cases.append(("fused_ffn/geglu_backward", f"M=4096 d={ld} I={l_inner} {WIDE_LARGE}",
                  lambda: cuda_ffn.geglu_ffn_backward(x_large, *large_w, dy_large),
                  lambda: cuda_ffn.geglu_ffn_backward_reference(x_large, *large_w, dy_large),
                  ffn_work(4096, True, True, d=ld, inner_ff=l_inner), None, False))

    for b in (1, 8, 60):
        q, kvg, kvf = randn(b, f, 192), randn(b, 3 * f, 384), randn(b, f, 384)
        work = (4.0 * 64 * 4 * b * f * 3, nbytes(q, kvg, kvf, q), PEAK_F32)
        cases.append(("fusion_row_attention/fusion_row", f"F=256 T=3 3x64 B={b}",
                      lambda q=q, kvg=kvg, kvf=kvf: cuda_fusion_attn.fusion_row_attention(
                          q, kvg, kvf, 3, 64),
                      lambda q=q, kvg=kvg, kvf=kvf: cuda_fusion_attn.fusion_row_attention_reference(
                          q, kvg, kvf, 3, 64), work, fusion_row_sdpa_case(q, kvg, kvf, 3, "forward"), b == 8))
        if b == 60:
            do = randn(b, f, 192)
            work = (8.0 * 64 * 4 * b * f * 3, 2 * nbytes(q, kvg, kvf) + nbytes(do), PEAK_F32)
            cases.append(("fusion_row_attention/fusion_row_backward", "F=256 T=3 3x64 B=60",
                          lambda: cuda_fusion_attn.fusion_row_attention_backward(q, kvg, kvf, do, 3, 64),
                          lambda: cuda_fusion_attn.fusion_row_attention_backward_reference(
                              q, kvg, kvf, do, 3, 64), work, fusion_row_sdpa_case(q, kvg, kvf, 3, "backward"),
                          True))

    # K4 (f32) at the pixel decoder's shapes: levels 8^2, 16^2, 32^2, 8 heads
    # x 32, 4 points, every position a query; random locations in
    # [-0.1, 1.1] and random softmaxed weights, so the samples fall between
    # pixel centres and past the borders; at B = 30 also samples near each
    # query's reference points, to see whether the gathers' locality matters
    for b, near in ((1, False), (30, False), (30, True)):
        value, locs, aw = msda_inputs(dev, g, b, near_reference=near)
        label = f"B={b} Lq=S=1344 8x32 L=3 P=4" + (" near reference" if near else "")
        per_call["ms_deform_attn/backward", label] = cuda_msda.backward_kernels(
            b, locs.shape[1], value.shape[2], value.shape[3], MSDA_LEVELS, locs.shape[4])
        cases.append(("ms_deform_attn/forward", label,
                      lambda v=value, lc=locs, a=aw: cuda_msda.ms_deform_attn(v, MSDA_LEVELS, lc, a),
                      lambda v=value, lc=locs, a=aw: cuda_msda.ms_deform_attn_core(v, MSDA_LEVELS, lc, a),
                      msda_work(value, locs, aw), None, b == 30 and not near))
    # K4b at the same shapes, random locations (off the pixel centres, where
    # the derivative is one-sided, almost surely) and near the reference
    # points, as the trained decoder samples
    for b, near in ((1, False), (30, False), (1, True), (30, True)):
        value, locs, aw = msda_inputs(dev, g, b, near_reference=near)
        dout = torch.randn(b, locs.shape[1], value.shape[2] * value.shape[3], device=dev, generator=g)
        label = f"B={b} Lq=S=1344 8x32 L=3 P=4" + (" near reference" if near else "")
        per_call["ms_deform_attn/backward", label] = cuda_msda.backward_kernels(
            b, locs.shape[1], value.shape[2], value.shape[3], MSDA_LEVELS, locs.shape[4])
        cases.append(("ms_deform_attn/backward", label,
                      lambda v=value, lc=locs, a=aw, do=dout: cuda_msda.ms_deform_attn_backward(
                          v, MSDA_LEVELS, lc, a, do),
                      lambda v=value, lc=locs, a=aw, do=dout: cuda_msda.ms_deform_attn_backward_reference(
                          v, MSDA_LEVELS, lc, a, do),
                      msda_bwd_work(value, locs, aw, dout), None, b == 30 and not near))
    # K4 / K4b (f32) at the ViT-Adapter's call sites (phase 15): random
    # locations off the pixel centres, B = 30 and B = 1 (where K4b splits a
    # slice's queries over blocks)
    for site, levels, lq in ADAPTER_MSDA:
        for b in (30, 1):
            value, locs, aw = msda_inputs(dev, g, b, heads=6, levels=levels, lq=lq)
            dout = torch.randn(b, lq, 6 * 32, device=dev, generator=g)
            s_ = value.shape[1]
            label = f"{site} B={b} Lq={lq} S={s_} 6x32 L={len(levels)} P=4"
            per_call["ms_deform_attn/backward", label] = cuda_msda.backward_kernels(b, lq, 6, 32, levels, 4)
            cases.append(("ms_deform_attn/forward", label,
                          lambda v=value, lc=locs, a=aw, lv=levels: cuda_msda.ms_deform_attn(v, lv, lc, a),
                          lambda v=value, lc=locs, a=aw, lv=levels: cuda_msda.ms_deform_attn_core(v, lv, lc, a),
                          msda_work(value, locs, aw, levels), None, False))
            cases.append(("ms_deform_attn/backward", label,
                          lambda v=value, lc=locs, a=aw, do=dout, lv=levels: cuda_msda.ms_deform_attn_backward(
                              v, lv, lc, a, do),
                          lambda v=value, lc=locs, a=aw, do=dout, lv=levels:
                          cuda_msda.ms_deform_attn_backward_reference(v, lv, lc, a, do),
                          msda_bwd_work(value, locs, aw, dout, levels), None, False))
    # K5 at the criterion's four shapes, K5b at the loss's; coords uniform in
    # [-0.05, 1.05], past the borders too
    for label, (n, h, w), rows, group in POINT_SHAPES:
        masks = torch.randn(n, h, w, device=dev, generator=g)
        coords = -0.05 + 1.1 * torch.rand(rows, 12544 * (3 if "37632" in label else 1), 2, device=dev,
                                          generator=g)
        p = coords.shape[1]
        work = (12.0 * n * p, nbytes(masks, coords) + n * p * 4, PEAK_F32)
        cases.append(("point_sample/forward", label,
                      lambda m=masks, c=coords, gr=group: cuda_points.point_sample(m, c, gr),
                      lambda m=masks, c=coords, gr=group: cuda_points.point_sample_reference(m, c, gr),
                      work, grid_sample_case(masks, coords, group), group == 100))
        if label.startswith("loss"):
            ds = torch.randn(n, p, device=dev, generator=g)
            work = (8.0 * n * p, nbytes(coords, ds, masks), PEAK_F32)  # coords, dS in; dmasks out
            cases.append(("point_sample/backward", label,
                          lambda m=masks, c=coords, d=ds: cuda_points.point_sample_backward(m, c, d)[0],
                          lambda m=masks, c=coords, d=ds: cuda_points.point_sample_backward_reference(
                              m, c, d)[0],
                          work, grid_sample_case(masks, coords, 1, ds), True))
            # the same at the points the criterion samples (clustered on the
            # edges of smooth logits), on those logits
            logits, crit = criterion_points(dev, g, n, h, p)
            cases.append(("point_sample/backward", label + ", criterion's points",
                          lambda m=logits, c=crit, d=ds: cuda_points.point_sample_backward(m, c, d)[0],
                          lambda m=logits, c=crit, d=ds: cuda_points.point_sample_backward_reference(
                              m, c, d)[0],
                          (8.0 * n * p, nbytes(crit, ds, logits), PEAK_F32),
                          grid_sample_case(logits, crit, 1, ds), False))

    # the f32 instances of K1-K3 and K6, each against its f32 plain version
    # at the shapes of the f32 paths (the pretraining step and the
    # downstream backbone in f32); library calls in f32 (TF32 off)
    def randf(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=g) * scale

    def f32_attention_cases(mode, label, qkv, heads, types, main, backward=True):
        fwd, bwd = f"zorro_attention_qkv/{mode}_f32", f"zorro_attention_qkv/{mode}_f32_backward"
        o, lse = cuda_attn.zorro_attention_qkv(qkv, heads, types, 3, return_lse=True)
        do = randf(*o.shape)
        mask = zorro_mask(types)
        cases.append((fwd, label, lambda: cuda_attn.zorro_attention_qkv(qkv, heads, types, 3),
                      lambda: cuda_attn.zorro_attention_qkv_reference(qkv, heads, types, 3),
                      attention_work(qkv, heads, mask, False), sdpa_case(qkv, heads, mask, "forward"), main))
        yardstick[fwd, label] = sdpa_outputs(qkv, heads, mask)
        if backward:
            cases.append((bwd, label,
                          lambda: cuda_attn.zorro_attention_qkv_backward(qkv, types, o, lse, do, heads, 3),
                          lambda: cuda_attn.zorro_attention_qkv_backward_reference(qkv, types, o, lse, do, heads, 3),
                          attention_work(qkv, heads, mask, True), sdpa_case(qkv, heads, mask, "backward"), main))
            yardstick[bwd, label] = sdpa_outputs(qkv, heads, mask, do)

    qkv_train32 = randf(60, 640, 3 * 192)
    f32_attention_cases("zorro", train_label, qkv_train32, 3, train_types, True)
    f32_attention_cases("none", "n=256 8x32 B=60", randf(60, 256, 3 * 256), 8, None, True)
    f32_attention_cases("zorro", "N=1024 B=30 all modalities", randf(30, 1024, 3 * 192), 3, seg_types, False)
    # the f32 serving forward's shape (cli.infer, cli.export_serving): 48 blocks for 132 SMs
    f32_attention_cases("zorro", "N=1024 B=1 all modalities", randf(1, 1024, 3 * 192), 3, drop_types(1, ()), False,
                        backward=False)
    q32, k32, v32 = (t.contiguous() for t in qkv_train32.chunk(3, dim=-1))
    o_p32, lse_p32 = cuda_attn.zorro_attention_packed(q32, k32, v32, train_types, 3, 3, return_lse=True)
    o_s32, lse_s32 = cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv_train32, train_types, 3, 3, return_lse=True)
    do32 = randf(*o_p32.shape)
    train_mask = zorro_mask(train_types)
    cases.append(("zorro_attention_packed/zorro_f32", train_label,
                  lambda: cuda_attn.zorro_attention_packed(q32, k32, v32, train_types, 3, 3),
                  lambda: cuda_attn.zorro_attention_packed_reference(q32, k32, v32, train_types, 3, 3),
                  attention_work(qkv_train32, 3, train_mask, False),
                  sdpa_case(qkv_train32, 3, train_mask, "forward"), True))
    cases.append(("zorro_attention_packed/zorro_f32_backward", train_label,
                  lambda: cuda_attn.zorro_attention_packed_backward(q32, k32, v32, train_types, o_p32, lse_p32, do32,
                                                                    3, 3),
                  lambda: cuda_attn.zorro_attention_packed_backward_reference(q32, k32, v32, train_types, o_p32,
                                                                              lse_p32, do32, 3, 3),
                  attention_work(qkv_train32, 3, train_mask, True),
                  sdpa_case(qkv_train32, 3, train_mask, "backward"), True))
    cases.append(("zorro_sparse/f32_forward", train_label,
                  lambda: cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv_train32, train_types, 3, 3),
                  lambda: cuda_zorro_sparse.zorro_sparse_attention_qkv_reference(qkv_train32, train_types, 3, 3),
                  attention_work(qkv_train32, 3, sparse_mask, False),
                  sdpa_case(qkv_train32, 3, sparse_mask, "forward"), True))
    cases.append(("zorro_sparse/f32_backward", train_label,
                  lambda: cuda_zorro_sparse.zorro_sparse_attention_qkv_backward(qkv_train32, train_types, o_s32,
                                                                                lse_s32, do32, 3, 3),
                  lambda: cuda_zorro_sparse.zorro_sparse_attention_qkv_backward_reference(
                      qkv_train32, train_types, o_s32, lse_s32, do32, 3, 3),
                  attention_work(qkv_train32, 3, sparse_mask, True),
                  sdpa_case(qkv_train32, 3, sparse_mask, "backward"), True))

    def f32_ffn_cases(label, geglu, w, m, main, d_in, d_out, backward=True, **widths):
        """The f32 K2 (and K2b) rows; beside each, the f32 chain's device
        time (the unfused chain forward, its autograd backward; TF32 off),
        device against device."""
        x, dy = randf(m, d_in), randf(m, d_out)
        fwd = ((cuda_ffn.geglu_ffn, cuda_ffn.geglu_ffn_reference, cuda_ffn.geglu_ffn_backward,
                cuda_ffn.geglu_ffn_backward_reference) if geglu else
               (cuda_ffn.mlp_ffn, cuda_ffn.mlp_ffn_reference, cuda_ffn.mlp_ffn_backward,
                cuda_ffn.mlp_ffn_backward_reference))
        mode = "geglu" if geglu else "mlp"
        hidden = w[2].shape[1] if geglu else w[0].shape[0]
        cases.append((f"fused_ffn/{mode}_f32", label, lambda: fwd[0](x, *w), lambda: fwd[1](x, *w),
                      ffn_work(m, False, geglu, elem=4, peak=PEAK_F32_PRODUCTS, **widths), None, main))
        chains[f"fused_ffn/{mode}_f32", label] = (unfused_geglu if geglu else unfused_mlp)(x, *w)
        per_call[f"fused_ffn/{mode}_f32", label] = cuda_ffn.forward_kernels_f32(geglu, m, d_in, hidden, d_out)
        if not backward:
            return
        cases.append((f"fused_ffn/{mode}_f32_backward", label, lambda: fwd[2](x, *w, dy), lambda: fwd[3](x, *w, dy),
                      ffn_work(m, True, geglu, elem=4, peak=PEAK_F32_PRODUCTS, **widths), None, main))
        chains[f"fused_ffn/{mode}_f32_backward", label] = unfused_backward(unfused_geglu if geglu else unfused_mlp,
                                                                            (x, *w), dy)
        per_call[f"fused_ffn/{mode}_f32_backward", label] = cuda_ffn.backward_kernels_f32(geglu, m, d_in, hidden,
                                                                                           d_out)

    geglu_w32, mlp_w32 = tuple(t.float() for t in geglu_w), tuple(t.float() for t in mlp_w)
    f32_ffn_cases("M=38400 d=192 I=512", True, geglu_w32, 38400, True, d, d)
    f32_ffn_cases("M=15360 d=192 I=512", True, geglu_w32, 15360, False, d, d)
    f32_ffn_cases("M=15360 d=256 H=1024", False, mlp_w32, 15360, True, dd, dd)
    # the f32 serving forward's shapes (cli.infer, cli.export_serving): the
    # encoder's and fusion rows' GEGLU, the decoder's MLP at B = 1 and 8
    for m in (1024, 256):
        f32_ffn_cases(f"M={m} d=192 I=512 (serving)", True, geglu_w32, m, False, d, d, backward=False)
    for m in (2048, 256):
        f32_ffn_cases(f"M={m} d=256 H=1024 (serving)", False, mlp_w32, m, False, dd, dd, backward=False)
    # the f32 wide path (past d 256): `base` (phase 9 (d) runs it) and its
    # serving rows (the output product splits its hidden width), `large`
    base_geglu_w32 = tuple(t.float() for t in base_geglu_w)
    f32_ffn_cases(f"M=8192 d={bd} I={b_inner} (base)", True, base_geglu_w32, 8192, False, bd, bd, d=bd,
                  inner_ff=b_inner)
    for m in (1024, 256):
        f32_ffn_cases(f"M={m} d={bd} I={b_inner} (base serving)", True, base_geglu_w32, m, False, bd, bd,
                      backward=False, d=bd, inner_ff=b_inner)
    f32_ffn_cases(f"M=8192 d={bd} H={b_hid} (base)", False, tuple(t.float() for t in base_mlp_w), 8192, False, bd,
                  bd, dd=bd, hid=b_hid)
    f32_ffn_cases(f"M=4096 d={ld} I={l_inner} (large, unpadded)", True, tuple(t.float() for t in large_w), 4096,
                  False, ld, ld, d=ld, inner_ff=l_inner)

    # K2's MLP with a task axis (the batched decoder trunk: 3 tasks, each
    # with its own weights) at M = 256 B for B = 1 and 8, bf16 and f32;
    # beside each row, for reference, three separate K2 MLP launches on the
    # same work
    for dtype in (torch.bfloat16, torch.float32):
        rand, suffix = (randn, "") if dtype == torch.bfloat16 else (randf, "_f32")
        tw = (rand(3, hid, dd, scale=dd ** -0.5), rand(3, hid, scale=0.1), rand(3, dd, hid, scale=hid ** -0.5),
              rand(3, dd, scale=0.1))
        for bt in (1, 8):
            m = 256 * bt
            x_t = rand(3, m, dd)
            entry, label = "fused_ffn/mlp_tasks" + suffix, f"T=3 M=256x{bt} d=256 H=1024"
            flops, n_bytes, peak = ffn_work(m, False, False, elem=dtype.itemsize,
                                            peak=PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32_PRODUCTS)
            cases.append((entry, label, lambda x_t=x_t, tw=tw: cuda_ffn.mlp_ffn_tasks(x_t, *tw),
                          lambda x_t=x_t, tw=tw: cuda_ffn.mlp_ffn_tasks_reference(x_t, *tw),
                          (3 * flops, 3 * n_bytes, peak), None, bt == 1))
            separate[entry, label] = lambda x_t=x_t, tw=tw: [cuda_ffn.mlp_ffn(x_t[i], *(v[i] for v in tw))
                                                             for i in range(3)]
            per_call[entry, label] = (cuda_ffn.tasks_forward_kernels(3, m, dd, hid, dd) if dtype == torch.bfloat16
                                      else cuda_ffn.forward_kernels_f32(False, m, dd, hid, dd, tasks=3))

    q3, kvg3, kvf3, do3 = randf(60, f, 192), randf(60, 3 * f, 384), randf(60, f, 384), randf(60, f, 192)
    cases.append(("fusion_row_attention/fusion_row_f32", "F=256 T=3 3x64 B=60",
                  lambda: cuda_fusion_attn.fusion_row_attention(q3, kvg3, kvf3, 3, 64),
                  lambda: cuda_fusion_attn.fusion_row_attention_reference(q3, kvg3, kvf3, 3, 64),
                  (4.0 * 64 * 4 * 60 * f * 3, nbytes(q3, kvg3, kvf3, q3), PEAK_F32_PRODUCTS),
                  fusion_row_sdpa_case(q3, kvg3, kvf3, 3, "forward"), True))
    cases.append(("fusion_row_attention/fusion_row_f32_backward", "F=256 T=3 3x64 B=60",
                  lambda: cuda_fusion_attn.fusion_row_attention_backward(q3, kvg3, kvf3, do3, 3, 64),
                  lambda: cuda_fusion_attn.fusion_row_attention_backward_reference(q3, kvg3, kvf3, do3, 3, 64),
                  (8.0 * 64 * 4 * 60 * f * 3, 2 * nbytes(q3, kvg3, kvf3) + nbytes(do3), PEAK_F32_PRODUCTS),
                  fusion_row_sdpa_case(q3, kvg3, kvf3, 3, "backward"), True))

    # the pretraining variants' new shapes (phase 14): K1 / K1b over the 2E
    # "gathered" layout of lstm / crossattn_v1 (N = 768, PAD at
    # [num_visible, E) and again at [E + num_visible, 2E), modalities dropped
    # in some rows), K2 / K2b GEGLU at M = B * 2E, K3 / K3b with the
    # quadruplet's four modality slots
    gathered_types = gathered_types_case(dev)
    label_2e = "N=768 B=60 2E layout, dropped modalities"
    qkv_2e = randn(60, 768, 3 * 192)
    zorro_cases("zorro", label_2e, qkv_2e, 3, gathered_types, False)
    zorro_bwd_cases("zorro", label_2e, qkv_2e, 3, gathered_types, False)
    f32_attention_cases("zorro", label_2e, randf(60, 768, 3 * 192), 3, gathered_types, False)
    m_2e = 60 * 768
    geglu_case(f"M={m_2e} d=192 I=512 (2E)", randn(m_2e, d), geglu_w, False, ffn_work(m_2e, False, True))
    x_2e, dy_2e = randn(m_2e, d), randn(m_2e, d)
    cases.append(("fused_ffn/geglu_backward", f"M={m_2e} d=192 I=512 (2E)",
                  lambda: cuda_ffn.geglu_ffn_backward(x_2e, *geglu_w, dy_2e),
                  lambda: cuda_ffn.geglu_ffn_backward_reference(x_2e, *geglu_w, dy_2e),
                  ffn_work(m_2e, True, True), None, False))
    # the 'sup' backbone's blocks (phase 15): K1 / K1b unmasked over all 3 x
    # 256 tokens at 3 heads x 64, K2 / K2b GEGLU at M = B * 768, B = 30
    label_sup = "N=768 3x64 B=30 (sup)"
    qkv_sup = randn(30, 768, 3 * 192)
    zorro_cases("none", label_sup, qkv_sup, 3, None, False)
    zorro_bwd_cases("none", label_sup, qkv_sup, 3, None, False)
    m_sup = 30 * 768
    geglu_case(f"M={m_sup} d=192 I=512 (sup)", randn(m_sup, d), geglu_w, False, ffn_work(m_sup, False, True))
    x_sup, dy_sup = randn(m_sup, d), randn(m_sup, d)
    cases.append(("fused_ffn/geglu_backward", f"M={m_sup} d=192 I=512 (sup)",
                  lambda: cuda_ffn.geglu_ffn_backward(x_sup, *geglu_w, dy_sup),
                  lambda: cuda_ffn.geglu_ffn_backward_reference(x_sup, *geglu_w, dy_sup),
                  ffn_work(m_sup, True, True), None, False))
    chains["fused_ffn/geglu_backward", f"M={m_sup} d=192 I=512 (sup)"] = unfused_backward(
        unfused_geglu, (x_sup, *geglu_w), dy_sup)
    for rand, suffix, peak in ((randn, "", PEAK_BF16), (randf, "_f32", PEAK_F32_PRODUCTS)):
        q4, kvg4, kvf4, do4 = rand(60, f, 192), rand(60, 4 * f, 384), rand(60, f, 384), rand(60, f, 192)
        cases.append((f"fusion_row_attention/fusion_row{suffix}", "F=256 T=4 3x64 B=60 (quadruplet)",
                      lambda q=q4, kvg=kvg4, kvf=kvf4: cuda_fusion_attn.fusion_row_attention(q, kvg, kvf, 3, 64),
                      lambda q=q4, kvg=kvg4, kvf=kvf4: cuda_fusion_attn.fusion_row_attention_reference(
                          q, kvg, kvf, 3, 64),
                      (4.0 * 64 * 5 * 60 * f * 3, nbytes(q4, kvg4, kvf4, q4), peak),
                      fusion_row_sdpa_case(q4, kvg4, kvf4, 3, "forward"), False))
        cases.append((f"fusion_row_attention/fusion_row{suffix}_backward", "F=256 T=4 3x64 B=60 (quadruplet)",
                      lambda q=q4, kvg=kvg4, kvf=kvf4, do=do4: cuda_fusion_attn.fusion_row_attention_backward(
                          q, kvg, kvf, do, 3, 64),
                      lambda q=q4, kvg=kvg4, kvf=kvf4, do=do4:
                      cuda_fusion_attn.fusion_row_attention_backward_reference(q, kvg, kvf, do, 3, 64),
                      (8.0 * 64 * 5 * 60 * f * 3, 2 * nbytes(q4, kvg4, kvf4) + nbytes(do4), peak),
                      fusion_row_sdpa_case(q4, kvg4, kvf4, 3, "backward"), False))

    x_blk32, dy_blk32 = x_blk.float(), dy_blk.float()
    blk_w32 = tuple(t.float() for t in blk_w)
    cases.append(("fused_block_attn/f32_forward", train_label,
                  lambda: cuda_block_attn.fused_block_attn(x_blk32, train_types, *blk_w32, 3, 3),
                  lambda: cuda_block_attn.fused_block_attn_reference(x_blk32, train_types, *blk_w32, 3, 3),
                  block_attn_work(x_blk32, 192, 3, train_mask, False), None, True))
    cases.append(("fused_block_attn/f32_backward", train_label,
                  lambda: cuda_block_attn.fused_block_attn_backward(x_blk32, train_types, *blk_w32, dy_blk32, 3, 3),
                  lambda: cuda_block_attn.fused_block_attn_backward_reference(x_blk32, train_types, *blk_w32,
                                                                              dy_blk32, 3, 3),
                  block_attn_work(x_blk32, 192, 3, train_mask, True), None, True))
    chains["fused_block_attn/f32_forward", train_label] = unfused_block_attn(train_types, 3, 3)(x_blk32, *blk_w32)
    chains["fused_block_attn/f32_backward", train_label] = unfused_backward(unfused_block_attn(train_types, 3, 3),
                                                                            (x_blk32, *blk_w32), dy_blk32)

    results = {}
    for entry, label, kernel, plain, (flops, n_bytes, peak), library, main in cases:
        outs, refs = outputs(kernel()), outputs(plain())
        torch.cuda.synchronize()
        if entry.startswith(("zorro_attention_qkv/", "zorro_sparse/")) and entry.endswith("backward"):
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
        if (entry, label) in chains:  # for reference only: not the library column
            chain = chains[entry, label]
            fb += (f"; {'f32 chain (TF32 off)' if is_f32(entry) else 'unfused cuBLAS chain'} "
                   f"{cuda_ms(chain):.6g} ms, device only "
                   f"{fmt_ms(library_device_ms(chain)[0])}")
        if (entry, label) in separate:  # for reference only: the same work as single-task K2 launches
            three = separate[entry, label]
            fb += (f"; three separate fused_ffn/mlp launches {cuda_ms(three):.6g} ms, device only "
                   f"{fmt_ms(library_device_ms(three)[0])}")
        if (entry, label) in yardstick:  # which library kernels ran, and how close to the plain version
            lib = outputs(yardstick[entry, label]())
            if entry.endswith("backward"):
                lib = lib[0].chunk(3, dim=-1)
            lib_rel = max(rel_l2(o, r) for o, r in zip(lib, refs))
            lib_names = profiled_ms(library, reps=3)[2]
            fb += (f"; library rel_l2 {lib_rel:.6g} against the plain version, its kernels "
                   + ", ".join(f"{kernel_name(k)} {v:.6g} ms" for k, v in lib_names.most_common()))
        device = {"library_device_ms": None, "library_device_how": None}
        names, kernels = entry_kernels(entry, label)
        device["device_ms"], device["device_how"] = device_only_ms(kernel, names,
                                                                    per_call.get((entry, label), kernels))
        fb += f"; device only: kernel {fmt_ms(device['device_ms'])} ({device['device_how']})"
        if library is not None:
            device["library_device_ms"], device["library_device_how"] = library_device_ms(library)
            fb += f", library {fmt_ms(device['library_device_ms'])} ({device['library_device_how']})"
        log(f"[kernels] {entry:40s} {label:30s} max_abs_err {err:.6g} rel_l2 {rel:.6g} "
            f"kernel {ms_k:.6g} ms plain {ms_p:.6g} ms library "
            f"{'-' if ms_lib is None else f'{ms_lib:.6g} ms'}{fb} bound {bound_ms:.6g} ms ({bound_by})")
        rel_bound = (MSDA_REL_L2 if entry.startswith("ms_deform_attn/") else
                     POINTS_REL_L2 if entry.startswith("point_sample/") else
                     F32_REL_L2 if is_f32(entry) else KERNEL_REL_L2)
        if not rel <= rel_bound:
            raise RuntimeError(f"[kernels] {entry} {label}: rel L2 {rel} > {rel_bound}")
        r = results.setdefault(entry, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            r.update(ms=ms_k, plain_ms=ms_p, library_ms=ms_lib, bound_ms=bound_ms, bound_by=bound_by,
                     shape=label, **device)
    return results


DEVICE_KEYS = ("device_ms", "device_how", "library_device_ms", "library_device_how")


def kernel_entry(name: str, r: dict, launches: int) -> dict:
    """One kernel's entry of the kernels line from its phase-3 result: the
    CUDA-event times (``ms``, ``plain_ms``, ``library_ms``), the bound, and
    the device-only times with how each was measured (``device_how``; the
    time is null where the profiler's event count never matched)."""
    src, replaces = REPLACES[name]
    return {"name": name, "route": "cuda", "source": f"{PKG}/{src}", "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], **{k: r[k] for k in DEVICE_KEYS}}


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


def loss_and_grads(model, run):
    """run()'s loss and every parameter's f32 gradient, the grads cleared
    before and after."""
    model.zero_grad(set_to_none=True)
    loss = run()
    loss.backward()
    out = float(loss.detach()), flat_grads(model)
    model.zero_grad(set_to_none=True)
    return out


def compare_grads(g_a, g_b, names=None):
    """Relative L2 of the flat gradient ``g_a`` against ``g_b`` over
    ``names`` (all for None), and the five worst parameters."""
    names = list(g_b) if names is None else names
    diff = torch.cat([(g_a[n] - g_b[n]).reshape(-1) for n in names])
    rel = float(diff.norm() / torch.cat([g_b[n].reshape(-1) for n in names]).norm())
    return rel, sorted(((rel_l2(g_a[n], g_b[n]), n) for n in names), reverse=True)[:5]


def phase_train(dev):
    """The pretraining step at PretrainConfig() defaults (B = 60, bf16
    compute over f32 masters) through create_train_state / make_train_step.
    Returns the step's launches and what phase 8 reuses: the model, state,
    step, batch, masks, loss function and the step's p50."""
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

    def run_loss():
        return loss_fn(dict(model.named_parameters()), batch, mi)[0]

    loss_k, g_k = loss_and_grads(model, run_loss)
    model.attn_impl = "xla"
    loss_p, g_p = loss_and_grads(model, run_loss)
    model.attn_impl = "auto"
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel, worst = compare_grads(g_k, g_p)
    log(f"[train] loss kernel path {loss_k:.6g}, plain path {loss_p:.6g}, rel diff {loss_rel:.3g}; "
        f"flat gradient rel_l2 {grad_rel:.3g}; worst parameters: "
        + ", ".join(f"{n} {r:.3g}" for r, n in worst))
    if not (math.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2):
        raise RuntimeError(f"[train] kernel path vs plain path: loss rel {loss_rel} "
                           f"(bound {TRAIN_LOSS_REL}), gradient rel L2 {grad_rel} (bound {TRAIN_GRAD_REL_L2})")
    del g_k, g_p

    # the main path's run: one step with masks from the state's generator
    ops.reset_kernel_launches()
    step(state, batch)
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    log(f"[train] launches in one step: {launches}")
    if {k: n for k, n in launches.items() if n} != PER_STEP:
        raise RuntimeError(f"[train] launches per step {launches}, expected {PER_STEP}")

    before = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    count = int(optimizer.count)
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = step_times(lambda: step(state, batch)[1], steps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated(dev)
    after = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    moved = float((after - before).abs().max())
    if not all(math.isfinite(x) for x in losses) or moved == 0.0 or int(optimizer.count) != count + 13:
        raise RuntimeError(f"[train] losses {losses}, max weight change {moved}, "
                           f"optimizer count {int(optimizer.count)} (was {count})")
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
        f"max weight change {moved:.3g}, optimizer count {int(optimizer.count)}; step p50 "
        f"{statistics.median(times):.6g} ms (plain path p50 {statistics.median(times_p):.6g} ms); "
        f"mask sampling p50 {statistics.median(mask_ms):.6g} ms on the host; "
        f"peak device memory {peak / 2 ** 30:.4g} GiB")
    context = dict(model=model, state=state, step=step, batch=batch, mask_info=mi, loss_fn=loss_fn,
                   p50=statistics.median(times))
    return launches, context


SEG_PER_FORWARD = {"ms_deform_attn/forward": 2, "zorro_attention_qkv/zorro": 12, "fused_ffn/geglu": 24}
SEG_CLASSES = 10  # the 9 Dynamic-World land-cover classes and the dead channel 0


def segment_model(dev, num_classes: int, serving: bool = True, in_domains=None):
    """The full-width MaskFormer (MaskFormerConfig defaults) with seeded
    random weights: for serving the backbone bf16 and the head f32, in eval
    mode; else all f32, the training step's master weights. Two changes to
    the JAX initializers: seeded N(0, 0.02) noise on the zero
    sampling-offset and attention-weight kernels, so the samples leave the
    pixel centres, and mask_embed.layer2 x 6, so the mask logits leave the
    hard 0.5 threshold of the masked attention
    (test_full_maskformer_parity.py:139)."""
    cfg = MaskFormerConfig(num_classes=num_classes, **({} if in_domains is None else {"in_domains": in_domains}))
    model = build_maskformer(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    if serving:
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
    return model.eval() if serving else model


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

SEG_TRAIN_PER_STEP = {"ms_deform_attn/forward": 2, "ms_deform_attn/backward": 2,
                      "zorro_attention_qkv/zorro": 12, "zorro_attention_qkv/zorro_backward": 12,
                      "fused_ffn/geglu": 24, "fused_ffn/geglu_backward": 24,
                      "point_sample/forward": 20, "point_sample/backward": 4}
SEG_TRAIN_BATCH = 30
# the downstream step, kernel vs plain path: the mask embedding is zero at
# init and reaches the fusion blocks through two LayerNorms of that zero
# input, each of which multiplies its gradient by 1/sqrt(eps) = 316; its
# gradient is 1e5 x a bf16 sum over every masked slot with heavy
# cancellation, and dominates the flat norm (70,000 of 70,300 at init). The
# kernel path run twice differs there by 0.8% (its sums' order varies from
# run to run), the kernel and plain paths by about 10% (on an H100 80GB
# HBM3 at 700 W); every other parameter is held to
# TRAIN_GRAD_REL_L2
MASK_EMB_GRAD_REL_L2 = 0.25


@contextlib.contextmanager
def head_masks(model, pinned=None):
    """Yields a list that, once the block ends, holds the Mask2Former head's
    attention masks over the block (the ``allowed`` bits each
    cross-attention layer reads, one [B, 1, Q, h w] tensor a layer). With
    ``pinned`` (such a list from another run) the head reads those in place
    of the bits it computes: the discrete decisions of another run held
    fixed, as the matches and points are."""
    dec = model.predictor
    real, masks = dec._heads, []

    def spy(*args):
        logits, masks_out, allowed = real(*args)
        if pinned is not None and len(masks) < len(pinned):
            allowed = pinned[len(masks)]
        masks.append(allowed.detach())
        return logits, masks_out, allowed

    dec._heads = spy
    try:
        yield masks
    finally:
        del dec._heads
        del masks[dec.dec_layers:]


def mask_bits_differ(a, b):
    """How many of the head's attention-mask bits differ between two runs,
    and how many there are."""
    return sum(int((x != y).sum()) for x, y in zip(a, b)), sum(x.numel() for x in a)


def phase_segment_train(dev):
    """The downstream instance-segmentation training step at
    MaskFormerConfig(num_classes=1) widths (scripts/train_downstream.py
    defaults: B = 30, 12544 points, exact matching, frozen_stages 11,
    clip 0.01, AdamW 1e-4, bf16 compute) through create_downstream_optimizer
    / make_downstream_train_step."""
    cfg = MaskFormerConfig(num_classes=1)
    model = segment_model(dev, 1, serving=False)
    optimizer = downstream.create_downstream_optimizer(model, lr=1e-4, clip_grad=0.01,
                                                       frozen_stages=cfg.frozen_stages)
    step = downstream.make_downstream_train_step(model, cfg, optimizer)
    state = downstream.DownstreamState(model, optimizer, torch.Generator().manual_seed(SEED))
    x, targets = synthetic_instances(np.random.default_rng(SEED), SEG_TRAIN_BATCH, cfg.image_size, 1)
    batch = {d: torch.from_numpy(v).to(dev) for d, v in x.items()}
    targets = downstream.as_targets(targets, dev)
    doms, nums = cfg.in_domains, (cfg.num_patches,) * len(cfg.in_domains)

    # kernel path against the plain path: the same weights, masks, matches
    # and PointRend points (the kernel path's), dropout off
    g = torch.Generator().manual_seed(SEED)
    present = masking.sample_modality_subset(g, len(doms))
    mi = masking.incomplete_random_masks(g, doms, nums, present, cfg.max_encoded_tokens,
                                         SEG_TRAIN_BATCH, device=dev)
    present = present.to(dev)
    model.zero_grad(set_to_none=True)
    with head_masks(model) as bits_k:
        loss_k, _, aux = step.loss_fn(dict(model.named_parameters()), batch, targets, mi, present, SEED,
                                      return_aux=True)
    loss_k.backward()
    g_k = flat_grads(model)
    # the kernel path once more on the same inputs: its run-to-run spread
    model.zero_grad(set_to_none=True)
    loss_k2, _ = step.loss_fn(dict(model.named_parameters()), batch, targets, mi, present, SEED,
                              matched_override=aux["matched"], point_coords_override=aux["point_coords"])
    loss_k2.backward()
    g_k2 = flat_grads(model)
    model.attn_impl = "xla"
    model.zero_grad(set_to_none=True)
    with head_masks(model) as bits_p:
        loss_p, _ = step.loss_fn(dict(model.named_parameters()), batch, targets, mi, present, SEED,
                                 matched_override=aux["matched"], point_coords_override=aux["point_coords"])
    loss_p.backward()
    g_p = flat_grads(model)
    model.attn_impl = "auto"
    model.zero_grad(set_to_none=True)
    loss_k, loss_k2, loss_p = float(loss_k.detach()), float(loss_k2.detach()), float(loss_p.detach())
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    # the mask embedding's gradient stands apart (MASK_EMB_GRAD_REL_L2)
    emb = "backbone.mask_embedding"
    rest = [n for n in g_p if n != emb]
    grad_rel, worst = compare_grads(g_k, g_p, rest)
    emb_rel = rel_l2(g_k[emb], g_p[emb])
    bits = mask_bits_differ(bits_k, bits_p)
    log(f"[segment-train] present {present.tolist()}, {int(mi.num_visible[0])} visible tokens; loss "
        f"kernel path {loss_k:.6g}, plain path {loss_p:.6g}, rel diff {loss_rel:.3g}; flat gradient "
        f"of all but the mask embedding rel_l2 {grad_rel:.3g}, the mask embedding's {emb_rel:.3g} "
        f"(norm {float(g_p[emb].norm()):.6g} of all "
        f"{float(torch.cat([v.reshape(-1) for v in g_p.values()]).norm()):.6g}); the kernel path run "
        f"twice: loss rel diff {abs(loss_k - loss_k2) / abs(loss_k):.3g}, flat gradient "
        f"{compare_grads(g_k2, g_k, rest)[0]:.3g}, the mask embedding's {rel_l2(g_k2[emb], g_k[emb]):.3g}; the head's "
        f"attention-mask bits that differ between the two paths: {bits[0]} of {bits[1]}; worst "
        "parameters: " + ", ".join(f"{n} {r:.3g}" for r, n in worst))
    if not (math.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2
            and emb_rel <= MASK_EMB_GRAD_REL_L2):
        raise RuntimeError(f"[segment-train] kernel path vs plain path: loss rel {loss_rel} (bound "
                           f"{TRAIN_LOSS_REL}), gradient rel L2 {grad_rel} (bound {TRAIN_GRAD_REL_L2}), "
                           f"mask embedding {emb_rel} (bound {MASK_EMB_GRAD_REL_L2})")
    # what the f32 phase's downstream step reuses: the same weights, masks,
    # matches and points, and this phase's bf16 numbers
    context = dict(model=model, cfg=cfg, optimizer=optimizer, batch=batch, targets=targets, mask_info=mi,
                   present=present, matched=aux["matched"], point_coords=aux["point_coords"],
                   bf16=dict(loss_rel=loss_rel, grad_rel=grad_rel, emb_rel=emb_rel, bits=bits))
    del aux, g_k, g_k2, g_p

    # the main path's run: one step with the state's draws
    ops.reset_kernel_launches()
    step(state, batch, targets)
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    log(f"[segment-train] launches in one step: {launches}")
    if {k: n for k, n in launches.items() if n} != SEG_TRAIN_PER_STEP:
        raise RuntimeError(f"[segment-train] launches per step {launches}, expected {SEG_TRAIN_PER_STEP}")

    trainable = downstream.freeze_mask(model, cfg.frozen_stages)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = step_times(lambda: step(state, batch, targets)[1], steps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated(dev)
    moved = max(float((p.detach() - before[n]).abs().max()) for n, p in model.named_parameters()
                if trainable[n])
    frozen_same = all(torch.equal(p.detach(), before[n]) for n, p in model.named_parameters()
                      if not trainable[n])
    if not all(math.isfinite(v) for v in losses) or moved == 0.0 or not frozen_same:
        raise RuntimeError(f"[segment-train] losses {losses}, max trainable change {moved}, frozen "
                           f"weights unchanged: {frozen_same}")
    del before
    model.attn_impl = "xla"
    times_p, _ = step_times(lambda: step(state, batch, targets)[1], steps=3, warmup=1)
    model.attn_impl = "auto"

    # the exact matching's host part: the costs of all 4 levels fetched once
    # and one scipy pass
    costs = step.cost_step(state, batch, targets)
    fetch_ms, scipy_ms = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = costs.float().cpu().numpy()
        t1 = time.perf_counter()
        scipy_assign_host(host)
        t2 = time.perf_counter()
        fetch_ms.append((t1 - t0) * 1e3)
        scipy_ms.append((t2 - t1) * 1e3)
    for impl, wall in (("auto", times), ("xla", times_p)):
        model.attn_impl = impl
        dev_ms, n_kernels, by_kind, top = device_breakdown(lambda: step(state, batch, targets), reps=2,
                                                           top_n=12)
        log(f"[segment-train] profile attn_impl={impl}: device {dev_ms:.6g} ms a step in "
            f"{n_kernels:.0f} kernels/copies, busy {dev_ms / statistics.median(wall):.3f} of the p50 "
            "wall; by kind " + ", ".join(f"{k} {v:.6g} ms" for k, v in sorted(by_kind.items())))
        for name, ms in top:
            log(f"[segment-train]     {ms:9.4f} ms  {name[:100]}")
    model.attn_impl = "auto"
    p50 = statistics.median(times)
    log(f"[segment-train] B={SEG_TRAIN_BATCH} G=8 P=12544: losses {[round(v, 4) for v in losses]}, max "
        f"trainable weight change {moved:.3g}, frozen weights bitwise unchanged; step p50 {p50:.6g} ms "
        f"({SEG_TRAIN_BATCH / p50 * 1e3:.6g} images/s; plain path p50 {statistics.median(times_p):.6g} "
        f"ms, {SEG_TRAIN_BATCH / statistics.median(times_p) * 1e3:.6g} images/s); matching on the host: "
        f"cost copy p50 {statistics.median(fetch_ms):.6g} ms, scipy p50 {statistics.median(scipy_ms):.6g} "
        f"ms for {host.shape[0]} levels x {host.shape[1]} images; peak device memory "
        f"{peak / 2 ** 30:.4g} GiB")
    return launches, context


# one fused step: every encoder block's attention half as K6 / K6b, so K1
# zorro runs nowhere; the rest as in the default step
FUSED_PER_STEP = {**{k: n for k, n in PER_STEP.items()
                     if k not in ("zorro_attention_qkv/zorro", "zorro_attention_qkv/zorro_backward")},
                  "fused_block_attn/forward": 12, "fused_block_attn/backward": 12}


# the two K1 modes, forward and backward, once on each of the 12 blocks' slabs
MODE_LAUNCHES = {"zorro_attention_packed/zorro": 12, "zorro_attention_packed/zorro_backward": 12,
                 "zorro_sparse/forward": 12, "zorro_sparse/backward": 12}


def set_fused_block(model, on: bool) -> None:
    for blk in model.blocks:
        blk.fused_block = on


def capture_qkv_slabs(model, loss_fn, batch, mask_info):
    """Each encoder block's fused qkv slab and types from one forward of the
    step (composed blocks): a hook on each block's attention recomputes
    F.linear(norm(x), [Wq; Wkv]) on the step's bf16 weights."""
    slabs = []

    def hook(module, args, kwargs, _):
        w = torch.cat([module.to_q.weight, module.to_kv.weight], dim=0)
        slabs.append((torch.nn.functional.linear(module.norm(args[0]), w), kwargs["packed_types"]))

    handles = [blk.attn.register_forward_hook(hook, with_kwargs=True) for blk in model.blocks]
    with torch.no_grad():
        loss_fn(dict(model.named_parameters()), batch, mask_info)
    for h in handles:
        h.remove()
    return slabs


def phase_encoder_variants(dev, ctx):
    """(a) The pretraining step with the fused attention half-block and (b)
    K1's separate-q/k/v and tile-skip modes on the step's own qkv slabs, on
    phase 5's model, batch and masks."""
    model, state, step, batch, mi, loss_fn = (ctx[k] for k in ("model", "state", "step", "batch", "mask_info",
                                                              "loss_fn"))
    # (a) the fused step against the default kernel step: same weights and masks
    results = {}
    for fused in (False, True):
        set_fused_block(model, fused)
        results[fused] = loss_and_grads(model, lambda: loss_fn(dict(model.named_parameters()), batch, mi)[0])
    (loss_f, g_f), (loss_d, g_d) = results[True], results[False]
    loss_rel = abs(loss_f - loss_d) / abs(loss_d)
    grad_rel, worst = compare_grads(g_f, g_d)
    log(f"[encoder-variants] fused step loss {loss_f:.6g}, default kernel step {loss_d:.6g}, rel diff "
        f"{loss_rel:.3g}; flat gradient rel_l2 {grad_rel:.3g}; worst parameters: "
        + ", ".join(f"{n} {r:.3g}" for r, n in worst))
    if not (math.isfinite(loss_f) and loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2):
        raise RuntimeError(f"[encoder-variants] fused vs default step: loss rel {loss_rel} (bound "
                           f"{TRAIN_LOSS_REL}), gradient rel L2 {grad_rel} (bound {TRAIN_GRAD_REL_L2})")
    del results, g_f, g_d

    # the fused step's main-path run: one step with masks from the state's generator
    set_fused_block(model, True)
    ops.reset_kernel_launches()
    step(state, batch)
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    log(f"[encoder-variants] launches in one fused step: {launches}")
    if {k: n for k, n in launches.items() if n} != FUSED_PER_STEP:
        raise RuntimeError(f"[encoder-variants] launches per fused step {launches}, expected {FUSED_PER_STEP}")
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = step_times(lambda: step(state, batch)[1], steps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"[encoder-variants] fused step losses {losses}")
    dev_ms, n_kernels, by_kind, top = device_breakdown(lambda: step(state, batch), reps=3)
    set_fused_block(model, False)
    times_d, _ = step_times(lambda: step(state, batch)[1], steps=5, warmup=2)
    dev_d, n_kernels_d, by_kind_d, _ = device_breakdown(lambda: step(state, batch), reps=3)
    p50 = statistics.median(times)
    log(f"[encoder-variants] fused step: losses {[round(x, 4) for x in losses]}; p50 {p50:.6g} ms (the default "
        f"kernel step p50 {statistics.median(times_d):.6g} ms now, {ctx['p50']:.6g} ms in phase 5); profile: "
        f"device {dev_ms:.6g} ms a step in {n_kernels:.0f} kernels/copies, busy {dev_ms / p50:.3f} of the p50 "
        "wall; by kind " + ", ".join(f"{k} {v:.6g} ms" for k, v in sorted(by_kind.items()))
        + f"; peak device memory {peak / 2 ** 30:.4g} GiB")
    log(f"[encoder-variants] device ms a step: fused {dev_ms:.6g} in {n_kernels:.0f} kernels/copies, default "
        f"kernel step {dev_d:.6g} in {n_kernels_d:.0f} (by kind "
        + ", ".join(f"{k} {v:.6g} ms" for k, v in sorted(by_kind_d.items())) + ")")
    for name, ms in top:
        log(f"[encoder-variants]     {ms:9.4f} ms  {name[:100]}")

    # (b) the two K1 modes on each block's qkv slab of one step, seeded dO;
    # the modes' runs first (the path's launches), the comparisons after
    slabs = capture_qkv_slabs(model, loss_fn, batch, mi)
    heads, fusion = model.blocks[0].attn.heads, model.fusion_type
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    ops.reset_kernel_launches()
    runs = []
    for qkv, types in slabs:
        q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
        do = torch.randn(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3, device=dev, generator=g).to(qkv.dtype)
        o_p, lse_p = cuda_attn.zorro_attention_packed(q, k, v, types, heads, fusion, return_lse=True)
        grads_p = cuda_attn.zorro_attention_packed_backward(q, k, v, types, o_p, lse_p, do, heads, fusion)
        o_s, lse_s = cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv, types, heads, fusion, return_lse=True)
        dqkv_s = cuda_zorro_sparse.zorro_sparse_attention_qkv_backward(qkv, types, o_s, lse_s, do, heads, fusion)
        runs.append((do, o_p, grads_p, o_s, lse_s, dqkv_s))
    torch.cuda.synchronize()
    mode_launches = ops.kernel_launches()
    if {k: n for k, n in mode_launches.items() if n} != MODE_LAUNCHES:
        raise RuntimeError(f"[encoder-variants] mode launches {mode_launches}, expected {MODE_LAUNCHES}")

    worst = collections.defaultdict(float)
    skipped = []
    for i, ((qkv, types), (do, o_p, grads_p, o_s, lse_s, dqkv_s)) in enumerate(zip(slabs, runs)):
        o1, lse1 = cuda_attn.zorro_attention_qkv(qkv, heads, types, fusion, return_lse=True)
        d1 = cuda_attn.zorro_attention_qkv_backward(qkv, types, o1, lse1, do, heads, fusion)
        valid = types != cuda_attn.PAD_TYPE
        ref_s, ref_lse = cuda_zorro_sparse.zorro_sparse_attention_qkv_reference(qkv, types, heads, fusion,
                                                                                return_lse=True)
        ref_d = cuda_zorro_sparse.zorro_sparse_attention_qkv_backward_reference(qkv, types, ref_s, ref_lse, do,
                                                                                heads, fusion)
        checks = {
            "packed vs K1 out": rel_l2(o_p, o1),
            "packed vs K1b grads": max(rel_l2(a, b) for a, b in zip(grads_p, d1.chunk(3, dim=-1))),
            "sparse vs K1 out (valid rows)": rel_l2(o_s[valid], o1[valid]),
            "sparse vs K1b grads (valid rows)": max(rel_l2(a, b) for a, b in zip(dqkv_s[valid].chunk(3, dim=-1),
                                                                                 d1[valid].chunk(3, dim=-1))),
            "sparse vs plain out": rel_l2(o_s, ref_s),
            "sparse vs plain grads": max(rel_l2(a, b) for a, b in zip(dqkv_s.chunk(3, dim=-1),
                                                                      ref_d.chunk(3, dim=-1))),
        }
        bad = {k: v for k, v in checks.items() if not v <= KERNEL_REL_L2}
        if bad or not (torch.isfinite(o_s).all() and torch.isfinite(dqkv_s).all()):
            raise RuntimeError(f"[encoder-variants] block {i}: {bad} > {KERNEL_REL_L2} (or non-finite)")
        for k, v in checks.items():
            worst[k] = max(worst[k], v)
        worst["packed vs K1 max abs"] = max(worst["packed vs K1 max abs"],
                                            float((o_p.float() - o1.float()).abs().max()))
        nt = qkv.shape[1] // cuda_zorro_sparse.TILE
        skipped.append(1.0 - float(cuda_zorro_sparse.tile_active(types, fusion, nt).float().mean()))
    log(f"[encoder-variants] K1 modes on the {len(slabs)} blocks' qkv slabs (B={slabs[0][0].shape[0]} "
        f"N={slabs[0][0].shape[1]}): worst " + ", ".join(f"{k} {v:.6g}" for k, v in worst.items())
        + f"; 128x128 tiles skipped: {min(skipped):.4f}-{max(skipped):.4f} of all")

    # the kernels' own device time on block 0's slab, dense K1 + K1b against
    # the tile-skip mode, apart from the wrappers' other device work (casts,
    # the activity table); and the tile-skip mode with every tile active,
    # which reads the table but skips nothing
    qkv0, types0 = slabs[0]
    do0 = runs[0][0]

    def dense():
        o, lse = cuda_attn.zorro_attention_qkv(qkv0, heads, types0, fusion, return_lse=True)
        cuda_attn.zorro_attention_qkv_backward(qkv0, types0, o, lse, do0, heads, fusion)

    def sparse():
        o, lse = cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv0, types0, heads, fusion, return_lse=True)
        cuda_zorro_sparse.zorro_sparse_attention_qkv_backward(qkv0, types0, o, lse, do0, heads, fusion)

    b0, n0, inner0 = qkv0.shape[0], qkv0.shape[1], qkv0.shape[2] // 3
    types0_i32 = cuda_attn.check_qkv("all-active", qkv0, heads, types0, fusion)
    all_active = torch.ones((b0, 1, (n0 // cuda_zorro_sparse.TILE) ** 2), dtype=torch.int32, device=dev)
    dqkv0 = torch.empty_like(qkv0)
    scale0 = cuda_attn.default_scale(inner0, heads, None)

    def every_tile_active():
        view = cuda_attn.slab_view(qkv0)
        o, lse = cuda_attn.launch_attention(view, b0, n0, inner0, heads, dev, types0_i32, fusion, scale0, True,
                                            all_active)
        cuda_attn.launch_attention_backward(view, cuda_attn.slab_view(dqkv0), b0, n0, inner0, heads, dev,
                                            types0_i32, fusion, o, lse, do0, scale0, all_active)

    for label, fn in (("dense K1 + K1b", dense), ("tile-skip K1 + K1b", sparse),
                      ("tile-skip K1 + K1b, every tile active", every_tile_active)):
        dev_ms, n_kernels, _, _ = device_breakdown(fn, reps=5)
        _, own_events, own = profiled_ms(fn, own="zorro_attention", reps=5)
        note = "" if own_events == 3 else f" (the profiler saw {own_events:g} of the 3 kernels a call: no split)"
        log(f"[encoder-variants] {label} on block 0's slab, device ms a call: "
            + ", ".join(f"{kernel_name(k)} {v:.6g}" for k, v in sorted(own.items())) + note
            + f"; all device work {dev_ms:.6g} in {n_kernels:.0f} kernels/copies; CUDA events around the "
            f"call (phase 3's timing, the host's launch work included) {cuda_ms(fn):.6g} ms, around 20 calls "
            f"back to back {back_to_back_ms(fn):.6g} ms a call")
    return {k: launches[k] + mode_launches[k] for k in launches}


F32_PER_STEP = {f32_key(k): n for k, n in PER_STEP.items()}
F32_FUSED_PER_STEP = {f32_key(k): n for k, n in FUSED_PER_STEP.items()}
F32_PER_FORWARD = {f32_key(k): n for k, n in PER_FORWARD.items()}
F32_MODE_LAUNCHES = {f32_key(k): n for k, n in MODE_LAUNCHES.items()}
F32_SEG_TRAIN_PER_STEP = {(k if k.startswith(("ms_deform_attn/", "point_sample/")) else f32_key(k)): n
                          for k, n in SEG_TRAIN_PER_STEP.items()}
# one f32 serving forward, kernel path vs plain path: f32 throughout, the
# sums' order differs over 12 blocks
F32_FORWARD_REL_L2 = 1e-4
# phase 9 (d): the f32 step at `base`'s widths, PretrainConfig's B = 60 cut
# to 12 (at 16 the phase's peak reached 26.0 GiB, past 24); its timed steps
# after one warm-up (the whole script passed 900 s at 3 after 2)
F32_BASE_BATCH = 12
F32_BASE_STEPS = 2


def phase_f32(dev, seg_ctx):
    """The paths that run in f32 on the card through the f32 instances of
    K1-K3 and K6: (a) the pretraining step with compute_dtype='float32' at
    B = 60 (default and fused_block), and K1's two modes on its qkv slabs;
    (b) an f32 serving request; (c) phase 7's downstream step with
    compute_dtype='float32' on phase 7's weights, masks, matches and points,
    beside phase 7's bf16 numbers and the head's attention-mask bits; (d)
    `base`'s serving forward and step (f32_base)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[f32] every part with TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    launches = collections.Counter()

    # (a) the f32 pretraining step, kernel path against plain path
    cfg = PretrainConfig()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    doms = tuple(cfg.data.in_domains)
    nums = (cfg.data.num_patches,) * len(doms)
    e, b = cfg.mask.num_encoded_tokens, cfg.data.batch_size
    model, state, optimizer = pretrain.create_train_state(cfg, SEED, total_steps=1000, device=dev)
    step = pretrain.make_train_step(model, cfg, optimizer)
    batch = {d: torch.from_numpy(v).to(dev)
             for d, v in synthetic_batch(np.random.default_rng(SEED), doms, b, cfg.data.input_size).items()}
    mi = masking.generate_random_masks(torch.Generator().manual_seed(SEED), doms, nums, e, b, device=dev)
    loss_fn = pretrain.make_loss_fn(model, cfg)

    def run_loss():
        return loss_fn(dict(model.named_parameters()), batch, mi)[0]

    loss_k, g_k = loss_and_grads(model, run_loss)
    model.attn_impl = "xla"
    loss_p, g_p = loss_and_grads(model, run_loss)
    model.attn_impl = "auto"
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel, worst = compare_grads(g_k, g_p)
    log(f"[f32] (a) pretraining step B={b}: loss kernel path {loss_k:.8g}, plain path {loss_p:.8g}, rel diff "
        f"{loss_rel:.3g}; flat gradient rel_l2 {grad_rel:.3g}; worst parameters: "
        + ", ".join(f"{n} {r:.3g}" for r, n in worst))
    if not (math.isfinite(loss_k) and loss_rel <= F32_LOSS_REL and grad_rel <= F32_GRAD_REL_L2):
        raise RuntimeError(f"[f32] pretraining step, kernel vs plain path: loss rel {loss_rel} (bound "
                           f"{F32_LOSS_REL}), gradient rel L2 {grad_rel} (bound {F32_GRAD_REL_L2})")
    del g_p
    set_fused_block(model, True)
    loss_f, g_f = loss_and_grads(model, run_loss)
    fused_rel = abs(loss_f - loss_k) / abs(loss_k)
    fused_grad_rel, worst = compare_grads(g_f, g_k)
    log(f"[f32] (a) the fused step (K6 / K6b f32 on all blocks) against the default f32 step: loss rel diff "
        f"{fused_rel:.3g}, flat gradient rel_l2 {fused_grad_rel:.3g}; worst parameters: "
        + ", ".join(f"{n} {r:.3g}" for r, n in worst))
    if not (math.isfinite(loss_f) and fused_rel <= F32_LOSS_REL and fused_grad_rel <= F32_GRAD_REL_L2):
        raise RuntimeError(f"[f32] fused vs default f32 step: loss rel {fused_rel}, gradient rel L2 "
                           f"{fused_grad_rel}")
    del g_f, g_k

    # the main paths' runs: the default f32 step, then the fused one
    for fused, expected in ((False, F32_PER_STEP), (True, F32_FUSED_PER_STEP)):
        set_fused_block(model, fused)
        ops.reset_kernel_launches()
        step(state, batch)
        torch.cuda.synchronize()
        counts = ops.kernel_launches()
        if {k: n for k, n in counts.items() if n} != expected:
            raise RuntimeError(f"[f32] launches per {'fused ' if fused else ''}f32 step {counts}, expected "
                               f"{expected}")
        launches.update(counts)
    log(f"[f32] (a) launches in one f32 step {F32_PER_STEP}; in one fused f32 step {F32_FUSED_PER_STEP}")
    # each step timed and profiled: the default one, then the fused one (K6 / K6b f32 on every block)
    for fused in (False, True):
        set_fused_block(model, fused)
        what = "fused f32 step" if fused else "f32 step"
        before = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        torch.cuda.reset_peak_memory_stats(dev)
        times, losses = step_times(lambda: step(state, batch)[1], steps=5, warmup=3)
        peak = torch.cuda.max_memory_allocated(dev)
        moved = float((torch.cat([p.detach().reshape(-1) for p in model.parameters()]) - before).abs().max())
        if not all(math.isfinite(x) for x in losses) or moved == 0.0:
            raise RuntimeError(f"[f32] {what} losses {losses}, max weight change {moved}")
        dev_ms, n_kernels, by_kind, top = device_breakdown(lambda: step(state, batch), reps=2, top_n=None)
        log(f"[f32] (a) {what}: losses {[round(x, 4) for x in losses]}, max weight change {moved:.3g}; p50 "
            f"{statistics.median(times):.6g} ms over 5 steps after 3 warm-ups; peak device memory "
            f"{peak / 2 ** 30:.4g} GiB; profile: device {dev_ms:.6g} ms a step in {n_kernels:.0f} kernels/copies, "
            f"busy {dev_ms / statistics.median(times):.3f} of the p50 wall; by kind "
            + ", ".join(f"{k} {v:.6g} ms" for k, v in sorted(by_kind.items())))
        for name, ms in top[:8]:
            log(f"[f32]     {ms:9.4f} ms  {name[:100]}")
        ffma = [name for name, _ in top if "simt_f32_product" in name]
        if ffma:  # every f32 product runs on the tensor cores
            raise RuntimeError(f"[f32] (a) {what}: FFMA product kernels in its profile: {ffma}")
    set_fused_block(model, False)

    # K1's separate-q/k/v and tile-skip modes in f32 on each block's slab
    slabs = capture_qkv_slabs(model, loss_fn, batch, mi)
    heads, fusion = model.blocks[0].attn.heads, model.fusion_type
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    ops.reset_kernel_launches()
    runs = []
    for qkv, types in slabs:
        q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
        do = torch.randn(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3, device=dev, generator=g)
        o_p, lse_p = cuda_attn.zorro_attention_packed(q, k, v, types, heads, fusion, return_lse=True)
        grads_p = cuda_attn.zorro_attention_packed_backward(q, k, v, types, o_p, lse_p, do, heads, fusion)
        o_s, lse_s = cuda_zorro_sparse.zorro_sparse_attention_qkv(qkv, types, heads, fusion, return_lse=True)
        dqkv_s = cuda_zorro_sparse.zorro_sparse_attention_qkv_backward(qkv, types, o_s, lse_s, do, heads, fusion)
        runs.append((do, o_p, grads_p, o_s, lse_s, dqkv_s))
    torch.cuda.synchronize()
    counts = ops.kernel_launches()
    if {k: n for k, n in counts.items() if n} != F32_MODE_LAUNCHES:
        raise RuntimeError(f"[f32] mode launches {counts}, expected {F32_MODE_LAUNCHES}")
    launches.update(counts)
    worst_mode = 0.0
    for (qkv, types), (do, o_p, grads_p, o_s, lse_s, dqkv_s) in zip(slabs, runs):
        o1, lse1 = cuda_attn.zorro_attention_qkv(qkv, heads, types, fusion, return_lse=True)
        d1 = cuda_attn.zorro_attention_qkv_backward(qkv, types, o1, lse1, do, heads, fusion)
        ref_s, ref_lse = cuda_zorro_sparse.zorro_sparse_attention_qkv_reference(qkv, types, heads, fusion,
                                                                                return_lse=True)
        ref_d = cuda_zorro_sparse.zorro_sparse_attention_qkv_backward_reference(qkv, types, ref_s, ref_lse, do,
                                                                                heads, fusion)
        worst_mode = max(worst_mode, rel_l2(o_p, o1), *(rel_l2(a, b_) for a, b_ in zip(grads_p, d1.chunk(3, dim=-1))),
                         rel_l2(o_s, ref_s), *(rel_l2(a, b_) for a, b_ in zip(dqkv_s.chunk(3, dim=-1),
                                                                              ref_d.chunk(3, dim=-1))))
    log(f"[f32] (a) K1's f32 modes on the {len(slabs)} blocks' slabs: worst rel_l2 {worst_mode:.3g} (packed vs "
        "K1 f32, tile-skip vs its plain version on every row, forward and backward)")
    if not worst_mode <= F32_REL_L2:
        raise RuntimeError(f"[f32] K1's f32 modes: rel L2 {worst_mode} > {F32_REL_L2}")
    del model, state, optimizer, step, batch, slabs, runs

    # (b) one f32 serving request against the plain path
    model = build_multimae(PretrainConfig(), device=dev, generator=torch.Generator().manual_seed(SEED)).eval()
    closure = serving.infer_closure(model, None, model.in_domains)
    run, _ = serve_request(model, closure, np.random.default_rng(SEED), 1, ())
    ops.reset_kernel_launches()
    preds, pooled = run()
    torch.cuda.synchronize()
    counts = ops.kernel_launches()
    if {k: n for k, n in counts.items() if n} != F32_PER_FORWARD:
        raise RuntimeError(f"[f32] launches per f32 forward {counts}, expected {F32_PER_FORWARD}")
    launches.update(counts)
    model.attn_impl = "xla"
    preds_p, pooled_p = run()
    model.attn_impl = "auto"
    rel = max([rel_l2(preds[d], preds_p[d]) for d in preds] + [rel_l2(pooled, pooled_p)])
    finite = all(torch.isfinite(p).all() and p.dtype == torch.float32 for p in (*preds.values(), pooled))
    lat = wall_ms(run, reps=10, warmup=3)
    log(f"[f32] (b) serving B=1 all modalities (N=1024) in f32: launches {F32_PER_FORWARD}, rel_l2 vs plain "
        f"path {rel:.3g}, p50 {statistics.median(lat):.6g} ms")
    if not (finite and rel <= F32_FORWARD_REL_L2):
        raise RuntimeError(f"[f32] serving: finite {finite}, rel L2 {rel} > {F32_FORWARD_REL_L2}")
    del model, closure

    # (c) phase 7's downstream step in f32, kernel path against plain path
    model, cfg7 = seg_ctx["model"], seg_ctx["cfg"]
    step32 = downstream.make_downstream_train_step(model, cfg7, seg_ctx["optimizer"], compute_dtype="float32")
    args = (seg_ctx["batch"], seg_ctx["targets"], seg_ctx["mask_info"], seg_ctx["present"], SEED)
    over = dict(matched_override=seg_ctx["matched"], point_coords_override=seg_ctx["point_coords"])
    results = {}
    for impl in ("auto", "xla"):
        model.attn_impl = impl
        with head_masks(model) as masks:
            loss, grads = loss_and_grads(model, lambda: step32.loss_fn(dict(model.named_parameters()), *args,
                                                                       **over)[0])
        results[impl] = (loss, grads, masks)
    model.attn_impl = "auto"
    (loss_k, g_k, m_k), (loss_p, g_p, m_p) = results["auto"], results["xla"]
    emb = "backbone.mask_embedding"
    rest = [n for n in g_p if n != emb]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel, worst = compare_grads(g_k, g_p, rest)
    emb_rel = rel_l2(g_k[emb], g_p[emb])
    bits = mask_bits_differ(m_k, m_p)
    bf = seg_ctx["bf16"]
    log(f"[f32] (c) the downstream step (phase 7's weights, masks, matches and points), kernel path vs plain "
        f"path: f32 loss rel diff {loss_rel:.3g} (bf16, phase 7: {bf['loss_rel']:.3g}); flat gradient of all but "
        f"the mask embedding rel_l2 {grad_rel:.3g} (bf16 {bf['grad_rel']:.3g}); the mask embedding's "
        f"{emb_rel:.3g} (bf16 {bf['emb_rel']:.3g}); the head's attention-mask bits that differ: f32 {bits[0]} "
        f"of {bits[1]}, bf16 {bf['bits'][0]} of {bf['bits'][1]}; worst parameters: "
        + ", ".join(f"{n} {r:.3g}" for r, n in worst))
    if not (math.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2
            and emb_rel <= MASK_EMB_GRAD_REL_L2):
        raise RuntimeError(f"[f32] downstream f32 step: loss rel {loss_rel}, gradient rel L2 {grad_rel}, mask "
                           f"embedding {emb_rel}")
    del results, g_k, g_p
    state32 = downstream.DownstreamState(model, seg_ctx["optimizer"], torch.Generator().manual_seed(SEED))
    ops.reset_kernel_launches()
    _, metrics = step32(state32, seg_ctx["batch"], seg_ctx["targets"])
    torch.cuda.synchronize()
    counts = ops.kernel_launches()
    if {k: n for k, n in counts.items() if n} != F32_SEG_TRAIN_PER_STEP or not math.isfinite(float(metrics["loss"])):
        raise RuntimeError(f"[f32] launches per f32 downstream step {counts}, expected {F32_SEG_TRAIN_PER_STEP}")
    launches.update(counts)
    log(f"[f32] (c) launches in one f32 downstream step: {F32_SEG_TRAIN_PER_STEP}")
    launches.update(timed("f32 (d) base", f32_base, dev))
    return launches


def kernels_by_name(fn, reps: int = 2):
    """Device ms of one call of ``fn`` (the profiler's kernels and copies,
    after one warm-up call), and its device kernels by name a call: how many
    and their ms."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    counts, per_name = collections.Counter(), collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            counts[kernel_name(evt.name)] += 1 / reps
            per_name[kernel_name(evt.name)] += evt.device_time_total / reps / 1e3
    return sum(per_name.values()), counts, per_name


def wide_counts(counts) -> str:
    """The FFMA products and the wide path's kernels among a call's kernels
    (``kernels_by_name``); raises where an FFMA product ran or no wide
    kernel did."""
    ffma = sum(n for k, n in counts.items() if "simt_f32_product" in k)
    wide = {k: n for k, n in counts.items() if "ffn_tf32_wide" in k}
    if ffma or not wide:
        raise RuntimeError(f"[f32] (d) simt_f32_product kernels {ffma:g} (expected 0), wide-path kernels {wide}")
    return (f"simt_f32_product kernels {ffma:g}; wide-path kernels {sum(wide.values()):g} ("
            + ", ".join(f"{k} {n:g}" for k, n in sorted(wide.items())) + ")")


def f32_base(dev):
    """Phase 9 (d): the f32 paths at `base`'s widths (d = 768, 8 x 64 heads,
    GEGLU inner 2048, depth 12), whose FFNs take K2 / K2b's wide path: (i)
    one B = 1 serving forward as cli.infer --model_size base runs it
    (infer.infer, the batched decoder, dem dropped) against its plain path;
    (ii) the f32 pretraining step at B = F32_BASE_BATCH against its plain
    path, exact launches, timed steps."""
    launches = collections.Counter()
    doms = ("s1", "s2", "dem")
    model_cfg = dataclasses.replace(MODEL_SIZES["base"], num_fusion_tokens=(256 // 16) ** 2)
    cfg = PretrainConfig(model=model_cfg, data=DataConfig(input_size=256, in_domains=doms, out_domains=doms,
                                                          batch_size=1))
    model = build_multimae(cfg, device=dev, generator=torch.Generator().manual_seed(SEED)).eval()
    model.decoder_batch_tasks = True
    x = synthetic_batch(np.random.default_rng(SEED + 21), doms, 1, 256)

    def serve():
        res = infer.infer(model, None, x, 256, generator=torch.Generator().manual_seed(1), drop_modalities=("dem",))
        return res.preds, res.pooled

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_kernel_launches()
    preds, pooled = serve()
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.kernel_launches().items() if n}
    expected = {f32_key(k): n for k, n in BATCHED_PER_FORWARD.items()}
    if counts != expected:
        raise RuntimeError(f"[f32] (d) base serving forward: launches {counts}, expected {expected}")
    launches.update(counts)
    model.attn_impl = "xla"
    preds_p, pooled_p = serve()
    model.attn_impl = "auto"
    rel = max([rel_l2(preds[d], preds_p[d]) for d in preds] + [rel_l2(pooled, pooled_p)])
    finite = all(torch.isfinite(p).all() and p.dtype == torch.float32 for p in (*preds.values(), pooled))
    peak = torch.cuda.max_memory_allocated(dev)
    dev_ms, names, _ = kernels_by_name(serve, reps=1)
    lat = wall_ms(serve, reps=3, warmup=1)
    log(f"[f32] (d) base serving B=1, dem dropped, batched decoder (d=768, 8x64 heads, I=2048, depth 12): "
        f"launches {counts}; rel_l2 vs plain path {rel:.3g}; device {dev_ms:.6g} ms a forward; peak "
        f"{peak / 2 ** 30:.4g} GiB; wall p50 {statistics.median(lat):.6g} ms; {wide_counts(names)}")
    if not (finite and rel <= F32_FORWARD_REL_L2):
        raise RuntimeError(f"[f32] (d) base serving: finite {finite}, rel L2 {rel} > {F32_FORWARD_REL_L2}")
    del model, preds_p, pooled_p

    # (ii) the f32 pretraining step at base's widths, full depth, B cut to F32_BASE_BATCH
    b = F32_BASE_BATCH
    cfg = PretrainConfig(model=MODEL_SIZES["base"], data=DataConfig(batch_size=b))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    nums, e = (cfg.data.num_patches,) * len(doms), cfg.mask.num_encoded_tokens
    torch.cuda.reset_peak_memory_stats(dev)
    model, state, optimizer = pretrain.create_train_state(cfg, SEED, total_steps=1000, device=dev)
    step = pretrain.make_train_step(model, cfg, optimizer)
    batch = {d: torch.from_numpy(v).to(dev)
             for d, v in synthetic_batch(np.random.default_rng(SEED), doms, b, cfg.data.input_size).items()}
    mi = masking.generate_random_masks(torch.Generator().manual_seed(SEED), doms, nums, e, b, device=dev)
    loss_fn = pretrain.make_loss_fn(model, cfg)

    def run_loss():
        return loss_fn(dict(model.named_parameters()), batch, mi)[0]

    loss_k, g_k = loss_and_grads(model, run_loss)
    model.attn_impl = "xla"
    loss_p, g_p = loss_and_grads(model, run_loss)
    model.attn_impl = "auto"
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel, worst = compare_grads(g_k, g_p)
    del g_k, g_p
    ops.reset_kernel_launches()
    step(state, batch)
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.kernel_launches().items() if n}
    if counts != F32_PER_STEP:
        raise RuntimeError(f"[f32] (d) base f32 step: launches {counts}, expected {F32_PER_STEP}")
    launches.update(counts)
    times, losses = step_times(lambda: step(state, batch)[1], steps=F32_BASE_STEPS, warmup=1)
    dev_ms, names, per_name = kernels_by_name(lambda: step(state, batch), reps=1)
    peak = torch.cuda.max_memory_allocated(dev)
    k2 = sum(ms for k, ms in per_name.items() if "ffn_tf32" in k)
    log(f"[f32] (d) base f32 pretraining step B={b} (PretrainConfig's B = 60 cut to {b} so that the peak stays "
        f"under 24 GiB; nothing else cut): loss "
        f"kernel path {loss_k:.8g}, plain path {loss_p:.8g}, rel diff {loss_rel:.3g}; flat gradient rel_l2 "
        f"{grad_rel:.3g}; worst parameters: " + ", ".join(f"{n} {r:.3g}" for r, n in worst))
    log(f"[f32] (d) base f32 step: launches {counts}; losses {[round(v, 4) for v in losses]}; wall p50 "
        f"{statistics.median(times):.6g} ms over {F32_BASE_STEPS} steps after a warm-up; device "
        f"{dev_ms:.6g} ms a step (ffn_tf32 kernels {k2:.6g} ms of it); peak {peak / 2 ** 30:.4g} GiB; "
        f"{wide_counts(names)}")
    if peak > 24 * 2 ** 30:
        raise RuntimeError(f"[f32] (d) base f32 step at B = {b}: peak {peak / 2 ** 30:.4g} GiB, past 24 GiB")
    if not (math.isfinite(loss_k) and loss_rel <= F32_LOSS_REL and grad_rel <= F32_GRAD_REL_L2
            and all(math.isfinite(v) for v in losses)):
        raise RuntimeError(f"[f32] (d) base f32 step, kernel vs plain path: loss rel {loss_rel} (bound "
                           f"{F32_LOSS_REL}), gradient rel L2 {grad_rel} (bound {F32_GRAD_REL_L2}), losses {losses}")
    del model, state, optimizer, step, batch
    return launches


SEM_TRAIN_PER_STEP = {**{k: n for k, n in SEG_TRAIN_PER_STEP.items() if k != "point_sample/backward"},
                      "point_sample/forward": 8}  # the matcher's points only: 4 levels x (queries, targets)


def semantic_batch(rng, b, s, num_classes):
    """Rasters and label maps [B, S, S]: an 8 x 8 grid of seeded classes 1 ..
    num_classes - 1 per image (channel 0 is the dead class), painted into
    the rasters."""
    cells = rng.integers(1, num_classes, (b, 8, 8))
    label_map = np.repeat(np.repeat(cells, s // 8, axis=1), s // 8, axis=2).astype(np.int32)
    x = {d: (rng.standard_normal((b, s, s, c)) + label_map[..., None]).astype(np.float32)
         for d, c in (("s1", 1), ("s2", 3), ("dem", 1))}
    return x, label_map


def phase_semantic_train(dev):
    """The semantic downstream training step: MaskFormerConfig(num_classes=
    10), B = 30, seeded label maps through targets_from_semantic_labels (G
    = 10), dense_masks=True, bf16 compute, exact matching (the CLI's
    default); then one step each with 'greedy' and 'auction' matching."""
    cfg = MaskFormerConfig(num_classes=SEG_CLASSES)
    model = segment_model(dev, SEG_CLASSES, serving=False)
    optimizer = downstream.create_downstream_optimizer(model, lr=1e-4, clip_grad=0.01,
                                                       frozen_stages=cfg.frozen_stages)
    step = downstream.make_downstream_train_step(model, cfg, optimizer, dense_masks=True)
    state = downstream.DownstreamState(model, optimizer, torch.Generator().manual_seed(SEED))
    x, label_map = semantic_batch(np.random.default_rng(SEED), SEG_TRAIN_BATCH, cfg.image_size, SEG_CLASSES)
    batch = {d: torch.from_numpy(v).to(dev) for d, v in x.items()}
    targets = set_criterion.targets_from_semantic_labels(torch.from_numpy(label_map).to(dev), SEG_CLASSES)
    doms, nums = cfg.in_domains, (cfg.num_patches,) * len(cfg.in_domains)

    # kernel path against the plain path: the same weights, masks and matches
    g = torch.Generator().manual_seed(SEED)
    present = masking.sample_modality_subset(g, len(doms))
    mi = masking.incomplete_random_masks(g, doms, nums, present, cfg.max_encoded_tokens, SEG_TRAIN_BATCH, device=dev)
    present = present.to(dev)
    aux = {}

    def kernel_loss():
        loss, _, aux["criterion"] = step.loss_fn(dict(model.named_parameters()), batch, targets, mi, present, SEED,
                                                 return_aux=True)
        return loss

    loss_k, g_k = loss_and_grads(model, kernel_loss)
    model.attn_impl = "xla"
    loss_p, g_p = loss_and_grads(model, lambda: step.loss_fn(
        dict(model.named_parameters()), batch, targets, mi, present, SEED,
        matched_override=aux["criterion"]["matched"])[0])
    model.attn_impl = "auto"
    emb = "backbone.mask_embedding"
    rest = [n for n in g_p if n != emb]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel, worst = compare_grads(g_k, g_p, rest)
    emb_rel = rel_l2(g_k[emb], g_p[emb])
    log(f"[semantic-train] {int(targets.valid.sum())} of {targets.valid.numel()} target columns valid; loss "
        f"kernel path {loss_k:.6g}, plain path {loss_p:.6g}, rel diff {loss_rel:.3g}; flat gradient of all but "
        f"the mask embedding rel_l2 {grad_rel:.3g}, the mask embedding's {emb_rel:.3g}; worst parameters: "
        + ", ".join(f"{n} {r:.3g}" for r, n in worst))
    if not (math.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2
            and emb_rel <= MASK_EMB_GRAD_REL_L2 and aux["criterion"]["point_coords"] is None):
        raise RuntimeError(f"[semantic-train] kernel path vs plain path: loss rel {loss_rel}, gradient rel L2 "
                           f"{grad_rel}, mask embedding {emb_rel}")
    del g_k, g_p

    # the main path's run: one step with the state's draws
    ops.reset_kernel_launches()
    step(state, batch, targets)
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    if {k: n for k, n in launches.items() if n} != SEM_TRAIN_PER_STEP:
        raise RuntimeError(f"[semantic-train] launches per step {launches}, expected {SEM_TRAIN_PER_STEP}")
    log(f"[semantic-train] launches in one step: {SEM_TRAIN_PER_STEP} (K5b: 0, no PointRend points)")
    trainable = downstream.freeze_mask(model, cfg.frozen_stages)
    before = {n: p.detach().clone() for n, p in model.named_parameters() if trainable[n]}
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = step_times(lambda: step(state, batch, targets)[1], steps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated(dev)
    moved = max(float((p.detach() - before[n]).abs().max()) for n, p in model.named_parameters() if trainable[n])
    if not all(math.isfinite(v) for v in losses) or moved == 0.0:
        raise RuntimeError(f"[semantic-train] losses {losses}, max trainable change {moved}")
    del before
    p50 = statistics.median(times)
    dev_ms, n_kernels, by_kind, top = device_breakdown(lambda: step(state, batch, targets), reps=2, top_n=8)
    log(f"[semantic-train] B={SEG_TRAIN_BATCH} G={SEG_CLASSES} dense masks, exact matching: losses "
        f"{[round(v, 4) for v in losses]}; step p50 {p50:.6g} ms ({SEG_TRAIN_BATCH / p50 * 1e3:.6g} images/s); "
        f"peak device memory {peak / 2 ** 30:.4g} GiB; profile: device {dev_ms:.6g} ms a step in {n_kernels:.0f} "
        f"kernels/copies, busy {dev_ms / p50:.3f} of the p50 wall; by kind "
        + ", ".join(f"{k} {v:.6g} ms" for k, v in sorted(by_kind.items())))
    for name, ms in top:
        log(f"[semantic-train]     {ms:9.4f} ms  {name[:100]}")

    # the exact matching's host part, then greedy and auction on the card
    costs = step.cost_step(state, batch, targets)
    host_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scipy_assign_host(costs.float().cpu().numpy())
        host_ms.append((time.perf_counter() - t0) * 1e3)
    for mode in ("greedy", "auction"):
        mode_step = downstream.make_downstream_train_step(model, cfg, optimizer, dense_masks=True, match_mode=mode)
        costs = mode_step.cost_step(state, batch, targets)
        on_card = set_criterion.hungarian_match(costs, mode=mode)
        on_cpu = set_criterion.hungarian_match(costs.cpu(), mode=mode)
        if not torch.equal(on_card.cpu(), on_cpu):
            raise RuntimeError(f"[semantic-train] {mode}: the card's assignment differs from the CPU's on the "
                               f"same costs ({int((on_card.cpu() != on_cpu).sum())} of {on_cpu.numel()})")
        ops.reset_kernel_launches()
        mode_step(state, batch, targets)
        torch.cuda.synchronize()
        counts = ops.kernel_launches()
        if {k: n for k, n in counts.items() if n} != SEM_TRAIN_PER_STEP:
            raise RuntimeError(f"[semantic-train] {mode}: launches per step {counts}")
        launches = {k: launches[k] + counts[k] for k in launches}
        mode_times, mode_losses = step_times(lambda: mode_step(state, batch, targets)[1], steps=3, warmup=1)
        if not all(math.isfinite(v) for v in mode_losses):
            raise RuntimeError(f"[semantic-train] {mode}: losses {mode_losses}")
        log(f"[semantic-train] match_mode={mode}: the card's assignment of {tuple(costs.shape)} costs equals the "
            f"CPU's; step p50 {statistics.median(mode_times):.6g} ms (exact: step p50 {p50:.6g} ms, of which "
            f"the host's cost copy and scipy p50 {statistics.median(host_ms):.6g} ms)")
    return launches


STATE_K = 4  # steps a CUDA graph group replays (make_multi_step's K)
STATE_GROUPS = 3  # timed groups of K steps, after one warm-up group
CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_cli")  # git-ignored
GOLDEN = os.path.join(ROOT, "tests", "golden", "fullmodel_golden.npz")
# the golden's model (tests/test_fullmodel_parity.py:36-52)
GOLDEN_MODEL = dict(in_domains=("s1", "s2", "dem"), out_domains=("s1", "s2", "dem"), image_size=64, patch_size=16,
                    dim_tokens=64, depth=2, dim_head=16, heads=2, ff_mult=4, num_fusion_tokens=16,
                    decoder_dim=32, decoder_depth=2, decoder_num_heads=2)
GOLDEN_CHANNELS = {"s1": 1, "s2": 3, "dem": 1}


def golden_weights():
    """The reference MultiMAE's weights of the golden, {name: array}."""
    g = np.load(GOLDEN)
    return {k[len("w::"):]: g[k] for k in g.files if k.startswith("w::")}


def golden_converted():
    """The golden's weights through the port-native converter: the port's
    state dict at the golden's config."""
    return torch_convert.convert_multimae_state(golden_weights(), GOLDEN_MODEL["in_domains"],
                                                GOLDEN_MODEL["out_domains"], GOLDEN_CHANNELS, patch_size=16,
                                                depth=2, decoder_depth=2)


def state_cfg():
    """PretrainConfig() with the uncertainty balancer and the EMA."""
    cfg = PretrainConfig()
    return dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, task_balancer="uncertainty"),
                               train=dataclasses.replace(cfg.train, use_ema=True))


def state_parts(state):
    """The pretraining state's tensors by part (the balancer's and the EMA's
    where the state has them)."""
    parts = {"masters": list(state.model.parameters()), "moments": [state.optimizer.mu, state.optimizer.nu],
             "counts": [state.optimizer.count]}
    bal = state.balancer_optimizer
    if bal is not None:
        parts["counts"].append(bal.count)
        parts["balancer"] = [*state.balancer_params.values(), bal.mu, bal.nu]
    if state.ema is not None:
        parts["ema"] = list(state.ema.values())
    return parts


def state_snapshot(state):
    return ({k: [t.detach().clone() for t in ts] for k, ts in state_parts(state).items()},
            state.generator.get_state(), state.step)


def state_restore(state, snap):
    parts, gen, step = snap
    with torch.no_grad():
        for k, ts in state_parts(state).items():
            for t, s in zip(ts, parts[k]):
                t.copy_(s)
    state.generator.set_state(gen)
    state.step = step


def state_compare(a, b):
    """(bitwise equal, {part: relative L2 of a's flat part against b's})
    of two snapshots."""
    same = torch.equal(a[1], b[1]) and a[2] == b[2]
    rel = {}
    for k in a[0]:
        same = same and all(torch.equal(x, y) for x, y in zip(a[0][k], b[0][k]))
        fa = torch.cat([x.reshape(-1).double() for x in a[0][k]])
        fb = torch.cat([y.reshape(-1).double() for y in b[0][k]])
        rel[k] = float((fa - fb).norm() / fb.norm().clamp(min=1e-30))
    return same, rel


def payload_compare(a, b, path=""):
    """The parts where two checkpoint payloads differ, each with its
    relative L2 (empty when they are bitwise equal)."""
    if isinstance(a, dict):
        out = {}
        for k in a:
            out.update(payload_compare(a[k], b[k], f"{path}.{k}" if path else k))
        return out
    if isinstance(a, torch.Tensor):
        if torch.equal(a, b):
            return {}
        return {path: float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))}
    return {} if a == b else {path: float("inf")}


def run_cli(out_dir, *extra):
    """The pretraining CLI in a subprocess on the card (full width, B = 60)."""
    cmd = [sys.executable, "-m", f"{PKG}.cli.pretrain", "--steps_per_epoch", str(STATE_K), "--epochs", "2",
           "--save_ckpt_freq", "1", "--steps_per_call", str(STATE_K), "--use_ema", "--task_balancer", "uncertainty",
           "--seed", str(SEED), "--output_dir", out_dir, *extra]
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    if r.returncode != 0:
        raise RuntimeError(f"[pretrain-state] {' '.join(cmd)} exited {r.returncode}: {r.stdout[-2000:]} "
                           f"{r.stderr[-3000:]}")
    return r.stdout, time.time() - t0


def phase_pretrain_state(dev):
    """The pretraining state at PretrainConfig() width (B = 60, bf16 over f32
    masters) with the uncertainty balancer and the EMA: (a) make_multi_step
    (K = 4, one CUDA graph over K1-K3) against 4 eager steps from the same
    state; (b) per-step wall p50, device ms, busy share, launches and peak
    memory of both; (c) the CLI on the card straight through against split,
    saved and resumed; (d) one serving request with the golden's weights
    through the port-native converter."""
    cfg = state_cfg()
    doms, b = tuple(cfg.data.in_domains), cfg.data.batch_size
    model, state, optimizer = pretrain.create_train_state(cfg, SEED, total_steps=1000, device=dev)
    step = pretrain.make_train_step(model, cfg, optimizer)
    multi = pretrain.make_multi_step(step, STATE_K)
    rng = np.random.default_rng(SEED + 1)
    host = [synthetic_batch(rng, doms, b, cfg.data.input_size) for _ in range(STATE_K)]
    stack = {d: torch.from_numpy(np.stack([h[d] for h in host])).to(dev) for d in doms}

    def run_eager():
        out = [step(state, {d: stack[d][i] for d in doms})[1] for i in range(STATE_K)]
        return {k: torch.stack([m[k] for m in out]) for k in out[0]}

    def run_graph():
        return multi(state, stack)[1]

    # (a) the main path's run, counts from 0: two eager runs of K steps and
    # the graph's K steps, each from the same state
    start = state_snapshot(state)
    ops.reset_kernel_launches()
    m_e1 = run_eager()
    eager1 = state_snapshot(state)
    state_restore(state, start)
    m_e2 = run_eager()
    eager2 = state_snapshot(state)
    state_restore(state, start)
    torch.cuda.reset_peak_memory_stats(dev)
    m_g = run_graph()
    torch.cuda.synchronize()
    capture_peak = torch.cuda.max_memory_allocated(dev)  # the warm-up step and the capture
    graphed = state_snapshot(state)
    launches = ops.kernel_launches()
    # the eager steps launch through the wrappers; the graph's wrappers run
    # twice (the warm-up step and the capture), its replays launch on the card
    want = {k: (2 * STATE_K + 2) * n for k, n in PER_STEP.items()}
    log(f"[pretrain-state] launches counted in the main-path run: {launches}")
    if {k: n for k, n in launches.items() if n} != want:
        raise RuntimeError(f"[pretrain-state] launches {launches}, expected {want}")
    eager_same, eager_rel = state_compare(eager2, eager1)
    graph_same, graph_rel = state_compare(graphed, eager1)
    metrics_same = all(torch.equal(m_g[k], m_e1[k]) for k in m_e1)
    log(f"[pretrain-state] (a) K = {STATE_K}: eager run 2 vs eager run 1 bitwise {eager_same} (rel L2 by part "
        f"{eager_rel}); graph vs eager run 1 bitwise {graph_same}, metrics bitwise {metrics_same} (rel L2 by part "
        f"{graph_rel}); losses eager {m_e1['loss'].tolist()}, graph {m_g['loss'].tolist()}")
    if not all(math.isfinite(x) for x in m_g["loss"].tolist()):
        raise RuntimeError(f"[pretrain-state] non-finite graph losses {m_g['loss'].tolist()}")
    if eager_same:
        if not (graph_same and metrics_same):
            raise RuntimeError(f"[pretrain-state] the graph's K steps differ from K eager steps: {graph_rel}")
        rule = "bitwise"
    else:
        # the run-to-run spread of the eager step bounds the graph; the step's
        # sums in a run-dependent order are the atomics of torch.gather's
        # backward (pack_tokens, the fusion blocks' KV grid)
        worse = {k: (graph_rel[k], eager_rel[k]) for k in graph_rel if graph_rel[k] > 2 * eager_rel[k]}
        if worse or not torch.equal(graphed[1], eager1[1]) or graphed[2] != eager1[2]:
            raise RuntimeError(f"[pretrain-state] graph vs eager beyond twice the eager spread: {worse}")
        rule = f"within twice the eager spread {eager_rel}"
    log(f"[pretrain-state] (a) graph against eager: {rule}; generator state and step equal")

    # (b) timing: groups of K steps, one sync a group
    results = {}
    for name, run in (("eager", run_eager), ("graph", run_graph)):
        run()
        times = []
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(STATE_GROUPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / STATE_K)
        # a replay allocates nothing: the graph's memory is what its capture took
        peak = max(torch.cuda.max_memory_allocated(dev), capture_peak if name == "graph" else 0)
        dev_ms, n_events, by_kind, per_name = device_breakdown(run, reps=2, top_n=None)
        p50 = statistics.median(times)
        results[name] = dict(p50=p50, device=dev_ms / STATE_K, events=n_events / STATE_K, peak=peak,
                             kinds=sorted(set(kernel_name(n) for n, _ in per_name
                                              if any(k in n.lower() for k in HAND_WRITTEN))))
        log(f"[pretrain-state] (b) {name}: wall p50 {p50:.6g} ms a step (groups of {STATE_K}: "
            f"{[round(t, 3) for t in times]}), device {dev_ms / STATE_K:.6g} ms a step in "
            f"{n_events / STATE_K:.0f} kernels/copies, busy {dev_ms / STATE_K / p50:.3f}, by kind "
            + ", ".join(f"{k} {v / STATE_K:.6g} ms" for k, v in sorted(by_kind.items()))
            + f"; peak device memory {peak / 2 ** 30:.4g} GiB; hand-written kernels in the trace: "
            + ", ".join(results[name]["kinds"]))
    if results["graph"]["kinds"] != results["eager"]["kinds"] or not results["graph"]["kinds"]:
        raise RuntimeError(f"[pretrain-state] the graph's hand-written kernels {results['graph']['kinds']} are "
                           f"not the eager step's {results['eager']['kinds']}")

    # (c) the CLI on the card: straight through, then split at the first
    # epoch's checkpoint and resumed in a fresh process
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    straight, split = os.path.join(CLI_DIR, "straight"), os.path.join(CLI_DIR, "split")
    out1, s1 = run_cli(straight)
    os.makedirs(split)
    shutil.copy(os.path.join(straight, f"checkpoint-{STATE_K}"), split)
    out2, s2 = run_cli(split)
    if f"Resumed from step {STATE_K}" not in out2:
        raise RuntimeError(f"[pretrain-state] (c) the second run did not resume: {out2[-2000:]}")
    last = f"checkpoint-{2 * STATE_K}"
    a = torch.load(os.path.join(split, last), weights_only=True)
    b_ = torch.load(os.path.join(straight, last), weights_only=True)
    diff = payload_compare(a, b_)
    if eager_same and diff:
        raise RuntimeError(f"[pretrain-state] (c) resumed run differs from the straight one: {diff}")
    if diff and not max(diff.values()) <= 2 * max(eager_rel.values()):
        raise RuntimeError(f"[pretrain-state] (c) resumed run beyond the eager spread: {diff}")
    log(f"[pretrain-state] (c) CLI {2 * STATE_K} steps (K = {STATE_K}, B = {b}) straight {s1:.1f} s, resumed "
        f"from checkpoint-{STATE_K} {s2:.1f} s: {'bitwise equal' if not diff else f'rel L2 by tensor {diff}'}")
    shutil.rmtree(CLI_DIR, ignore_errors=True)

    # (d) the golden's weights through the port-native converter, one
    # serving request at the golden's config (bf16; its head dim 16 is not one
    # of K1's, so the plain path serves it)
    g = np.load(GOLDEN)
    golden = MultiMAE(attn_impl="xla", **GOLDEN_MODEL)
    golden.load_state_dict(golden_converted(), strict=True)
    golden = golden.to(dev).to(torch.bfloat16).eval()
    closure = serving.infer_closure(golden, None, golden.in_domains)
    x = [g[f"x_{d}"].transpose(0, 2, 3, 1).copy() for d in golden.in_domains]
    masks = [g[f"full::mask_{d}"] for d in golden.in_domains]
    out = closure(*x, *masks)
    rels = {d: rel_l2(out["preds"][d].cpu(), torch.from_numpy(g[f"full::pred_{d}"].transpose(0, 2, 3, 1).copy()))
            for d in golden.in_domains}
    # the pooled rows tests/test_fullmodel_parity.py:91-98 compares: present
    # modalities and the fusion row
    rows = [i for i, d in enumerate(golden.in_domains) if (g[f"full::mask_{d}"][0] == 0).any()]
    rows.append(len(golden.in_domains))
    rels["pooled"] = rel_l2(out["pooled"][:, rows].cpu(), torch.from_numpy(g["full::return_tokens"][:, rows]))
    log(f"[pretrain-state] (d) golden weights via the port-native converter, bf16 serving request on the card: "
        f"rel L2 against full::* {rels}")
    if not max(rels.values()) <= SERVING_REL_L2:
        raise RuntimeError(f"[pretrain-state] (d) rel L2 {rels} > {SERVING_REL_L2}")
    return launches


# phase 12: the eval forwards of the fine-tuning CLI run the f32 masters, so
# the f32 instances of K1 / K2 (K4 takes f32 only)
SEG_EVAL_F32_PER_FORWARD = {(k if k.startswith("ms_deform_attn/") else f32_key(k)): n
                            for k, n in SEG_PER_FORWARD.items()}
LEARN_STEPS = 75  # the loss halves by then (DOWNSTREAM_E2E_TORCH.json's curve: 4.68 at step 75 from 15.31)
DOWNSTREAM_E2E = os.path.join(ROOT, "DOWNSTREAM_E2E.json")


def write_golden_pth(path: str, prefix: str = "") -> dict:
    """The golden's reference weights as a reference ``.pth`` ({'model':
    state dict}, each name behind ``prefix``, e.g. DDP's 'module.'); returns
    the state dict written."""
    state = {f"{prefix}{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in golden_weights().items()}
    torch.save({"model": state}, path)
    return state


def png_size(path: str):
    """(width, height) of an 8-bit RGB PNG, its pixel data decoded with
    zlib and its length checked against them."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise RuntimeError(f"{path} is not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunks[kind] = chunks.get(kind, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, colour) != (8, 2) or len(zlib.decompress(chunks[b"IDAT"])) != h * (1 + 3 * w):
        raise RuntimeError(f"{path}: not an 8-bit RGB image of {w} x {h}")
    return w, h


def run_in_process(main_fn, argv):
    """``main_fn(argv)`` in this process (its launches count), its standard
    output captured; returns (exit code, output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    return rc, buf.getvalue()


def parsed(pattern: str, text: str, what: str):
    """Every float the regex's group finds in ``text``; raises when none."""
    found = [float(v) for v in re.findall(pattern, text)]
    if not found:
        raise RuntimeError(f"[cli] {what}: nothing matches {pattern!r} in {text[-2000:]}")
    return found


def phase_cli(dev):
    """The port's command line on the card, in a temporary directory inside
    the checkout: (a) cli.convert_checkpoint on the golden's reference
    weights in a fresh process, restored bit for bit; (b) cli.infer on a
    PretrainConfig() checkpoint, seeded masks and --drop dem (PSNR, grid,
    one f32 serving forward's launches a call: the CLI computes in f32 as
    the JAX script does); (c) cli.train_downstream at its
    defaults from that checkpoint, 2 epochs of 3 steps with eval and
    checkpoints (backbone tensors copied, launches, bitwise restore, wall
    p50 a step), then the semantic task; (d) the learning tool,
    LEARN_STEPS steps in a subprocess: the loss must halve."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=os.path.join(ROOT, "build"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    launches = collections.Counter()
    try:
        # (a) convert, in a fresh process
        pth, conv_dir = os.path.join(work, "golden.pth"), os.path.join(work, "converted")
        write_golden_pth(pth)
        cmd = [sys.executable, "-m", f"{PKG}.cli.convert_checkpoint", pth, conv_dir, "--in_domains", "s1-s2-dem",
               "--depth", "2", "--decoder_depth", "2"]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
        if r.returncode != 0:
            raise RuntimeError(f"[cli] (a) {' '.join(cmd)} exited {r.returncode}: {r.stdout[-2000:]} {r.stderr[-3000:]}")
        want = golden_converted()
        restored = ckpt_lib.restore_params(conv_dir, MultiMAE(attn_impl="xla", **GOLDEN_MODEL)).state_dict()
        diff = payload_compare(ckpt_lib.load_model_state(conv_dir), want)
        diff.update(payload_compare(restored, want))
        if diff or set(restored) != set(want):
            raise RuntimeError(f"[cli] (a) the converted checkpoint differs from convert_multimae_state: {diff}")
        log(f"[cli] (a) {r.stdout.strip()}; restored bit for bit as convert_multimae_state's {len(want)} tensors")

        # (b) infer on a full-width PretrainConfig() checkpoint
        pre_dir = os.path.join(work, "pretrained")
        pre_model, pre_state, _ = pretrain.create_train_state(PretrainConfig(), SEED, total_steps=1, device=dev)
        ckpt_lib.save_checkpoint(pre_dir, 0, pre_state)
        pre_shapes = {k: tuple(v.shape) for k, v in pre_model.state_dict().items()}
        del pre_model, pre_state
        for name, extra, check in (("seeded masks", ["--num_encoded_tokens", "256", "--seed", "1"], "masked"),
                                   ("--drop dem", ["--drop", "dem"], "drop")):
            png = os.path.join(work, f"grid_{check}.png")
            ops.reset_kernel_launches()
            rc, out = run_in_process(cli_infer.main, ["--ckpt_dir", pre_dir, "--output", png, *extra])
            torch.cuda.synchronize()
            counts = {k: n for k, n in ops.kernel_launches().items() if n}
            launches.update(counts)
            lines = {d: next((ln for ln in out.splitlines() if ln.startswith(f"{d}: ")), "") for d in
                     ("s1", "s2", "dem")}
            psnr = {d: parsed(r"PSNR (-?[0-9.]+|nan|inf) dB", ln, f"(b) {name} {d}")[0]
                    for d, ln in lines.items() if "fully visible" not in ln}
            w, h = png_size(png)
            visible = [d for d, ln in lines.items() if "fully visible" in ln]
            ok = (rc == 0 and counts == F32_PER_FORWARD and all(math.isfinite(v) for v in psnr.values())
                  and w >= 3 * 256 and h >= 3 * 256 and "restored params" in out)
            if check == "drop":
                ok = ok and visible == ["s1", "s2"] and "(256/256 patches masked)" in lines["dem"]
            else:
                ok = ok and not visible
            log(f"[cli] (b) infer, {name}: " + "; ".join(lines.values()) + f"; grid {w} x {h}; launches {counts}")
            if not ok:
                raise RuntimeError(f"[cli] (b) infer {name}: rc {rc}, launches {counts} (expected {F32_PER_FORWARD}), "
                                   f"PSNR {psnr}, fully visible {visible}, grid {w} x {h}: {out[-2000:]}")

        # (c) fine-tune at the script's defaults from (b)'s checkpoint
        ft_dir = os.path.join(work, "finetune")
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        rc, out = run_in_process(cli_downstream.main, ["--pretrained", pre_dir, "--epochs", "2", "--steps_per_epoch",
                                                       "3", "--eval_freq", "1", "--save_freq", "1",
                                                       "--output_dir", ft_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: n for k, n in ops.kernel_launches().items() if n}
        launches.update(counts)
        cfg = cli_downstream.build_config(cli_downstream.get_args([]))
        backbone = {k: tuple(v.shape) for k, v in MaskFormerModel(cfg).backbone.state_dict().items()}
        shared = sorted(k for k, shape in backbone.items() if pre_shapes.get(k) == shape)
        copied = parsed(r"restored (\d+) backbone tensors", out, "(c) --pretrained")[0]
        losses = parsed(r"epoch \d+: loss=(\S+)", out, "(c) losses")
        dice = parsed(r"eval dice=(\S+)", out, "(c) dice")
        p50 = parsed(r"step wall p50 (\S+) ms", out, "(c) wall p50")[0]
        want = collections.Counter({k: 6 * n for k, n in SEG_TRAIN_PER_STEP.items()})
        want.update({k: 2 * n for k, n in SEG_EVAL_F32_PER_FORWARD.items()})
        fresh = build_maskformer(cfg, device=dev)
        fresh_opt = downstream.create_downstream_optimizer(fresh, lr=1e-4, clip_grad=0.01,
                                                           frozen_stages=cfg.frozen_stages)
        fresh_state = ckpt_lib.restore_checkpoint(ft_dir, downstream.DownstreamState(fresh, fresh_opt,
                                                                                     torch.Generator()), step=2)
        saved = torch.load(os.path.join(ft_dir, "checkpoint-2"), weights_only=True)
        restore_diff = payload_compare(ckpt_lib.state_payload(fresh_state), saved)
        names = sorted(n for n in os.listdir(ft_dir) if n.startswith("checkpoint-"))
        log(f"[cli] (c) fine-tune (tiny, 256^2, B = 30, 12544 points, exact, frozen 11, bf16), 2 epochs x 3 "
            f"steps: {int(copied)} backbone tensors copied of {len(shared)} shared at equal shape (positional "
            f"and fusion: {[k for k in shared if not k.startswith(('blocks.', 'fus_blocks.'))]}); epoch losses "
            f"{losses}, dice {dice}; {names}, checkpoint-2 into a fresh model and optimizer: "
            f"{'bitwise' if not restore_diff else restore_diff}; launches {counts}; step wall p50 {p50:.6g} ms, "
            f"the CLI {wall:.1f} s")
        # the reference's dice is not bounded by 1: its prediction sums the
        # queries' probabilities, which can pass 1 at a pixel (JAX's too)
        if not (rc == 0 and int(copied) == len(shared) and all(math.isfinite(v) for v in losses)
                and all(math.isfinite(v) and v >= 0.0 for v in dice) and names == ["checkpoint-1", "checkpoint-2"]
                and not restore_diff and counts == dict(want) and fresh_state.step == saved["step"]):
            raise RuntimeError(f"[cli] (c) fine-tune: rc {rc}, copied {copied} of {len(shared)}, losses {losses}, "
                               f"dice {dice}, {names}, restore {restore_diff}, launches {counts} (expected "
                               f"{dict(want)}): {out[-2000:]}")
        del fresh, fresh_opt, fresh_state, saved
        sem_dir = os.path.join(work, "semantic")
        ops.reset_kernel_launches()
        rc, out = run_in_process(cli_downstream.main, ["--task", "semantic", "--num_classes", "10", "--match_mode",
                                                       "greedy", "--epochs", "1", "--steps_per_epoch", "2",
                                                       "--eval_freq", "1", "--output_dir", sem_dir])
        torch.cuda.synchronize()
        counts = {k: n for k, n in ops.kernel_launches().items() if n}
        launches.update(counts)
        aa = parsed(r"eval AA=(\S+) mIoU", out, "(c) semantic AA")
        miou = parsed(r"mIoU=(\S+)", out, "(c) semantic mIoU")
        want = collections.Counter({k: 2 * n for k, n in SEG_TRAIN_PER_STEP.items()})
        want.update({k: 2 * n for k, n in SEG_EVAL_F32_PER_FORWARD.items()})  # dice and the label map
        log(f"[cli] (c) semantic (10 classes, greedy), 1 epoch x 2 steps: AA {aa}, mIoU {miou}; launches {counts}")
        if not (rc == 0 and all(0.0 <= v <= 1.0 for v in aa + miou) and counts == dict(want)):
            raise RuntimeError(f"[cli] (c) semantic: rc {rc}, AA {aa}, mIoU {miou}, launches {counts} (expected "
                               f"{dict(want)}): {out[-2000:]}")

        # (d) the learning check, in a subprocess (its launches are its own)
        out_json = os.path.join(work, "learn.json")
        cmd = [sys.executable, os.path.join(ROOT, "tools", "train_downstream_synthetic_torch.py"), "--steps",
               str(LEARN_STEPS), "--frozen_stages", "11", "--out", out_json]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
        if r.returncode != 0:
            raise RuntimeError(f"[cli] (d) {' '.join(cmd)} exited {r.returncode}: {r.stdout[-2000:]} {r.stderr[-3000:]}")
        tail = parsed(r"mean loss (\S+);", r.stdout, "(d) tail loss")[0]
        first = parsed(r"first step's loss (\S+);", r.stdout, "(d) first loss")[0]
        with open(out_json) as f:
            res = json.load(f)
        with open(DOWNSTREAM_E2E) as f:
            jax_res = json.load(f)
        keys = ("mAP", "AP50", "AP75", "binary_foreground_iou")
        log(f"[cli] (d) learning run, {LEARN_STEPS} steps at B = {res['batch']}, frozen 11, auction: first loss "
            f"{first:.6g}, mean of the last 25 {tail:.6g} ({first / tail:.3g}x); "
            + ", ".join(f"{k} {res[k]:.6g}" for k in keys) + f" on {res['backend']} in {time.perf_counter() - t0:.1f} "
            f"s (the JAX run, {jax_res['steps']} steps on {jax_res['backend']}: "
            + ", ".join(f"{k} {jax_res[k]:.6g}" for k in keys) + ")")
        if not (math.isfinite(tail) and tail <= first / 2):
            raise RuntimeError(f"[cli] (d) the loss did not halve: first {first}, last 25 steps' mean {tail}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


EXPORT_DIR = os.path.join(ROOT, "build", "chip_smoke_export")  # git-ignored
# the batched decoder: K1's unmasked mode and K2's MLP with its task axis
# once a decoder layer for all three tasks, in place of once a layer and task
BATCHED_PER_FORWARD = {**{k: n for k, n in PER_FORWARD.items() if k != "fused_ffn/mlp"},
                       "zorro_attention_qkv/none": 2, "fused_ffn/mlp_tasks": 2}
# the reloading process: imports the loader alone, answers each request once
# with the launch counters from 0, times the first request of each artifact,
# writes the outputs and prints what it loaded, counted and timed
EXPORT_RELOAD = r"""
import json, statistics, sys, time
import numpy as np
import torch
from incomplete_multimodal_fusion_tpu_torch import ops, serving
report = {"counts": {}, "p50_ms": {}, "nodes": {}}
for spec in json.loads(sys.argv[1]):
    serve = serving.load_exported(open(spec["blob"], "rb").read())
    for i, (kind, path) in enumerate(spec["requests"]):
        data = np.load(path)
        n = len(data.files) // 2
        args = [data[f"x{j}"] for j in range(n)] + [data[f"m{j}"] for j in range(n)]
        ops.reset_kernel_launches()
        out = serve(*args)
        torch.cuda.synchronize()
        report["counts"][kind] = {k: c for k, c in ops.kernel_launches().items() if c}
        np.savez(path[:-4] + "_out.npz", pooled=out["pooled"].float().cpu().numpy(),
                 **{f"p_{d}": v.float().cpu().numpy() for d, v in out["preds"].items()})
        if i == 0:
            times = []
            for r in range(13):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve(*args)
                torch.cuda.synchronize()
                if r >= 3:
                    times.append((time.perf_counter() - t0) * 1e3)
            report["p50_ms"][kind] = statistics.median(times)
    nodes = [n for n in serve.program.graph.nodes if n.op == "call_function"]
    report["nodes"][spec["blob"]] = [len(nodes), sum("assert" in str(n.target) for n in nodes)]
report["modules"] = sorted(m for m in sys.modules if m.startswith("incomplete_multimodal_fusion_tpu"))
print(json.dumps(report))
"""


def phase_export(dev):
    """Phase 13: (a) the serving forward exported and reloaded in a fresh
    process with no model code, (b) the batched decoder trunk, (c) the
    segmentation extras. Returns the launches of its main-path runs, the
    reloading process's among them."""
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    os.makedirs(EXPORT_DIR)
    try:
        return _phase_export(dev)
    finally:
        shutil.rmtree(EXPORT_DIR, ignore_errors=True)


def _phase_export(dev):
    model = serving_model(dev)
    doms = model.in_domains
    closure = serving.infer_closure(model, None, doms)
    rng = np.random.default_rng(SEED + 13)
    launches = collections.Counter()

    # (a) export at B = 1 and 8, two requests each: all visible, s2 dropped
    specs, live, live_p50 = [], {}, {}
    for b in (1, 8):
        t0 = time.perf_counter()
        blob = serving.export_infer(model, None, batch=b, image_size=model.image_size)
        export_s = time.perf_counter() - t0
        path = os.path.join(EXPORT_DIR, f"tiny_b{b}.pt2")
        with open(path, "wb") as f:
            f.write(blob)
        log(f"[export] B={b}: artifact {len(blob) / 1e6:.2f} MB, exported in {export_s:.1f} s")
        x = synthetic_batch(rng, doms, b, model.image_size)
        requests = []
        for dropped in ((), ("s2",)):
            kind = f"B={b} " + ("s2 dropped" if dropped else "all visible")
            args = [x[d] for d in doms] + [np.full((b, model.num_patches), int(d in dropped), np.int32)
                                           for d in doms]
            req = os.path.join(EXPORT_DIR, f"req_b{b}_{len(dropped)}.npz")
            np.savez(req, **{f"x{i}": a for i, a in enumerate(args[:len(doms)])},
                     **{f"m{i}": a for i, a in enumerate(args[len(doms):])})
            out = closure(*args)
            live[kind] = {**{f"p_{d}": v.float().cpu().numpy() for d, v in out["preds"].items()},
                          "pooled": out["pooled"].float().cpu().numpy()}
            if not dropped:
                live_p50[kind] = statistics.median(wall_ms(lambda args=args: closure(*args), reps=10, warmup=3))
            requests.append((kind, req))
        specs.append({"blob": path, "requests": requests})
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", EXPORT_RELOAD, json.dumps(specs)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"[export] the reloading process failed:\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    loaded = [m for m in report["modules"] if m.split(".")[1:2] in (["models"], ["train"], ["losses"])]
    if loaded:
        raise RuntimeError(f"[export] the reloading process imported model code: {loaded}")
    for spec in specs:
        for kind, req in spec["requests"]:
            counts = report["counts"][kind]
            launches.update(counts)
            if counts != PER_FORWARD:
                raise RuntimeError(f"[export] {kind}: reloaded launches {counts}, expected {PER_FORWARD}")
            got = np.load(req[:-4] + "_out.npz")
            bitwise = all(np.array_equal(got[k], v) for k, v in live[kind].items())
            rel = max(rel_l2(torch.from_numpy(got[k]), torch.from_numpy(v)) for k, v in live[kind].items())
            finite = all(np.isfinite(got[k]).all() for k in live[kind])
            log(f"[export] {kind}: reloaded vs live closure bitwise {bitwise}, rel_l2 {rel:.3g}; launches {counts}")
            if not (finite and (bitwise or rel <= 1e-3)):
                raise RuntimeError(f"[export] {kind}: reloaded outputs differ from the live closure (rel L2 {rel})")
    for b, spec in zip((1, 8), specs):
        kind = f"B={b} all visible"
        calls, asserts = report["nodes"][spec["blob"]]
        log(f"[export] wall p50 {kind}: reloaded program {report['p50_ms'][kind]:.6g} ms, live closure "
            f"{live_p50[kind]:.6g} ms (host clock, input copies included); the program's graph "
            f"{calls} calls, {asserts} of them assertions")
    log(f"[export] the reloading process loaded {len(report['modules'])} modules of the port, none of "
        f"models/, train/, losses/")

    # (b) the batched decoder trunk on the same weights, B = 1 all visible
    run, _ = serve_request(model, closure, rng, 1, ())
    per_task = {}
    for batched in (False, True):
        model.decoder_batch_tasks = batched
        ops.reset_kernel_launches()
        preds, pooled = run()
        torch.cuda.synchronize()
        counts = {k: n for k, n in ops.kernel_launches().items() if n}
        dev_ms = profiled_ms(run, reps=10)[0]
        log(f"[export] decoder_batch_tasks={batched}: device {dev_ms:.6g} ms a forward, launches {counts}")
        if batched:
            launches.update(counts)
            if counts != BATCHED_PER_FORWARD:
                raise RuntimeError(f"[export] batched decoder: launches {counts}, expected {BATCHED_PER_FORWARD}")
            rel = max(rel_l2(preds[d], per_task[d]) for d in preds)
            log(f"[export] batched decoder vs per-task decoder: preds rel_l2 {rel:.3g}")
            if not (all(torch.isfinite(p).all() for p in preds.values()) and rel <= SERVING_REL_L2):
                raise RuntimeError(f"[export] batched decoder: preds rel L2 {rel} > {SERVING_REL_L2}")
        per_task = preds
    model.decoder_batch_tasks = False
    # the same request in f32 (TF32 off) through the f32 instances, against its plain path
    model32 = serving_model(dev).float()
    model32.decoder_batch_tasks = True
    closure32 = serving.infer_closure(model32, None, doms)
    run32, _ = serve_request(model32, closure32, np.random.default_rng(SEED + 13), 1, ())
    ops.reset_kernel_launches()
    preds32, _ = run32()
    torch.cuda.synchronize()
    counts32 = {k: n for k, n in ops.kernel_launches().items() if n}
    launches.update(counts32)
    dev32, _, names32 = profiled_ms(run32, reps=10)
    k1_32 = sum(ms for name, ms in names32.items() if "zorro_attention_f32" in name)
    k2_32 = sum(ms for name, ms in names32.items() if "ffn_tf32" in name or "simt_f32" in name)
    log(f"[export] f32 serving forward, B = 1 all modalities: device {dev32:.6g} ms (K1 f32 {k1_32:.6g} ms, K2 f32 "
        f"{k2_32:.6g} ms of it), launches {counts32}")
    model32.attn_impl = "xla"
    preds32_p, _ = run32()
    rel32 = max(rel_l2(preds32[d], preds32_p[d]) for d in preds32)
    log(f"[export] batched decoder in f32: launches {counts32}, preds rel_l2 vs plain path {rel32:.3g}")
    if counts32 != {f32_key(k): n for k, n in BATCHED_PER_FORWARD.items()} or not rel32 <= F32_FORWARD_REL_L2:
        raise RuntimeError(f"[export] f32 batched decoder: launches {counts32}, rel L2 {rel32}")
    del model32, closure32

    # one pretraining step with the batched decoder against the per-task step
    cfg = PretrainConfig()
    tmodel, _, _ = pretrain.create_train_state(cfg, SEED, total_steps=1000, device=dev)
    tdoms, b = tuple(cfg.data.in_domains), cfg.data.batch_size
    batch = {d: torch.from_numpy(v).to(dev)
             for d, v in synthetic_batch(np.random.default_rng(SEED), tdoms, b, cfg.data.input_size).items()}
    mi = masking.generate_random_masks(torch.Generator().manual_seed(SEED), tdoms, (cfg.data.num_patches,) * 3,
                                       cfg.mask.num_encoded_tokens, b, device=dev)
    loss_fn = pretrain.make_loss_fn(tmodel, cfg)

    def run_loss():
        return loss_fn(dict(tmodel.named_parameters()), batch, mi)[0]

    loss_s, g_s = loss_and_grads(tmodel, run_loss)
    tmodel.decoder_batch_tasks = True
    ops.reset_kernel_launches()
    loss_b, g_b = loss_and_grads(tmodel, run_loss)
    step_counts = {k: n for k, n in ops.kernel_launches().items() if n}
    launches.update(step_counts)
    loss_rel = abs(loss_b - loss_s) / abs(loss_s)
    grad_rel, worst = compare_grads(g_b, g_s)
    log(f"[export] pretraining step B={b}, batched decoder vs per-task: loss {loss_b:.6g} vs {loss_s:.6g} "
        f"(rel {loss_rel:.3g}), flat gradient rel_l2 {grad_rel:.3g}; launches {step_counts}")
    if not (math.isfinite(loss_b) and loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2):
        raise RuntimeError(f"[export] batched decoder step: loss rel {loss_rel}, gradient rel L2 {grad_rel}")
    if step_counts.get("fused_ffn/mlp_tasks") != 2 or step_counts.get("fused_ffn/mlp_backward") != 6:
        raise RuntimeError(f"[export] batched decoder step: launches {step_counts}")
    del tmodel, g_s, g_b, batch

    # (c) segmentation extras: TTA, panoptic on the card and on the host, the PNG
    sem = segment_model(dev, SEG_CLASSES)
    x = synthetic_batch(rng, sem.cfg.in_domains, 1, sem.cfg.image_size)
    ops.reset_kernel_launches()
    tta = infer_segmentation.semantic_inference_with_tta(sem, None, x)
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.kernel_launches().items() if n}
    launches.update(counts)
    xt = {d: torch.from_numpy(v).to(dev) for d, v in x.items()}
    size = tuple(xt[sem.cfg.in_domains[0]].shape[1:3])
    plain = infer_segmentation.semantic_probabilities(infer_segmentation.segmentation_outputs(sem, None, xt), size)
    flipped = infer_segmentation.semantic_probabilities(infer_segmentation.segmentation_outputs(
        sem, None, {d: torch.flip(v, dims=[2]) for d, v in xt.items()}), size)
    rel = rel_l2(tta, (plain + torch.flip(flipped, dims=[-1])) / 2)
    log(f"[export] TTA B=1: launches {counts}, rel_l2 vs the mean of the two forwards {rel:.3g}")
    if counts != {k: 2 * n for k, n in SEG_PER_FORWARD.items()} or not rel <= SEG_REL_L2:
        raise RuntimeError(f"[export] TTA: launches {counts}, rel L2 {rel}")
    out = infer_segmentation.segmentation_outputs(sem, None, xt)
    cls, masks = out["pred_logits"][0].float(), out["pred_masks"][0].float()
    kw = dict(object_mask_threshold=0.1, overlap_threshold=0.1, thing_ids=list(range(1, 6)))
    pan_d, segs_d = infer_segmentation.panoptic_inference(cls, masks, **kw)
    pan_h, segs_h = infer_segmentation.panoptic_inference(cls.cpu(), masks.cpu(), **kw)
    log(f"[export] panoptic on the card's outputs: {len(segs_d)} segments; equal to the host's: "
        f"{torch.equal(pan_d, pan_h) and segs_d == segs_h}")
    if not (torch.equal(pan_d, pan_h) and segs_d == segs_h):
        raise RuntimeError("[export] panoptic_inference differs between the card and the host")
    labels = infer_segmentation.forward_segmentation(sem, None, x, SEG_CLASSES)
    png = infer_segmentation.save_segmentation_png(labels[0], os.path.join(EXPORT_DIR, "seg.png"))
    if png_size(png) != (size[1], size[0]):
        raise RuntimeError(f"[export] {png}: {png_size(png)}, expected {size[1]} x {size[0]}")
    log(f"[export] save_segmentation_png: {png_size(png)[0]} x {png_size(png)[1]} PNG read back")
    return dict(launches)


# phase 14: the pretraining variants at the full `tiny` width
VARIANTS = {  # name: (fusion_mode, decoder_style, in_domains)
    "zorro": ("zorro", "simple", ("s1", "s2", "dem")),
    "lstm": ("lstm", "simple", ("s1", "s2", "dem")),
    "crossattn_v1": ("crossattn_v1", "simple", ("s1", "s2", "dem")),
    "crossattn full decoder": ("crossattn", "full", ("s1", "s2", "dem")),
    "quadruplet crossattn": ("crossattn", "simple", ("s1_2ch", "s2_4ch", "dem", "dnw")),
}
VARIANT_K = 2  # the CUDA-graph group of the lstm step
VARIANT_DIR = os.path.join(ROOT, "build", "chip_smoke_variants")  # git-ignored


def variant_cfg(name):
    mode, style, doms = VARIANTS[name]
    cfg = PretrainConfig()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, fusion_mode=mode),
                               data=dataclasses.replace(cfg.data, in_domains=doms, out_domains=doms),
                               decoder=dataclasses.replace(cfg.decoder, style=style))


def variant_per_forward(cfg, suffix: str = ""):
    """The kernels a forward of the variant launches: K1 zorro a block; K2
    GEGLU a block and a fusion block (crossattn); K3 a fusion block; a
    decoder layer's K1 unmasked and K2 MLP a task, and the full decoder's
    cross-attention MLP a task. ``suffix`` "_f32" gives the f32 keys."""
    depth, dec, tasks = cfg.model.depth, cfg.decoder.depth, len(cfg.data.out_domains)
    crossattn = cfg.model.fusion_mode == "crossattn"
    out = {"zorro_attention_qkv/zorro": depth, "fused_ffn/geglu": depth * (2 if crossattn else 1),
           "zorro_attention_qkv/none": dec * tasks,
           "fused_ffn/mlp": (dec + (1 if cfg.decoder.style == "full" else 0)) * tasks}
    if crossattn:
        out["fusion_row_attention/fusion_row"] = depth
    return {(f32_key(k) if suffix else k): n for k, n in out.items()}


def launch_delta(before):
    after = ops.kernel_launches()
    return {k: n - before.get(k, 0) for k, n in after.items() if n - before.get(k, 0)}


def phase_pretrain_variants(dev):
    """Phase 14. (a) For each of VARIANTS at PretrainConfig() widths (B = 60,
    bf16 over f32 masters): the loss and gradients of the kernel path
    against the plain path on one set of masks, the exact launches of one
    step, 3 warm-up and 5 timed steps (p50, profiled device ms, busy share,
    peak memory); for lstm one make_multi_step group (K = 2) against 2 eager
    steps from the same state. (b) The trained weights in bf16 serve one
    B = 1 request with dem dropped: launches a forward, bitwise unmoved by
    dem's pixels, within SERVING_REL_L2 of the plain path; one f32
    ``cli.infer --fusion_mode lstm`` call (f32 keys only). (c) One short
    ``cli.pretrain --fusion_mode lstm --log_wandb --profile_dir`` run in a
    subprocess (full width, B = 12): a wandb fallback line a step, a trace
    holding K1's and K2's kernels. Returns the launches counted in this
    process."""
    shutil.rmtree(VARIANT_DIR, ignore_errors=True)
    os.makedirs(VARIANT_DIR)
    try:
        return _phase_pretrain_variants(dev)
    finally:
        shutil.rmtree(VARIANT_DIR, ignore_errors=True)


def _phase_pretrain_variants(dev):
    ops.reset_kernel_launches()
    rng = np.random.default_rng(SEED + 14)
    for name in VARIANTS:
        cfg = variant_cfg(name)
        doms, b, e = tuple(cfg.data.in_domains), cfg.data.batch_size, cfg.mask.num_encoded_tokens
        nums = (cfg.data.num_patches,) * len(doms)
        model, state, optimizer = pretrain.create_train_state(cfg, SEED, total_steps=1000, device=dev)
        step = pretrain.make_train_step(model, cfg, optimizer)
        batch = {d: torch.from_numpy(v).to(dev) for d, v in synthetic_batch(rng, doms, b, cfg.data.input_size).items()}
        mi = masking.generate_random_masks(torch.Generator().manual_seed(SEED), doms, nums, e, b, device=dev)
        loss_fn = pretrain.make_loss_fn(model, cfg)

        def run_loss():
            return loss_fn(dict(model.named_parameters()), batch, mi)[0]

        loss_k, g_k = loss_and_grads(model, run_loss)
        model.attn_impl = "xla"
        loss_p, g_p = loss_and_grads(model, run_loss)
        model.attn_impl = "auto"
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        grad_rel, worst = compare_grads(g_k, g_p)
        del g_k, g_p
        if not (math.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2):
            raise RuntimeError(f"[variants] {name}: kernel vs plain path loss rel {loss_rel} (bound {TRAIN_LOSS_REL}),"
                               f" gradient rel L2 {grad_rel} (bound {TRAIN_GRAD_REL_L2}); worst {worst}")
        # the main path: one step, masks from the state's generator
        before = ops.kernel_launches()
        step(state, batch)
        torch.cuda.synchronize()
        per_step = launch_delta(before)
        fwd = variant_per_forward(cfg)
        want = {**fwd, **{f"{k}_backward": n for k, n in fwd.items()}}
        if per_step != want:
            raise RuntimeError(f"[variants] {name}: launches a step {per_step}, expected {want}")
        torch.cuda.reset_peak_memory_stats(dev)
        times, losses = step_times(lambda: step(state, batch)[1], steps=3, warmup=2)
        peak = torch.cuda.max_memory_allocated(dev)
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"[variants] {name}: losses {losses}")
        p50 = statistics.median(times)
        dev_ms, n_kernels, by_kind, _ = device_breakdown(lambda: step(state, batch), reps=2)
        log(f"[variants] (a) {name}: loss kernel path {loss_k:.6g}, plain path {loss_p:.6g} (rel {loss_rel:.3g}), "
            f"gradient rel_l2 {grad_rel:.3g} (worst {worst[0][1]} {worst[0][0]:.3g}); launches a step exact "
            f"{per_step}; step p50 {p50:.6g} ms, device {dev_ms:.6g} ms in {n_kernels:.0f} kernels/copies, busy "
            f"{dev_ms / p50:.3f}, by kind " + ", ".join(f"{k} {v:.6g} ms" for k, v in sorted(by_kind.items()))
            + f"; peak device memory {peak / 2 ** 30:.4g} GiB; losses {[round(x, 4) for x in losses]}")

        if name == "lstm":  # one CUDA-graph group of K steps against K eager steps, twice eager
            multi = pretrain.make_multi_step(step, VARIANT_K)
            stack = {d: torch.stack([batch[d]] * VARIANT_K) for d in doms}

            def run_eager():
                out = [step(state, {d: stack[d][i] for d in doms})[1] for i in range(VARIANT_K)]
                return {k: torch.stack([m[k] for m in out]) for k in out[0]}

            start = state_snapshot(state)
            before = ops.kernel_launches()
            m_e = run_eager()
            eager1 = state_snapshot(state)
            state_restore(state, start)
            run_eager()
            eager2 = state_snapshot(state)
            state_restore(state, start)
            m_g = multi(state, stack)[1]
            torch.cuda.synchronize()
            graphed = state_snapshot(state)
            counted = launch_delta(before)
            want_g = {k: (2 * VARIANT_K + 2) * n for k, n in want.items()}  # eager x 2, warm-up and capture
            if counted != want_g:
                raise RuntimeError(f"[variants] lstm graph group: launches {counted}, expected {want_g}")
            # phase 11's rule: bitwise where two eager runs are, else within
            # twice their spread (torch.gather's backward adds in a
            # run-dependent order)
            eager_same, eager_rel = state_compare(eager2, eager1)
            graph_same, graph_rel = state_compare(graphed, eager1)
            metrics_same = all(torch.equal(m_g[k], m_e[k]) for k in m_e)
            worse = {k: (graph_rel[k], eager_rel[k]) for k in graph_rel if graph_rel[k] > 2 * eager_rel[k]}
            if (eager_same and not (graph_same and metrics_same)) or (not eager_same and worse):
                raise RuntimeError(f"[variants] lstm: the graph's {VARIANT_K} steps against the eager steps: rel L2 "
                                   f"{graph_rel}, eager spread {eager_rel}")
            log(f"[variants] (a) lstm make_multi_step K = {VARIANT_K}: eager run 2 vs 1 bitwise {eager_same} (rel by "
                f"part {eager_rel}); graph vs eager bitwise {graph_same}, metrics bitwise {metrics_same} (rel by "
                f"part {graph_rel}); losses eager {m_e['loss'].tolist()}, graph {m_g['loss'].tolist()}")

        # (b) the trained weights in bf16 serve one B = 1 request, dem dropped
        del state, optimizer, step, loss_fn
        model = model.to(torch.bfloat16).eval()
        closure = serving.infer_closure(model, None, doms)
        run, perturbed = serve_request(model, closure, rng, 1, ("dem",))
        before = ops.kernel_launches()
        preds, pooled = run()
        torch.cuda.synchronize()
        served = launch_delta(before)
        if served != fwd:
            raise RuntimeError(f"[variants] {name}: serving launches {served}, expected {fwd}")
        preds2, pooled2 = run(perturbed())
        moved = [d for d in preds if not torch.equal(preds[d], preds2[d])] + ([] if torch.equal(pooled, pooled2)
                                                                             else ["pooled"])
        if moved or not all(torch.isfinite(p.float()).all() for p in preds.values()):
            raise RuntimeError(f"[variants] {name}: dem's pixels moved {moved} (or non-finite preds)")
        model.attn_impl = "xla"
        preds_p, pooled_p = run()
        model.attn_impl = "auto"
        rel = max([rel_l2(preds[d], preds_p[d]) for d in preds] + [rel_l2(pooled, pooled_p)])
        if not rel <= SERVING_REL_L2:
            raise RuntimeError(f"[variants] {name}: serving rel L2 vs plain path {rel} > {SERVING_REL_L2}")
        lat = wall_ms(run, reps=5, warmup=2)
        log(f"[variants] (b) {name}: B=1 dem dropped, launches a forward exact, bitwise unmoved by dem's pixels, "
            f"rel_l2 vs plain path {rel:.6g}, p50 {statistics.median(lat):.6g} ms")
        del model, closure

    # (b) one f32 cli.infer call in this process: the f32 keys alone
    before = ops.kernel_launches()
    png = os.path.join(VARIANT_DIR, "lstm.png")
    rc, out = run_in_process(cli_infer.main, ["--fusion_mode", "lstm", "--ckpt_dir", os.path.join(VARIANT_DIR, "none"),
                                              "--output", png])
    torch.cuda.synchronize()
    counted = launch_delta(before)
    want = variant_per_forward(variant_cfg("lstm"), "_f32")
    psnr = parsed(r"masked-patch PSNR (\S+) dB", out, "cli.infer --fusion_mode lstm")
    if rc != 0 or counted != want or not all(math.isfinite(v) for v in psnr) or png_size(png)[0] < 3 * 256:
        raise RuntimeError(f"[variants] cli.infer --fusion_mode lstm: rc {rc}, launches {counted} (expected "
                           f"{want}), PSNR {psnr}: {out[-1500:]}")
    log(f"[variants] (b) f32 cli.infer --fusion_mode lstm: launches {counted} (f32 keys only), PSNR {psnr}, "
        f"PNG {png_size(png)}")

    # (c) cli.pretrain with wandb's fallback and the profiler, in a subprocess
    out_dir, prof = os.path.join(VARIANT_DIR, "cli"), os.path.join(VARIANT_DIR, "prof")
    cmd = [sys.executable, "-m", f"{PKG}.cli.pretrain", "--fusion_mode", "lstm", "--batch_size", "12",
           "--steps_per_epoch", "3", "--epochs", "1", "--seed", str(SEED), "--output_dir", out_dir, "--log_wandb",
           "--profile_dir", prof, "--profile_start", "1", "--profile_steps", "1"]
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    if r.returncode != 0:
        raise RuntimeError(f"[variants] {' '.join(cmd)} exited {r.returncode}: {r.stdout[-2000:]} {r.stderr[-3000:]}")
    with open(os.path.join(out_dir, "wandb_fallback.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    with open(os.path.join(prof, "trace.json")) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    k1 = sorted({kernel_name(n) for n in names if "zorro_attention" in n})
    k2 = sorted({kernel_name(n) for n in names if "ffn_fwd" in n or "ffn_bwd" in n})
    if [row["step"] for row in logged] != [0, 1, 2] or not all(math.isfinite(row["loss"]) for row in logged) \
            or not k1 or not k2:
        raise RuntimeError(f"[variants] (c) wandb lines {logged}, K1 kernels in the trace {k1}, K2 {k2}")
    log(f"[variants] (c) cli.pretrain --fusion_mode lstm --log_wandb --profile_dir: {len(logged)} fallback lines "
        f"(steps {[row['step'] for row in logged]}), trace kernels K1 {k1}, K2 {k2}; {time.time() - t0:.1f} s")
    return ops.kernel_launches()


# phase 15's backbones and decoders: MaskFormerConfig changes, each at the
# defaults' widths (tiny ViT, ResNet and Swin-T as the JAX modules define
# them)
BACKBONES = {
    "vit_adapter": dict(backbone_type="vit_adapter"),
    "resnet50": dict(backbone_type="resnet50"),
    "resnet18": dict(backbone_type="resnet18"),
    "swin": dict(backbone_type="swin"),
    "sup": dict(fusion_mode="sup"),
    "vit standard decoder": dict(decoder_type="standard"),
}
BACKBONE_BATCH = 30
# phase 15's free plain path (the head computing its own attention-mask
# bits) against the kernel path: about twice the largest of the five
# masked backbones' readings (H100 80GB HBM3, 700 W; the same in three
# runs): loss rel 1.02e-2 (swin), 55,625 of 4,032,000 bits (1.38%,
# vit_adapter). Phase 7's model flips 1,946 (0.05%) and holds its free
# plain path at TRAIN_LOSS_REL unpinned
FREE_LOSS_REL = 2e-2
FREE_MASK_BITS = 3e-2  # a share of the bits


def backbone_per_forward(cfg: MaskFormerConfig):
    """The kernels one forward launches: K4 twice in the pixel decoder (its
    two encoder layers); in a ViT backbone K1 zorro and K2 GEGLU a block and
    a fusion block (crossattn), or K1 unmasked and K2 a block ('sup', whose
    attention JAX runs plain: the same function); the ViT-Adapter's injector
    and extractor K4 an interaction group each."""
    out = collections.Counter({"ms_deform_attn/forward": cfg.transformer_enc_layers})
    if cfg.backbone_type in ("vit", "vit_adapter"):
        if cfg.backbone_type == "vit" and cfg.fusion_mode == "sup":
            out.update({"zorro_attention_qkv/none": cfg.depth, "fused_ffn/geglu": cfg.depth})
        else:
            out.update({"zorro_attention_qkv/zorro": cfg.depth, "fused_ffn/geglu": 2 * cfg.depth})
    if cfg.backbone_type == "vit_adapter":
        out["ms_deform_attn/forward"] += 2 * len(interaction_groups(cfg.depth))
    return dict(out)


def backbone_per_step(cfg: MaskFormerConfig):
    """A step's kernels: each forward kernel's backward once, and the
    criterion's K5 five times and K5b once a prediction level (the decoder's
    layers, plus the Mask2Former decoder's initial prediction)."""
    fwd = backbone_per_forward(cfg)
    levels = cfg.dec_layers + (1 if cfg.decoder_type == "mask2former" else 0)
    out = {**fwd, **{("ms_deform_attn/backward" if k == "ms_deform_attn/forward" else f"{k}_backward"): n
                     for k, n in fwd.items()}}
    return {**out, "point_sample/forward": 5 * levels, "point_sample/backward": levels}


def backbone_model(dev, cfg: MaskFormerConfig, serving: bool):
    """build_maskformer(cfg) with seeded weights, as segment_model: N(0,
    0.02) noise on every deformable attention's zero sampling kernels (the
    adapter's too), the injectors' zero gamma drawn N(0, 0.1), the mask
    head's last layer x 6; for serving the backbone bf16 and the head f32."""
    from incomplete_multimodal_fusion_tpu_torch.models.vit_adapter import Injector

    model = build_maskformer(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    if serving:
        model.backbone.to(torch.bfloat16)
    noise = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MSDeformAttn):
                for lin in (m.sampling_offsets, m.attention_weights):
                    lin.weight.add_((0.02 * torch.randn(lin.weight.shape, generator=noise)).to(lin.weight))
            elif isinstance(m, Injector):
                m.gamma.copy_((0.1 * torch.randn(m.gamma.shape, generator=noise)).to(m.gamma))
        layer2 = model.predictor.mask_embed.layer2
        layer2.weight.mul_(6.0)
        layer2.bias.mul_(6.0)
    return model.eval() if serving else model


def backbone_forward(tag, model, run, x, dropped, want):
    """One main-path forward ``run(x)`` with the counts from 0: its launches
    (exactly ``want``); its outputs against the plain path within
    SEG_REL_L2, as phase 6 holds them: pred_logits, pred_masks and, for a
    semantic request, the class probabilities, for an instance request the
    instances' scores (each image's, sorted); with ``dropped``, bitwise
    unmoved by the dropped pixels; wall p50, device ms, busy share, peak
    memory. Returns the launches."""
    ops.reset_kernel_launches()
    answer = run(x)
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.kernel_launches().items() if n}
    if counts != want:
        raise RuntimeError(f"[backbones] {tag}: launches a forward {counts}, expected {want}")
    out_k = infer_segmentation.segmentation_outputs(model, None, x, dropped)
    model.attn_impl = "xla"
    out_p = infer_segmentation.segmentation_outputs(model, None, x, dropped)
    answer_p = run(x)
    model.attn_impl = "auto"
    hw = (model.cfg.image_size, model.cfg.image_size)
    compared = {k: (out_k[k], out_p[k]) for k in ("pred_logits", "pred_masks")}
    if isinstance(answer, list):  # instances: each image's scores, sorted
        compared["instance scores"] = tuple(torch.stack([a["scores"].sort().values for a in ans])
                                            for ans in (answer, answer_p))
    else:
        compared["probabilities"] = (infer_segmentation.semantic_probabilities(out_k, hw),
                                     infer_segmentation.semantic_probabilities(out_p, hw))
    if not all(torch.isfinite(a).all() for a, _ in compared.values()):
        raise RuntimeError(f"[backbones] {tag}: non-finite outputs")
    rels = {k: rel_l2(a, b) for k, (a, b) in compared.items()}
    if not max(rels.values()) <= SEG_REL_L2:
        raise RuntimeError(f"[backbones] {tag}: rel L2 vs plain path {rels} > {SEG_REL_L2}")
    note = ""
    if dropped:
        moved = {d: (v * 0.0 + 123.0 if d in dropped else v) for d, v in x.items()}
        out_m = infer_segmentation.segmentation_outputs(model, None, moved, dropped)
        if not (all(torch.equal(out_k[k], out_m[k]) for k in ("pred_logits", "pred_masks"))
                and torch.equal(run(moved), answer)):
            raise RuntimeError(f"[backbones] {tag}: the answer moved with the dropped pixels {dropped}")
        note = f", bitwise unmoved by {'/'.join(dropped)}'s pixels"
    b = next(iter(x.values())).shape[0]
    torch.cuda.reset_peak_memory_stats()
    p50 = statistics.median(wall_ms(lambda: run(x), reps=5, warmup=1))
    peak = torch.cuda.max_memory_allocated()
    dev_ms, n_kernels, by_kind, _ = device_breakdown(lambda: run(x), reps=2, top_n=0)
    log(f"[backbones] {tag}: launches a forward exact {counts}; rel_l2 vs plain path "
        + ", ".join(f"{k} {v:.6g}" for k, v in rels.items()) + f"{note}; p50 {p50:.6g} ms ({b / p50 * 1e3:.6g} "
        f"images/s), device {dev_ms:.6g} ms a forward in {n_kernels:.0f} kernels/copies, busy "
        f"{dev_ms / p50:.3f}, by kind " + ", ".join(f"{k} {v:.6g} ms" for k, v in sorted(by_kind.items()))
        + f"; peak device memory {peak / 2 ** 30:.4g} GiB")
    return counts


@contextlib.contextmanager
def msda_core_in_f64():
    """The plain deformable-attention core computed in f64 on the same
    operands and cast back to the value's dtype: the same function with the
    f32 core's rounding taken out, the control beside phase 15's free plain
    path."""
    real = msda_module.ms_deform_attn_core

    def core(value, shapes, locs, weights):
        return real(value.double(), shapes, locs.double(), weights.double()).to(value.dtype)

    msda_module.ms_deform_attn_core = core
    try:
        yield
    finally:
        msda_module.ms_deform_attn_core = real


def backbone_step(tag, dev, model, cfg, rng):
    """The B = 30 instance step (phase 7's settings) on ``model``: the
    kernel path's loss and gradients against the plain path on the same
    masks, matches and points, dropout off, and with the Mask2Former head's
    attention-mask bits pinned to the kernel path's (TRAIN_LOSS_REL,
    TRAIN_GRAD_REL_L2; a crossattn backbone's mask embedding at
    MASK_EMB_GRAD_REL_L2): in bf16 the kernels' last-bit differences flip
    some of those bits near the sigmoid's 0.5, and the head amplifies each
    flip (phase 9 c: none flip in f32). The free plain path (its own bits)
    is held too, at FREE_LOSS_REL and FREE_MASK_BITS; beside it the control,
    the free plain path with its deformable-attention core in f64, against
    the plain path: what rounding alone, in one module, moves. Then one
    main-path step
    with the counts from 0 (exactly backbone_per_step); 3 timed steps,
    device ms, busy share, peak memory. Returns the step's launches."""
    optimizer = downstream.create_downstream_optimizer(model, lr=1e-4, clip_grad=0.01,
                                                       frozen_stages=cfg.frozen_stages)
    step = downstream.make_downstream_train_step(model, cfg, optimizer)
    state = downstream.DownstreamState(model, optimizer, torch.Generator().manual_seed(SEED))
    x, targets = synthetic_instances(rng, BACKBONE_BATCH, cfg.image_size, 1)
    batch = {d: torch.from_numpy(v).to(dev) for d, v in x.items()}
    targets = downstream.as_targets(targets, dev)
    doms, nums = cfg.in_domains, (cfg.num_patches,) * len(cfg.in_domains)
    g = torch.Generator().manual_seed(SEED)
    present = masking.sample_modality_subset(g, len(doms))
    mi = masking.incomplete_random_masks(g, doms, nums, present, cfg.max_encoded_tokens, BACKBONE_BATCH,
                                         device=dev)
    present = present.to(dev)
    masked = cfg.decoder_type == "mask2former"

    def run_loss(**kw):
        return step.loss_fn(dict(model.named_parameters()), batch, targets, mi, present, SEED, **kw)

    model.zero_grad(set_to_none=True)
    with head_masks(model) if masked else contextlib.nullcontext() as bits_k:
        loss_k, _, aux = run_loss(return_aux=True)
    loss_k.backward()
    g_k = flat_grads(model)
    fixed = dict(matched_override=aux["matched"], point_coords_override=aux["point_coords"])
    model.attn_impl = "xla"
    free, free_ok = "", True
    if masked:
        with torch.no_grad():
            with head_masks(model) as bits_p:
                loss_free = float(run_loss(**fixed)[0])
            with head_masks(model) as bits_c, msda_core_in_f64():
                loss_ctrl = float(run_loss(**fixed)[0])
        free_rel = abs(loss_free - float(loss_k.detach())) / abs(loss_free)
        flips, ctrl_flips = mask_bits_differ(bits_k, bits_p), mask_bits_differ(bits_c, bits_p)
        free_ok = free_rel <= FREE_LOSS_REL and flips[0] <= FREE_MASK_BITS * flips[1]
        free = (f"; free plain path (its own head mask bits) loss {loss_free:.6g}, rel {free_rel:.3g} (bound "
                f"{FREE_LOSS_REL}), bits that differ {flips[0]} of {flips[1]} (bound {FREE_MASK_BITS} of them); "
                f"control, its deformable-attention core in f64: loss {loss_ctrl:.6g}, rel "
                f"{abs(loss_ctrl - loss_free) / abs(loss_free):.3g}, bits that differ from the free plain path's "
                f"{ctrl_flips[0]}")
    model.zero_grad(set_to_none=True)
    with head_masks(model, pinned=bits_k) if masked else contextlib.nullcontext():
        loss_p, _ = run_loss(**fixed)
    loss_p.backward()
    g_p = flat_grads(model)
    model.attn_impl = "auto"
    model.zero_grad(set_to_none=True)
    loss_k, loss_p = float(loss_k.detach()), float(loss_p.detach())
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    emb = "backbone.mask_embedding"
    rest = [n for n in g_p if n != emb]
    grad_rel, worst = compare_grads(g_k, g_p, rest)
    emb_rel = rel_l2(g_k[emb], g_p[emb]) if emb in g_p else 0.0
    del aux, g_k, g_p
    if not (math.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2
            and emb_rel <= MASK_EMB_GRAD_REL_L2 and free_ok):
        raise RuntimeError(f"[backbones] {tag} step: kernel vs plain path loss rel {loss_rel} (bound "
                           f"{TRAIN_LOSS_REL}), gradient rel L2 {grad_rel} (bound {TRAIN_GRAD_REL_L2}), mask "
                           f"embedding {emb_rel} (bound {MASK_EMB_GRAD_REL_L2}); worst {worst}{free}")
    ops.reset_kernel_launches()
    step(state, batch, targets)
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.kernel_launches().items() if n}
    want = backbone_per_step(cfg)
    if counts != want:
        raise RuntimeError(f"[backbones] {tag} step: launches {counts}, expected {want}")
    torch.cuda.reset_peak_memory_stats()
    times, losses = step_times(lambda: step(state, batch, targets)[1], steps=3, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"[backbones] {tag} step: losses {losses}")
    p50 = statistics.median(times)
    dev_ms, n_kernels, by_kind, _ = device_breakdown(lambda: step(state, batch, targets), reps=1, top_n=0)
    log(f"[backbones] {tag} step B={BACKBONE_BATCH}: loss kernel path {loss_k:.6g}, plain path {loss_p:.6g} "
        f"(rel {loss_rel:.3g}), flat gradient rel_l2 {grad_rel:.3g}"
        + (f", the mask embedding's {emb_rel:.3g}" if emb in dict(model.named_parameters()) else "")
        + f" (worst {worst[0][1]} {worst[0][0]:.3g}){free}; launches a step exact {counts}; p50 {p50:.6g} ms "
        f"({BACKBONE_BATCH / p50 * 1e3:.6g} images/s), device {dev_ms:.6g} ms a step in {n_kernels:.0f} "
        f"kernels/copies, busy {dev_ms / p50:.3f}, by kind "
        + ", ".join(f"{k} {v:.6g} ms" for k, v in sorted(by_kind.items()))
        + f"; peak device memory {peak / 2 ** 30:.4g} GiB; losses {[round(v, 4) for v in losses]}")
    return counts


def phase_backbones(dev):
    """Phase 15. (a) MaskFormerConfig(backbone_type='vit_adapter',
    num_classes=10), bf16 backbone and f32 head: forward_segmentation at B =
    1, B = 1 with dem dropped and B = 30 (K4 8 in the backbone and 2 in the
    pixel decoder a forward). (b) The B = 30 instance step on the adapter
    (K4b 8 + 2). (c) resnet50, resnet18, swin, sup and the vit backbone
    with the standard decoder: one B = 30 step each and, on the step's
    weights with the backbone in bf16, one B = 30
    forward_instance_segmentation. Returns the main-path runs' launches."""
    rng = np.random.default_rng(SEED + 15)
    launches = collections.Counter()
    cfg = MaskFormerConfig(num_classes=SEG_CLASSES, backbone_type="vit_adapter")
    model = backbone_model(dev, cfg, serving=True)
    doms, size = cfg.in_domains, cfg.image_size
    x1, x30 = synthetic_batch(rng, doms, 1, size), synthetic_batch(rng, doms, 30, size)

    def semantic(dropped):
        return lambda x: infer_segmentation.forward_segmentation(model, None, x, SEG_CLASSES, dropped)

    want = backbone_per_forward(cfg)
    for kind, x, dropped in (("B=1", x1, ()), ("B=1 dem dropped", x1, ("dem",)), ("B=30", x30, ())):
        launches.update(backbone_forward(f"(a) vit_adapter semantic {kind}", model, semantic(dropped), x, dropped,
                                         want))
    del model
    for name, change in BACKBONES.items():
        cfg = MaskFormerConfig(num_classes=1, **change)
        model = backbone_model(dev, cfg, serving=False)
        tag = "(b) vit_adapter" if name == "vit_adapter" else f"(c) {name}"
        launches.update(backbone_step(tag, dev, model, cfg, rng))
        if name == "vit_adapter":
            continue
        model.backbone.to(torch.bfloat16)
        model.eval()
        x = synthetic_batch(rng, doms, BACKBONE_BATCH, size)
        launches.update(backbone_forward(
            f"{tag} instance B={BACKBONE_BATCH}", model,
            lambda x: infer_segmentation.forward_instance_segmentation(model, None, x, topk=100), x, (),
            backbone_per_forward(cfg)))
        del model
    return dict(launches)



# phase 16: the host data path. Trees written from SEED under build/ and
# removed after; the pretraining cell of the slice (B = 60 on 256^2 tiles)
DATA_DIR = os.path.join(ROOT, "build", "chip_smoke_data")  # git-ignored
DATA_TILES = 120  # 256^2 DFC2023 tiles, two B = 60 batches an epoch
DATA_TILES_512 = 60  # the deflate 512^2 copy: one batch an epoch
DATA_TREE = 64  # images or tiles of the COCO, quadruplet and ADE trees
DATA_STEPS, DATA_WARMUP = 4, 1  # timed eager steps after untimed ones (the synthetic stream: 2, no warm-up)
DATA_GROUPS = 4  # timed groups of K = 4 steps from disk, past the ring's 3 filled slots (the others: 2, 1)
NATIVE_ATOL = 1e-4  # the native normalizations against numpy (tests/test_native.py's loader tolerance)


def fed_steps(run, batches, n: int, warmup: int):
    """``run(next(batches))`` ``warmup + n`` times with no synchronize
    between calls, as the CLI loops: (wall ms from each timed call's start to
    the next's, the last ending in a synchronize; ms each timed call waited
    for its batch)."""
    starts, waits = [], []
    for i in range(warmup + n):
        if i == warmup:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = next(batches)
        if i >= warmup:
            starts.append(t0)
            waits.append((time.perf_counter() - t0) * 1e3)
        run(batch)
    torch.cuda.synchronize()
    starts.append(time.perf_counter())
    return [(b - a) * 1e3 for a, b in zip(starts, starts[1:])], waits


def host_batch_ms(source, reps: int):
    """Host ms of ``source.fill`` into fresh arrays, a batch (median of
    ``reps``), and the first batch."""
    times, batches = [], []
    for _ in range(reps):
        out = {k: np.empty(shape, dtype) for k, (shape, dtype) in source.specs.items()}
        t0 = time.perf_counter()
        source.fill(out)
        times.append((time.perf_counter() - t0) * 1e3)
        batches.append(out)
    return statistics.median(times), batches[0]


def copies_ms(per_name) -> float:
    """The copies' share of a device_breakdown's (name, ms) list."""
    return sum(ms for n, ms in per_name if "memcpy" in n.lower())


def max_abs(a, b) -> float:
    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in a)


def cli_run(tag, main_fn, argv, want):
    """A CLI in this process with the counts from 0: its output, checked to
    exit 0 with exactly ``want`` launches; returns (output, launches)."""
    ops.reset_kernel_launches()
    rc, out = run_in_process(main_fn, argv)
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.kernel_launches().items() if n}
    log(f"[data] (b) {tag}: exit {rc}; launches {counts}")
    if rc != 0 or counts != want:
        raise RuntimeError(f"[data] (b) {tag}: exit {rc}, launches {counts} (expected {want}): {out[-3000:]}")
    return out, counts


def log_cli_times(tag: str, out: str) -> None:
    """The step wall p50 and batch wait p50 a CLI printed."""
    wall = parsed(r"step wall p50 (\S+) ms", out, f"(b) {tag} wall")[0]
    wait = parsed(r"batch wait p50 (\S+) ms", out, f"(b) {tag} wait")[0]
    log(f"[data] (b)   {tag}: step wall p50 {wall:.6g} ms, batch wait p50 {wait:.6g} ms")


def phase_data(dev):
    """Phase 16. Writes the trees (a DFC2023 tree of DATA_TILES 256^2
    uncompressed tiles, a deflate 512^2 copy, COCO, quadruplet and ADE .npy
    trees), then (c) the host ms to build a batch on the fused, resize and
    random-crop paths, native against numpy; (a) the first pretraining batch
    through the pinned ring: the device batch bitwise its pinned host batch,
    the host batch within NATIVE_ATOL of the numpy path, the first step's
    loss bitwise the same step fed by torch.from_numpy(batch).cuda(); (c)
    eager and K = 4 steps fed from disk beside one device batch and the
    synthetic stream: wall p50, the ms waited for a batch, busy share,
    pinned MB; (b) the CLIs on the trees: cli.pretrain --data_path
    --steps_per_call 4, cli.infer --data_path (f32), the instance step from
    COCO (and once with --aug), the semantic step from the quadruplet and
    the ADE trees. Returns the main-path runs' launches."""
    launches = collections.Counter()
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    os.makedirs(DATA_DIR)
    try:
        t0 = time.time()
        threads = min(8, os.cpu_count() or 1)
        cfg = PretrainConfig()
        doms, b, size = tuple(cfg.data.in_domains), cfg.data.batch_size, cfg.data.input_size
        dfc = sample_trees.write_dfc2023(os.path.join(DATA_DIR, "dfc"), DATA_TILES, size, seed=SEED, threads=threads)
        dfc512 = sample_trees.write_dfc2023(os.path.join(DATA_DIR, "dfc512"), DATA_TILES_512, 2 * size, seed=SEED + 1,
                                            compression="deflate", threads=threads)
        coco_root, coco_json = sample_trees.write_coco(os.path.join(DATA_DIR, "coco"), DATA_TREE, size, seed=SEED,
                                                       threads=threads)
        quad = sample_trees.write_quadruplet(os.path.join(DATA_DIR, "quad"), DATA_TREE, size, seed=SEED,
                                             threads=threads)
        ade_root, odgt = sample_trees.write_ade(os.path.join(DATA_DIR, "ade"), DATA_TREE, (size + 64, size + 128),
                                                seed=SEED)
        sizes = {name: sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(os.path.join(DATA_DIR, name))
                           for f in fs) / 2 ** 20 for name in ("dfc", "dfc512", "coco", "quad", "ade")}
        log(f"[data] trees written in {time.time() - t0:.1f} s on {threads} threads (MB): "
            + ", ".join(f"{k} {v:.1f}" for k, v in sizes.items()))

        # (c) host ms a batch: the fused load_into path (256^2, uncompressed),
        # the generic path with the resize (512^2 deflate read at 256) and
        # the random crop (512^2 deflate loaded whole, a 256^2 window cut),
        # each native and numpy
        builds = {}
        for name, root, crop in (("fused 256^2", dfc, False), ("resize 512^2 deflate", dfc512, False),
                                 ("crop 512^2 deflate", dfc512, True)):
            for native in (True, False):
                source = dfc2023.DFC2023Batches(root, doms, b, size, seed=SEED, native=native, random_crop=crop)
                builds[name, native] = host_batch_ms(source, 1)
                source.close()
        errs = {name: max_abs(builds[name, True][1], builds[name, False][1]) for name, _ in builds}
        log(f"[data] (c) host ms to build a B = {b} batch on {source.num_threads} threads (os.cpu_count() "
            f"{os.cpu_count()}), native / numpy: " + ", ".join(
                f"{name} {builds[name, True][0]:.6g} / {builds[name, False][0]:.6g}" for name in errs)
            + f"; native vs numpy max abs {errs}")
        if not max(errs.values()) <= NATIVE_ATOL:
            raise RuntimeError(f"[data] native batches {errs} from numpy's (bound {NATIVE_ATOL})")

        # (a) the first pretraining batch and step through the pinned ring
        model, state, optimizer = pretrain.create_train_state(cfg, SEED, total_steps=1000, device=dev)
        step = pretrain.make_train_step(model, cfg, optimizer)
        multi = pretrain.make_multi_step(step, STATE_K)
        ops.reset_kernel_launches()
        loader = DeviceLoader(dfc2023.DFC2023Batches(dfc, doms, b, size, seed=SEED), dev)
        try:
            first = next(loader)
            torch.cuda.synchronize()
            host = {k: v.copy() for k, v in loader.host.items()}
            same_device = all(torch.equal(first[k].cpu(), torch.from_numpy(host[k])) for k in doms)
            plain = dfc2023.DFC2023Batches(dfc, doms, b, size, seed=SEED, native=False)
            plain_batch = {k: np.empty(shape, dtype) for k, (shape, dtype) in plain.specs.items()}
            plain.fill(plain_batch)
            host_err = {k: float(np.abs(host[k] - plain_batch[k]).max()) for k in doms}
            snap = state_snapshot(state)
            mi = step.draw_masks(state, b, dev)
            loss_loader = step(state, first, mi)[1]["loss"]
            state_restore(state, snap)
            loss_direct = step(state, {d: torch.from_numpy(host[d]).to(dev) for d in doms}, mi)[1]["loss"]
            same_loss = torch.equal(loss_loader, loss_direct)
            log(f"[data] (a) first batch: device batch bitwise its pinned host batch {same_device}; host batch vs "
                f"the numpy path max abs {host_err}; first step's loss fed by the loader {float(loss_loader):.9g}, "
                f"by torch.from_numpy(batch).cuda() {float(loss_direct):.9g}: bitwise {same_loss}")
            if not (same_device and same_loss and max(host_err.values()) <= NATIVE_ATOL):
                raise RuntimeError(f"[data] (a) device batch bitwise {same_device}, loss bitwise {same_loss}, "
                                   f"host vs numpy {host_err} (bound {NATIVE_ATOL})")

            # (c) eager: disk (this loader) against the synthetic stream
            results = {}
            run_eager = lambda batch: step(state, batch)  # noqa: E731
            wall, wait = fed_steps(run_eager, loader, DATA_STEPS, DATA_WARMUP)
            dev_ms, _, _, per_name = device_breakdown(lambda: run_eager(next(loader)), reps=1, top_n=None)
            results["disk eager"] = (wall, wait, dev_ms, copies_ms(per_name))
            steps_run = 2 + DATA_WARMUP + DATA_STEPS + 1
            counts = {k: n for k, n in ops.kernel_launches().items() if n}
            want = {k: steps_run * n for k, n in PER_STEP.items()}
            log(f"[data] (b) pretraining from disk, eager, {steps_run} steps: launches {counts}")
            if counts != want:
                raise RuntimeError(f"[data] eager launches {counts}, expected {want}")
            launches.update(counts)
            fill_ms, pinned = [x * 1e3 for x in loader.fill_s], loader.pinned_bytes
        finally:
            loader.close()
        # the step alone: one batch already on the device, fed again and again
        fixed = itertools.repeat(first)
        wall, wait = fed_steps(run_eager, fixed, DATA_STEPS, DATA_WARMUP)
        dev_ms, _, _, per_name = device_breakdown(lambda: run_eager(next(fixed)), reps=1, top_n=None)
        results["one device batch, eager"] = (wall, wait, dev_ms, copies_ms(per_name))
        # the CLI's synthetic stream: its draws take about 0.5 s a batch, so fewer steps
        synth, _ = cli_pretrain.open_data(cfg, False, 0, 1, dev)
        wall, wait = fed_steps(run_eager, synth, 2, 0)
        dev_ms, _, _, per_name = device_breakdown(lambda: run_eager(next(synth)), reps=1, top_n=None)
        results["synthetic eager"] = (wall, wait, dev_ms, copies_ms(per_name))

        # (c) K = 4 (one CUDA graph replayed): disk, then the synthetic stream
        ops.reset_kernel_launches()
        run_graph = lambda batch: multi(state, batch)  # noqa: E731
        loader4 = DeviceLoader(dfc2023.DFC2023Batches(dfc, doms, b, size, seed=SEED), dev, stack=STATE_K)
        try:
            wall, wait = fed_steps(run_graph, loader4, DATA_GROUPS, 1)
            dev_ms, _, _, per_name = device_breakdown(lambda: run_graph(next(loader4)), reps=1, top_n=None)
            results[f"disk K={STATE_K}"] = ([w / STATE_K for w in wall], wait, dev_ms / STATE_K,
                                            copies_ms(per_name) / STATE_K)
            fill4_ms, pinned4 = [x * 1e3 for x in loader4.fill_s], loader4.pinned_bytes
        finally:
            loader4.close()
        counts = {k: n for k, n in ops.kernel_launches().items() if n}
        want = {k: 2 * n for k, n in PER_STEP.items()}  # the warm-up step and the capture
        log(f"[data] (b) pretraining from disk, K = {STATE_K}, {DATA_GROUPS + 2} groups: launches {counts}")
        if counts != want:
            raise RuntimeError(f"[data] K = {STATE_K} launches {counts}, expected {want}")
        launches.update(counts)
        fixed4 = itertools.repeat({d: first[d].expand(STATE_K, *first[d].shape) for d in doms})
        wall, wait = fed_steps(run_graph, fixed4, 2, 0)
        dev_ms, _, _, per_name = device_breakdown(lambda: run_graph(next(fixed4)), reps=1, top_n=None)
        results[f"one device batch, K={STATE_K}"] = ([w / STATE_K for w in wall], wait, dev_ms / STATE_K,
                                                    copies_ms(per_name) / STATE_K)
        synth4, _ = cli_pretrain.open_data(cfg, False, 0, STATE_K, dev)
        wall, wait = fed_steps(run_graph, synth4, 1, 0)
        dev_ms, _, _, per_name = device_breakdown(lambda: run_graph(next(synth4)), reps=1, top_n=None)
        results[f"synthetic K={STATE_K}"] = ([w / STATE_K for w in wall], wait, dev_ms / STATE_K,
                                             copies_ms(per_name) / STATE_K)
        for name, (wall, wait, dev_ms, copy_ms) in results.items():
            p50 = statistics.median(wall)
            log(f"[data] (c) pretraining B = {b}, {name}: wall p50 {p50:.6g} ms a step "
                f"({[round(w, 2) for w in wall]}), "
                f"waited for the batch p50 {statistics.median(wait):.6g} ms (max {max(wait):.6g}) a "
                f"{'group' if 'K=' in name else 'step'}, device {dev_ms:.6g} ms a step (copies {copy_ms:.6g}), busy "
                f"{dev_ms / p50:.3f}")
        log(f"[data] (c) producer ms to fill a pinned slot: eager p50 {statistics.median(fill_ms):.6g} "
            f"({len(fill_ms)} slots), K = {STATE_K} p50 "
            f"{statistics.median(fill4_ms):.6g} ({len(fill4_ms)} slots of {STATE_K} batches); pinned MB "
            f"{pinned / 2 ** 20:.6g} (eager ring), {pinned4 / 2 ** 20:.6g} (K = {STATE_K} ring)")
        del model, state, optimizer, step, multi, first, snap
        torch.cuda.empty_cache()

        # (b) the CLIs on the trees
        pre_dir = os.path.join(DATA_DIR, "pretrain")
        out, counts = cli_run(f"cli.pretrain --data_path --steps_per_call {STATE_K}", cli_pretrain.main,
                              ["--data_path", dfc, "--steps_per_epoch", str(STATE_K), "--epochs", "1",
                               "--steps_per_call", str(STATE_K), "--output_dir", pre_dir],
                              {k: 2 * n for k, n in PER_STEP.items()})
        launches.update(counts)
        seconds = parsed(r"Training time (\S+)s", out, "(b) pretraining time")[0]
        log(f"[data] (b)   pretraining: one group of K = {STATE_K} in {seconds:.6g} s (the CLI's training time, the "
            f"capture included)")
        out, counts = cli_run("cli.infer --data_path (f32, tile 0)", cli_infer.main,
                              ["--ckpt_dir", pre_dir, "--data_path", dfc, "--output",
                               os.path.join(DATA_DIR, "grid.png")], F32_PER_FORWARD)
        launches.update(counts)
        psnr = parsed(r"PSNR (-?[0-9.]+|nan|inf) dB", out, "(b) infer PSNR")
        if "restored params" not in out or not all(math.isfinite(v) for v in psnr):
            raise RuntimeError(f"[data] (b) infer: {out[-2000:]}")
        log(f"[data] (b)   infer PSNR {psnr}")
        down = ["--epochs", "1", "--eval_freq", "100", "--save_freq", "100"]
        for tag, argv, steps, per_step in (
                ("instance, COCO", ["--coco_root", coco_root, "--coco_json", coco_json], 1, SEG_TRAIN_PER_STEP),
                ("instance, COCO --aug", ["--coco_root", coco_root, "--coco_json", coco_json, "--aug"], 1,
                 SEG_TRAIN_PER_STEP),
                ("semantic, quadruplet", ["--task", "semantic", "--num_classes", str(SEG_CLASSES), "--quad_root",
                                          quad], 1, SEM_TRAIN_PER_STEP),
                ("semantic, ADE .npy", ["--task", "semantic", "--num_classes", str(SEG_CLASSES), "--odgt", odgt,
                                        "--ade_root", ade_root], 1, SEM_TRAIN_PER_STEP)):
            out, counts = cli_run(f"cli.train_downstream {tag}, B = 30, {steps} steps", cli_downstream.main,
                                  [*argv, *down, "--steps_per_epoch", str(steps), "--output_dir",
                                   os.path.join(DATA_DIR, tag.replace(" ", "_").replace(",", ""))],
                                  {k: steps * n for k, n in per_step.items()})
            launches.update(counts)
            losses = parsed(r"epoch \d+: loss=(\S+)", out, f"(b) {tag} loss")
            if not all(math.isfinite(v) for v in losses):
                raise RuntimeError(f"[data] (b) {tag}: losses {losses}")
            log_cli_times(f"{tag}, loss {losses}", out)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    return dict(launches)

# ---------------------------------------------------------------------------
# phase 17: the parallel modes (parallel/), on the one card
# ---------------------------------------------------------------------------
# (a) two ranks on cuda:0 over gloo (NCCL refuses two ranks on one device);
# (b) one rank over NCCL, its collectives real but over a group of one;
# (c) what gloo cannot take on CUDA tensors, named and run in (b) alone.
# Each mode is held against the one-process step on the same card, weights,
# batch and masks.
PARALLEL_STEPS = 2
# The change of the weights over the steps against the reference's change (a
# state left unchanged reads 1), and FlatAdamW's first moment after the first
# step, (1 - beta1) times the clipped global gradient (a moment left at 0 reads
# 1): the two read the optimizer's all-reduce, reduce-scatter and all-gather.
# Each mode with data ranks also prints what a rank that skipped the
# all-reduce would read (from its own gradient), which must exceed the limit.
PARALLEL_DELTA_REL_L2 = 0.15
PARALLEL_MU_REL_L2 = TRAIN_GRAD_REL_L2
PARALLEL_GLOO = (("dp", {}, 1), ("zero", {"fsdp": True}, 1), ("tp", {"tp": 2}, 1),
                 ("tp+sp", {"tp": 2, "sp": True}, 1))
PARALLEL_NCCL = ((f"dp graphed K={STATE_K}", {}, STATE_K), ("zero", {"fsdp": True}, 1),
                 ("pp M=2", {"microbatches": 2}, 1))
GLOO_CANNOT = ("pp (gloo's send / recv of a CUDA tensor fails: 'writev ... Bad address'), a graphed step (a CUDA "
               "graph cannot capture gloo's collectives; make_multi_step raises); both run over NCCL in (b); "
               "sp at one rank is the identity (tp = 1), so it runs in (a) alone")
TRUNK_KERNELS = ("zorro_attention_qkv/zorro", "fusion_row_attention/fusion_row", "fused_ffn/geglu")
CLASSMAP_DOMAINS = ("s1", "s2", "dem", "dnw")


def parallel_inputs(cfg, dev, n_masks: int):
    """The global batch of ``cfg`` and ``n_masks`` steps' masks, from seeds:
    every process draws the same."""
    doms = tuple(cfg.data.in_domains)
    nums = (cfg.data.num_patches,) * len(doms)
    b = cfg.data.batch_size
    batch = {d: torch.from_numpy(v).to(dev)
             for d, v in synthetic_batch(np.random.default_rng(SEED), doms, b, cfg.data.input_size).items()}
    masks = [masking.generate_random_masks(torch.Generator().manual_seed(SEED + 100 + i), doms, nums,
                                           cfg.mask.num_encoded_tokens, b, device=dev) for i in range(n_masks)]
    return batch, masks


def segment_inputs(cfg, dev, b: int):
    """The downstream batch, targets, modality subset and masks of phase 7's
    comparison (seeded), the global batch's."""
    x, targets = synthetic_instances(np.random.default_rng(SEED), b, cfg.image_size, 1)
    batch = {d: torch.from_numpy(v).to(dev) for d, v in x.items()}
    g = torch.Generator().manual_seed(SEED)
    doms, nums = cfg.in_domains, (cfg.num_patches,) * len(cfg.in_domains)
    present = masking.sample_modality_subset(g, len(doms))
    mi = masking.incomplete_random_masks(g, doms, nums, present, cfg.max_encoded_tokens, b, device=dev)
    return batch, downstream.as_targets(targets, dev), present.to(dev), mi


def nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def parallel_reference(dev, path: str):
    """The one-process steps every mode is held against, written to
    ``path``: the pretraining step (PretrainConfig(), B = 60) from STATE_K
    fixed masks, eager, and the downstream step (B = 30) with phase 7's
    injections; each step's loss and launches, the first step's gradient
    (and FlatAdamW's first moment after it), the start weights and the
    weights after PARALLEL_STEPS steps (pretraining: and after STATE_K)."""
    cfg = PretrainConfig()
    model, state, optimizer = pretrain.create_train_state(cfg, SEED, total_steps=1000, device=dev)
    step = pretrain.make_train_step(model, cfg, optimizer)
    batch, masks = parallel_inputs(cfg, dev, STATE_K)
    ref = {"pretrain": {"losses": [], "launches": None, "start": weights(model), "params": {}}}
    for i in range(STATE_K):
        ops.reset_kernel_launches()
        state, m = step(state, batch, mask_info=masks[i])
        ref["pretrain"]["losses"].append(float(m["loss"]))
        if i == 0:
            ref["pretrain"]["launches"] = nonzero(ops.kernel_launches())
            ref["pretrain"]["grads"] = {n: g.cpu() for n, g in flat_grads(model).items()}
            ref["pretrain"]["mu"] = {n: v.cpu() for n, v in first_moment(optimizer, state).items()}
            ref["pretrain"]["betas"], ref["pretrain"]["eps"] = optimizer.defaults["betas"], optimizer.defaults["eps"]
            ref["pretrain"]["clip"] = optimizer.clip_grad
        if i + 1 in (PARALLEL_STEPS, STATE_K):
            ref["pretrain"]["params"][i + 1] = weights(model)
    del model, state, optimizer, step
    scfg = MaskFormerConfig(num_classes=1)
    model = segment_model(dev, 1, serving=False)
    optimizer = downstream.create_downstream_optimizer(model, lr=1e-4, clip_grad=0.01,
                                                       frozen_stages=scfg.frozen_stages)
    step = downstream.make_downstream_train_step(model, scfg, optimizer)
    state = downstream.DownstreamState(model, optimizer, torch.Generator().manual_seed(SEED))
    batch, targets, present, mi = segment_inputs(scfg, dev, SEG_TRAIN_BATCH)
    _, _, aux = step.loss_fn(dict(model.named_parameters()), batch, targets, mi, present, SEED, return_aux=True)
    ref["downstream"] = {"losses": [], "matched": aux["matched"].cpu(), "coords": aux["point_coords"].cpu(),
                         "start": weights(model)}
    for i in range(PARALLEL_STEPS):
        ops.reset_kernel_launches()
        state, m = step(state, batch, targets, aux["matched"], mask_info=mi, present=present,
                        point_coords_override=aux["point_coords"], deterministic=True)
        ref["downstream"]["losses"].append(float(m["loss"]))
        if i == 0:
            ref["downstream"]["launches"] = nonzero(ops.kernel_launches())
            ref["downstream"]["grads"] = {n: g.cpu() for n, g in flat_grads(model).items()}
    ref["downstream"]["params"] = weights(model)
    torch.save(ref, path)
    del model, state, optimizer, step, aux
    torch.cuda.empty_cache()
    return ref


COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor", "broadcast", "send",
               "recv")


def step_profile(fn):
    """One ``fn()`` under torch.profiler, each collective it calls from
    Python timed by the host clock between two synchronizes (gloo reduces on
    the host, so its device share is only the copies): (device ms, NCCL's
    kernels' device ms, the collectives' ms, the collective calls)."""
    spent = [0.0, 0]

    def clocked(real):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            spent[0] += (time.perf_counter() - t0) * 1e3
            spent[1] += 1
            return out
        return call

    real = {name: getattr(torch.distributed, name) for name in COLLECTIVES if hasattr(torch.distributed, name)}
    for name, fn_ in real.items():
        setattr(torch.distributed, name, clocked(fn_))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for name, fn_ in real.items():
            setattr(torch.distributed, name, fn_)
    dev_ms = nccl_ms = 0.0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            dev_ms += evt.device_time_total / 1e3
            if "nccl" in evt.name.lower():
                nccl_ms += evt.device_time_total / 1e3
    return dev_ms, nccl_ms, spent[0], spent[1]


def global_grads(model, state, layout):
    """This step's gradient of the global batch in the one-device layout:
    each rank's part (p.grad) summed over the data ranks, the cuts gathered
    over the model ranks."""
    grads = flat_grads(model)
    if state.parallel is not None:
        grads = state.parallel.gather(grads)
    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1) for n in names])
    torch.distributed.all_reduce(flat, group=layout.data_group)
    return dict(zip(names, (v.view_as(grads[n]) for n, v in zip(names, flat.split([grads[n].numel()
                                                                                    for n in names])))))


def flat_vec(tensors, names):
    """``tensors``' entries ``names`` as one f32 vector on the card (the
    CPU where there is none), where phase 17 compares."""
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    return torch.cat([tensors[n].to(dev, torch.float32).reshape(-1) for n in names])


def flat_rel(got, want, names=None) -> float:
    names = list(want) if names is None else names
    a, b = flat_vec(got, names), flat_vec(want, names)
    return float((a - b).norm() / b.norm())


def weights(model, state=None):
    """The model's weights on the host, in the one-device layout."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    if state is not None and state.parallel is not None:
        params = state.parallel.gather(params)
    return {n: p.cpu().clone() for n, p in params.items()}


def first_moment(optimizer, state):
    """FlatAdamW's mu {name: tensor} in the one-device layout: ZeRO's
    slices all-gathered, the tensor-parallel cuts gathered over the model
    ranks."""
    mu = optimizer.state_dict()["mu"].clone()  # the optimizer updates its own in place
    params = optimizer.param_groups[0]["params"]
    parts = dict(zip(optimizer.names, (v.view_as(p) for v, p in zip(mu.split([p.numel() for p in params]),
                                                                    params))))
    return state.parallel.gather(parts) if state.parallel is not None else parts


def delta_rel(got, start, want) -> float:
    """The change of the weights ``got`` - ``start`` against the reference's
    ``want`` - ``start``, relative L2 over the whole model: 1 for weights
    left unchanged."""
    names = list(want)
    g, w, s = (flat_vec(t, names) for t in (got, want, start))
    return float((g - w).norm() / (w - s).norm())


def skipped_allreduce(local, ref) -> tuple:
    """What a rank that used its own gradient ``local`` (its rows' part, in
    the one-device layout) instead of the all-reduced one would read against
    the reference ``ref`` after its first step: its mu, (1 - beta1) times
    the gradient clipped by its own norm, and its first update, whose
    direction is g / (|g| + eps) (AdamW's first step; its weight decay and
    lr are the reference's)."""
    b1, eps, clip = ref["betas"][0], ref["eps"], ref["clip"]
    names = list(ref["mu"])
    g, mu_ref, g_ref = flat_vec(local, names), flat_vec(ref["mu"], names), flat_vec(ref["grads"], names)
    norm = float(g.double().norm())
    scale = (1.0 - b1) * (min(1.0, clip / norm) if clip is not None else 1.0)
    mu = float((g * scale - mu_ref).norm() / mu_ref.norm())
    step, step_ref = g / (g.abs() + eps), g_ref / (g_ref.abs() + eps)
    return mu, float((step - step_ref).norm() / step_ref.norm())


def parallel_pretrain_mode(dev, ref, inputs, kw, k: int):
    """One pretraining mode on this rank (``inputs``: parallel_inputs' global
    batch and masks): its numbers against the reference, its launches over
    the compared steps, its device and collective ms a step and its peak
    memory."""
    cfg = PretrainConfig()
    layout = make_layout(**kw)
    torch.cuda.reset_peak_memory_stats(dev)
    model, state, optimizer = pretrain.create_train_state(cfg, SEED, total_steps=1000, device=dev, layout=layout,
                                                          total_batch_size=cfg.data.batch_size)
    step = pretrain.make_train_step(model, cfg, optimizer, layout=layout)
    batch, masks = inputs
    rows = layout.rows(cfg.data.batch_size)
    batch = {d: v[rows] for d, v in batch.items()}
    masks = [shard_rows(mi, rows) for mi in masks]
    want = ref["losses"]
    out = {"dp": layout.dp, "tp": layout.tp, "pp": layout.pp, "rows": rows.stop - rows.start}
    ops.reset_kernel_launches()
    if k == 1:
        losses = []
        for i in range(PARALLEL_STEPS):
            # the last step is the timed one: under the profiler, its collectives clocked
            last = i == PARALLEL_STEPS - 1
            held = []
            timing = step_profile(lambda: held.append(step(state, batch, mask_info=masks[i])[1])) if last else None
            m = held[0] if last else step(state, batch, mask_info=masks[i])[1]
            losses.append(float(m["loss"]))
            if i == 0:
                out["grad_rel"] = flat_rel(global_grads(model, state, layout), ref["grads"])
                out["mu_rel"] = flat_rel(first_moment(optimizer, state), ref["mu"])
                if layout.dp > 1:  # p.grad is this rank's rows' part
                    local = flat_grads(model)
                    local = state.parallel.gather(local) if state.parallel is not None else local
                    out["mu_rel_skip"], out["delta_rel_skip"] = skipped_allreduce(local, ref)
            if i == PARALLEL_STEPS - 1:
                out["delta_rel"] = delta_rel(weights(model, state), ref["start"], ref["params"][PARALLEL_STEPS])
        out["launches"] = nonzero(ops.kernel_launches())
    else:
        multi = pretrain.make_multi_step(step, k)
        stacked = {d: v.expand(k, *v.shape) for d, v in batch.items()}
        state, ms = multi(state, stacked, masks[:k])
        losses = [float(x) for x in ms["loss"]]
        out["launches"] = nonzero(ops.kernel_launches())
        out["delta_rel"] = delta_rel(weights(model, state), ref["start"], ref["params"][k])
        timing = step_profile(lambda: multi(state, stacked, masks[:k]))  # a group of replays
    out["losses"] = losses
    out["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    dev_ms, nccl_ms, coll_ms, calls = timing
    out.update(dev_ms=dev_ms / k, nccl_ms=nccl_ms / k, coll_ms=coll_ms / k, coll_calls=calls / k,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    del model, state, optimizer, step
    torch.cuda.empty_cache()
    return out


def parallel_downstream_mode(dev, ref):
    """The data-parallel downstream step (phase 7's, B = 30 over the ranks)
    with the reference's injections, two steps."""
    cfg = MaskFormerConfig(num_classes=1)
    layout = downstream_layout(SEG_TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats(dev)
    model = segment_model(dev, 1, serving=False)
    optimizer = downstream.create_downstream_optimizer(model, lr=1e-4, clip_grad=0.01,
                                                       frozen_stages=cfg.frozen_stages, layout=layout)
    step = downstream.make_downstream_train_step(model, cfg, optimizer, layout=layout)
    state = downstream.DownstreamState(model, optimizer, torch.Generator().manual_seed(SEED))
    batch, targets, present, mi = segment_inputs(cfg, dev, SEG_TRAIN_BATCH)
    rows = layout.rows(SEG_TRAIN_BATCH)
    batch, targets, mi = shard_rows(batch, rows), shard_rows(targets, rows), shard_rows(mi, rows)
    g = ref["matched"].shape[-1]
    matched = ref["matched"][:, rows].to(dev)
    coords = ref["coords"].reshape(ref["coords"].shape[0], SEG_TRAIN_BATCH, g, *ref["coords"].shape[2:])
    coords = coords[:, rows].reshape(coords.shape[0], -1, *coords.shape[3:]).to(dev)
    out = {"dp": layout.dp, "rows": rows.stop - rows.start, "losses": []}
    ops.reset_kernel_launches()
    emb = "backbone.mask_embedding"
    def run():
        return step(state, batch, targets, matched, mask_info=mi, present=present, point_coords_override=coords,
                    deterministic=True)[1]

    for i in range(PARALLEL_STEPS):
        held = []
        if i == PARALLEL_STEPS - 1:  # the timed step
            timing = step_profile(lambda: held.append(run()))
        m = held[0] if held else run()
        out["losses"].append(float(m["loss"]))
        if i == 0:  # the optimizer summed the gradients over the ranks in place
            grads = flat_grads(model)
            out["grad_rel"] = flat_rel(grads, ref["grads"], [n for n in grads if n != emb])
            out["emb_rel"] = flat_rel(grads, ref["grads"], [emb])
    out["launches"] = nonzero(ops.kernel_launches())
    out["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], ref["losses"]))
    out["delta_rel"] = delta_rel(weights(model), ref["start"], ref["params"])
    dev_ms, nccl_ms, coll_ms, calls = timing
    out.update(dev_ms=dev_ms, nccl_ms=nccl_ms, coll_ms=coll_ms, coll_calls=calls,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    del model, state, optimizer, step
    torch.cuda.empty_cache()
    return out


def parallel_modes(dev, backend: str, ref) -> dict:
    """This rank's modes of ``backend`` (PARALLEL_GLOO and the downstream
    step, or PARALLEL_NCCL) against the reference ``ref``: {mode: numbers}."""
    inputs = parallel_inputs(PretrainConfig(), dev, STATE_K)
    results = {}
    for name, kw, k in (PARALLEL_GLOO if backend == "gloo" else PARALLEL_NCCL):
        t0 = time.time()
        results[name] = parallel_pretrain_mode(dev, ref["pretrain"], inputs, kw, k)
        results[name]["seconds"] = time.time() - t0
    if backend == "gloo":
        t0 = time.time()
        results["downstream dp"] = parallel_downstream_mode(dev, ref["downstream"])
        results["downstream dp"]["seconds"] = time.time() - t0
    return results


def parallel_worker(argv) -> int:
    """One gloo rank of phase 17 (a): ``--parallel-worker gloo REF RANK
    WORLD PORT``; rank 0 writes its modes' numbers to REF.gloo.json."""
    backend, ref_path, rank, world, port = argv[0], argv[1], int(argv[2]), int(argv[3]), int(argv[4])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pdist.init_distributed_mode("cuda", backend=backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                                rank=rank)
    try:
        results = parallel_modes(torch.device("cuda", 0), backend, torch.load(ref_path, weights_only=False))
        if rank == 0:
            with open(f"{ref_path}.{backend}.json", "w") as f:
                json.dump(results, f)
    finally:
        pdist.destroy()
    return 0


def nccl_modes(dev, ref) -> dict:
    """Phase 17 (b) in this process: a process group of one rank over
    NCCL."""
    pdist.init_distributed_mode("cuda", backend="nccl", init_method=f"tcp://127.0.0.1:{pdist.free_port()}",
                                world_size=1, rank=0)
    try:
        return parallel_modes(dev, "nccl", ref)
    finally:
        pdist.destroy()


def spawn_ranks(backend: str, ref_path: str, world: int, timeout: int = 300) -> dict:
    """``world`` worker processes of this script on cuda:0 (``backend``
    gloo); their modes' numbers (rank 0's)."""
    port = pdist.free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-worker", backend, ref_path,
                               str(r), str(world), str(port)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"[parallel] {backend} ranks failed:\n" + "\n".join(x[-4000:] for x in logs))
    with open(f"{ref_path}.{backend}.json") as f:
        return json.load(f)


def expected_launches(per_step, name: str, steps: int = PARALLEL_STEPS):
    """A mode's launches over its compared steps: the one-process step's
    per step; the trunk's kernels once a microbatch under the pipeline; the
    graphed step's warm-up and capture (its replays launch nothing)."""
    micro = 2 if name.startswith("pp") else 1
    out = {k: n * steps * (micro if k.replace("_backward", "") in TRUNK_KERNELS else 1)
           for k, n in per_step.items()}
    return out


def classmap_backbone(dev):
    """(d) The class-map backbone (in_domains s1, s2, dem, dnw: K1 at
    N = 1024 + 256): one B = 30 forward and one step's loss and gradient,
    kernel path against plain path; returns the forward's and the step's
    launches."""
    x, _ = synthetic_instances(np.random.default_rng(SEED), SEG_TRAIN_BATCH, 256, 1)
    x["dnw"] = np.random.default_rng(SEED + 1).integers(0, 9, (SEG_TRAIN_BATCH, 256, 256)).astype(np.int32)
    batch = {d: torch.from_numpy(v).to(dev) for d, v in x.items()}
    model = segment_model(dev, 1, serving=True, in_domains=CLASSMAP_DOMAINS)
    ops.reset_kernel_launches()
    with torch.no_grad():
        out_k = model(batch)
    torch.cuda.synchronize()
    fwd_launches = nonzero(ops.kernel_launches())
    model.attn_impl = "xla"
    with torch.no_grad():
        out_p = model(batch)
    model.attn_impl = "auto"
    rels = {k: rel_l2(out_k[k], out_p[k]) for k in ("pred_logits", "pred_masks")}
    log(f"[parallel] (d) class-map backbone B={SEG_TRAIN_BATCH} forward, kernel vs plain path rel_l2 "
        + ", ".join(f"{k} {v:.3g}" for k, v in rels.items()) + f"; launches {fwd_launches}")
    if fwd_launches != SEG_PER_FORWARD or max(rels.values()) > SEG_REL_L2:
        raise RuntimeError(f"[parallel] (d) forward: launches {fwd_launches} (want {SEG_PER_FORWARD}), rel_l2 "
                           f"{rels} (bound {SEG_REL_L2})")
    del model, out_k, out_p
    cfg = MaskFormerConfig(num_classes=1, in_domains=CLASSMAP_DOMAINS)
    model = segment_model(dev, 1, serving=False, in_domains=CLASSMAP_DOMAINS)
    optimizer = downstream.create_downstream_optimizer(model, lr=1e-4, clip_grad=0.01,
                                                       frozen_stages=cfg.frozen_stages)
    step = downstream.make_downstream_train_step(model, cfg, optimizer)
    _, targets = synthetic_instances(np.random.default_rng(SEED), SEG_TRAIN_BATCH, 256, 1)
    targets = downstream.as_targets(targets, dev)
    g = torch.Generator().manual_seed(SEED)
    nums = (cfg.num_patches,) * len(CLASSMAP_DOMAINS)
    present = torch.ones(len(CLASSMAP_DOMAINS), dtype=torch.bool)
    mi = masking.incomplete_random_masks(g, CLASSMAP_DOMAINS, nums, present, cfg.max_encoded_tokens,
                                         SEG_TRAIN_BATCH, device=dev)
    present = present.to(dev)
    ops.reset_kernel_launches()
    model.zero_grad(set_to_none=True)
    with head_masks(model) as bits_k:
        loss_k, _, aux = step.loss_fn(dict(model.named_parameters()), batch, targets, mi, present, SEED,
                                      return_aux=True)
    loss_k.backward()
    torch.cuda.synchronize()
    step_launches = nonzero(ops.kernel_launches())
    g_k = flat_grads(model)
    model.attn_impl = "xla"
    model.zero_grad(set_to_none=True)
    with head_masks(model, pinned=bits_k):
        loss_p, _ = step.loss_fn(dict(model.named_parameters()), batch, targets, mi, present, SEED,
                                 matched_override=aux["matched"], point_coords_override=aux["point_coords"])
    loss_p.backward()
    g_p = flat_grads(model)
    model.attn_impl = "auto"
    loss_k, loss_p = float(loss_k.detach()), float(loss_p.detach())
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    emb = "backbone.mask_embedding"
    grad_rel, worst = compare_grads(g_k, g_p, [n for n in g_p if n != emb])
    emb_rel = rel_l2(g_k[emb], g_p[emb])
    class_rel = rel_l2(g_k["backbone.input_adapters.dnw.class_emb"], g_p["backbone.input_adapters.dnw.class_emb"])
    log(f"[parallel] (d) class-map backbone step, kernel vs plain path (head bits pinned): loss "
        f"{loss_k:.6g} vs {loss_p:.6g}, rel {loss_rel:.3g}; gradient rel_l2 {grad_rel:.3g} (the "
        f"class embedding's {class_rel:.3g}, the mask embedding's {emb_rel:.3g}); launches {step_launches}; "
        "worst: " + ", ".join(f"{n} {r:.3g}" for r, n in worst))
    if not (loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL_L2 and emb_rel <= MASK_EMB_GRAD_REL_L2):
        raise RuntimeError(f"[parallel] (d) step: loss rel {loss_rel}, gradient {grad_rel}, mask embedding "
                           f"{emb_rel}")
    del model, optimizer, step, g_k, g_p, aux
    torch.cuda.empty_cache()
    return fwd_launches, step_launches


def phase_parallel(dev):
    """Phase 17 (parallel/): (a) two gloo ranks on the card, (b) one NCCL
    rank in this process, (c) what gloo cannot take, (d) the class-map
    backbone; returns the launches of the modes' steps (the gloo workers'
    counts among them) and of (d)."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ref_path = os.path.join(ROOT, "build", "chip_smoke_parallel.pt")
    launches = collections.Counter()
    failed = []
    try:
        ref = timed("parallel: the one-process reference", parallel_reference, dev, ref_path)
        per_step = ref["pretrain"]["launches"]
        if per_step != PER_STEP:
            raise RuntimeError(f"[parallel] the one-process step launched {per_step}, expected {PER_STEP}")
        log(f"[parallel] one-process reference: pretraining losses {[round(x, 5) for x in ref['pretrain']['losses']]}"
            f", downstream {[round(x, 5) for x in ref['downstream']['losses']]}")
        log(f"[parallel] (c) not over gloo on CUDA tensors: {GLOO_CANNOT}")
        for backend, world in (("gloo", 2), ("nccl", 1)):
            results = (timed("parallel: (a) 2 gloo ranks", spawn_ranks, backend, ref_path, world) if backend == "gloo"
                       else timed("parallel: (b) 1 nccl rank, in this process", nccl_modes, dev, ref))
            for name, r in results.items():
                is_down = name.startswith("downstream")
                want = expected_launches(ref["downstream"]["launches"] if is_down else per_step, name) \
                    if not name.startswith("dp graphed") else {k: 2 * n for k, n in per_step.items()}
                part = "(a)" if backend == "gloo" else "(b)"
                log(f"[parallel] {part} {backend} {name}: {world} rank(s) x {r['rows']} rows (dp {r['dp']}"
                    + (f", tp {r['tp']}, pp {r['pp']}" if not is_down else "")
                    + f"); losses {[round(x, 5) for x in r['losses']]}, rel to one process {r['loss_rel']:.3g}"
                    + (f", gradient rel_l2 {r['grad_rel']:.3g}" if "grad_rel" in r else "")
                    + (f" (mask embedding {r['emb_rel']:.3g})" if "emb_rel" in r else "")
                    + (f", first moment rel_l2 {r['mu_rel']:.3g}" if "mu_rel" in r else "")
                    + f", change of the weights rel_l2 {r['delta_rel']:.3g} (unchanged reads 1)"
                    + (f"; a rank that skipped the all-reduce would read mu {r['mu_rel_skip']:.3g}, first step "
                       f"{r['delta_rel_skip']:.3g}" if "mu_rel_skip" in r else "")
                    + f"; device {r['dev_ms']:.6g} ms a step, collectives {r['coll_ms']:.6g} ms a step "
                    f"({r['coll_calls']:.0f} calls from Python, each synchronized; NCCL kernels "
                    f"{r['nccl_ms']:.6g} ms on the device); peak {r['peak_gib']:.4g} GiB a rank; "
                    f"{r['seconds']:.1f} s (ranks share one card: no multi-GPU figure)")
                bad = (r["launches"] != want or not r["loss_rel"] <= TRAIN_LOSS_REL
                       or not r.get("grad_rel", 0.0) <= TRAIN_GRAD_REL_L2
                       or not r.get("emb_rel", 0.0) <= MASK_EMB_GRAD_REL_L2
                       or not r.get("mu_rel", 0.0) <= PARALLEL_MU_REL_L2
                       or not r["delta_rel"] <= PARALLEL_DELTA_REL_L2
                       # the checks must see a rank that skipped the all-reduce
                       or not r.get("mu_rel_skip", math.inf) > PARALLEL_MU_REL_L2
                       or not r.get("delta_rel_skip", math.inf) > PARALLEL_DELTA_REL_L2)
                if bad:  # every mode is read before the phase fails
                    failed.append(f"{backend} {name}: {r} (launches want {want})")
                launches.update(r["launches"])
        if failed:
            raise RuntimeError("[parallel] " + "\n".join(failed))
        fwd, step = timed("parallel: (d) the class-map backbone", classmap_backbone, dev)
        launches.update(fwd)
        launches.update(step)
    finally:
        for suffix in ("", ".gloo.json"):
            if os.path.exists(ref_path + suffix):
                os.remove(ref_path + suffix)
    return dict(launches)


REPLACES = {
    "zorro_attention_qkv/zorro": ("csrc/zorro_attention.cu",
                                  "incomplete_multimodal_fusion_tpu/ops/pallas_attn.py:707"),
    "zorro_attention_qkv/none": ("csrc/zorro_attention.cu",
                                 "incomplete_multimodal_fusion_tpu/ops/pallas_small_attn.py:136"),
    "fused_ffn/geglu": ("csrc/fused_ffn.cu", "incomplete_multimodal_fusion_tpu/ops/pallas_ffn.py:200"),
    "fused_ffn/mlp": ("csrc/fused_ffn.cu", "incomplete_multimodal_fusion_tpu/ops/pallas_ffn.py:374"),
    # the same TPU kernel under jax.vmap over the decoder's tasks (multimae.py:285-289)
    "fused_ffn/mlp_tasks": ("csrc/fused_ffn.cu", "incomplete_multimodal_fusion_tpu/ops/pallas_ffn.py:374"),
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
    "ms_deform_attn/backward": ("csrc/ms_deform_attn.cu",
                                "incomplete_multimodal_fusion_tpu/ops/pallas_msda.py:191"),
    "point_sample/forward": ("csrc/point_sample.cu",
                             "incomplete_multimodal_fusion_tpu/ops/pallas_points.py:124"),
    "point_sample/backward": ("csrc/point_sample.cu",
                              "incomplete_multimodal_fusion_tpu/ops/pallas_points.py:140"),
    "zorro_attention_packed/zorro": ("csrc/zorro_attention.cu",
                                     "incomplete_multimodal_fusion_tpu/ops/pallas_attn.py:818"),
    "zorro_attention_packed/zorro_backward": ("csrc/zorro_attention.cu",
                                              "incomplete_multimodal_fusion_tpu/ops/pallas_attn.py:841"),
    "zorro_sparse/forward": ("csrc/zorro_attention.cu",
                             "incomplete_multimodal_fusion_tpu/ops/pallas_zorro_sparse.py:206"),
    "zorro_sparse/backward": ("csrc/zorro_attention.cu",
                              "incomplete_multimodal_fusion_tpu/ops/pallas_zorro_sparse.py:235"),
    "fused_block_attn/forward": ("csrc/fused_block_attn.cu",
                                 "incomplete_multimodal_fusion_tpu/ops/pallas_block_attn.py:237"),
    "fused_block_attn/backward": ("csrc/fused_block_attn.cu",
                                  "incomplete_multimodal_fusion_tpu/ops/pallas_block_attn.py:261"),
}


# the f32 instances of K1-K3 and K6 (the TPU kernels take f32 too): the same
# sources and TPU kernels as their bf16 instances
REPLACES.update({f32_key(name): where for name, where in list(REPLACES.items())
                 if not name.startswith(("ms_deform_attn/", "point_sample/"))})


def timed(name: str, phase, *args):
    """``phase(*args)``, its wall seconds logged."""
    t0 = time.time()
    out = phase(*args)
    log(f"[time] {name}: {time.time() - t0:.1f} s")
    return out


def main(argv) -> int:
    if argv[1:2] == ["--parallel-worker"]:
        return parallel_worker(argv[2:])
    smi = phase_device()
    dev = torch.device("cuda", 0)
    timed("build", phase_build)
    kernel_results = timed("kernels", phase_kernels, dev)
    if argv[1:] == ["--kernels-only"]:  # phases 1-3 alone; no result line
        return 0
    # the main paths, each run with the counts set to 0 just before it
    served = timed("serving", phase_serving, dev)
    trained, train_context = timed("train", phase_train, dev)
    segmented = timed("segment", phase_segment, dev)
    seg_trained, seg_context = timed("segment-train", phase_segment_train, dev)
    variants = timed("encoder variants", phase_encoder_variants, dev, train_context)
    del train_context
    in_f32 = timed("f32", phase_f32, dev, seg_context)
    del seg_context
    sem_trained = timed("semantic-train", phase_semantic_train, dev)
    state_trained = timed("pretrain-state", phase_pretrain_state, dev)
    by_cli = timed("cli", phase_cli, dev)
    exported = timed("export", phase_export, dev)
    pretrain_variants = timed("pretrain variants", phase_pretrain_variants, dev)
    backbones = timed("backbones", phase_backbones, dev)
    from_disk = timed("data", phase_data, dev)
    in_parallel = timed("parallel", phase_parallel, dev)
    entries = []
    for name in REPLACES:
        launches = sum(run.get(name, 0) for run in (served, trained, segmented, seg_trained, variants, in_f32,
                                                    sem_trained, state_trained, by_cli, exported, pretrain_variants,
                                                    backbones, from_disk, in_parallel))
        if launches <= 0:
            raise RuntimeError(f"{name} was not launched by the main paths")
        entries.append(kernel_entry(name, kernel_results[name], launches))
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
