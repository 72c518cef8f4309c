"""Pretraining CLI of the port (the JAX package's scripts/pretrain.py, one
device; reference pretraining/pretrain_mmae.py:75-185, 251-418).

    python -m incomplete_multimodal_fusion_tpu_torch.cli.pretrain \\
        [-c config.yaml] [--epochs N] [--steps_per_epoch S] [--steps_per_call K] \\
        [--fusion_mode crossattn|zorro|lstm|crossattn_v1] [--decoder_style simple|full] \\
        [--in_domains s1_2ch-s2_4ch-dem-dnw] [--use_ema] [--task_balancer uncertainty] \\
        [--log_wandb] [--profile_dir DIR --profile_start I --profile_steps N] \\
        [--data_path DIR [--random_crop]] [--output_dir DIR] [--device cuda|cpu]

It reads the flags of scripts/pretrain.py that a single device needs and
runs its loop (scripts/pretrain.py:282-325): a step (or, with
``--steps_per_call K``, K steps replayed from one CUDA graph) a batch, the
metrics logged every 10 steps, an abort on a non-finite ``recon_loss``, a
checkpoint at the epoch boundaries that ``--save_ckpt_freq`` picks (and at
the end), and one JSON line of averaged metrics an epoch in
``output_dir/log.txt``. The batches are synthetic (integer class maps for a
semseg domain such as ``dnw``), or with ``--data_path`` a DFC2023 tree's
(``data.dfc2023.DFC2023Batches``: the JAX script's shuffle from ``--seed``,
``--random_crop`` loading at twice ``--input_size`` and cutting a shared
window), filled by a producer thread into pinned host buffers and copied to
the card on a side stream (``data.loader.DeviceLoader``; with
``--steps_per_call K`` a buffer holds the K batches of a group). With
``--auto_resume`` (the default) it continues from the latest checkpoint in
``output_dir``; either stream is advanced past the batches the
checkpoint's steps took (a DFC2023 tree's without reading them), so a
resumed run sees the batches an unbroken run would. (The JAX script
restarts its DFC2023 stream from the seed instead.) At the end it prints
the wall p50 of a step and the p50 ms a step waited for its batch.

``--log_wandb`` sends every step's metrics to wandb (scripts/pretrain.py:
263-317), or, where wandb does not import or start, to
``output_dir/wandb_fallback.jsonl``, a line a step; the metrics are read at
the logging cadence, so the card is not made to wait every step.
``--profile_dir`` writes a ``torch.profiler`` trace (Chrome JSON,
``trace.json``) of ``--profile_steps`` steps from the ``--profile_start``-th
step of the run (scripts/pretrain.py:85-89, :289-302). The flags of
parallelism raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import sys
import time

import numpy as np

from .. import config as cfg_lib
from ..data.dfc2023 import DFC2023Batches
from ..data.loader import DeviceLoader
from ..data.synthetic import synthetic_iterator
from ..train import pretrain
from ..utils import checkpoint as ckpt_lib
from ..utils.logging import MetricLogger, WandbLogger

# flags of scripts/pretrain.py this port does not run yet, with the value
# that leaves them off
UNPORTED = {"tp": 1, "fsdp": False, "sp": False, "pp": 1, "pp_microbatches": 0}
LOG_EVERY = 10  # steps between metric reads (scripts/pretrain.py:304)


def get_args(argv=None):
    p = argparse.ArgumentParser("MultiMAE pre-training (PyTorch / CUDA port)")
    p.add_argument("-c", "--config", default="", help="YAML config file")
    p.add_argument("--batch_size", type=int, default=None, help="per-device batch")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps_per_epoch", type=int, default=100)
    p.add_argument("--save_ckpt_freq", type=int, default=None)
    p.add_argument("--in_domains", type=str, default=None, help="hyphen separated")
    p.add_argument("--out_domains", type=str, default=None)
    p.add_argument("--model_size", type=str, default="tiny", choices=sorted(cfg_lib.MODEL_SIZES))
    p.add_argument("--fusion_mode", type=str, default=None, choices=["crossattn", "zorro", "lstm", "crossattn_v1"])
    p.add_argument("--decoder_style", type=str, default=None, choices=["simple", "full"],
                   help="default: the config's (simple)")
    p.add_argument("--use_ema", action="store_true", default=None, help="keep a model EMA shadow")
    p.add_argument("--num_encoded_tokens", type=int, default=None)
    p.add_argument("--patch_size", type=int, default=None)
    p.add_argument("--input_size", type=int, default=None)
    p.add_argument("--alphas", type=float, default=None)
    p.add_argument("--sample_tasks_uniformly", action="store_true", default=None)
    p.add_argument("--blr", type=float, default=None)
    p.add_argument("--warmup_epochs", type=int, default=None)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--clip_grad", type=float, default=None)
    p.add_argument("--skip_grad", type=float, default=None)
    p.add_argument("--task_balancer", type=str, default=None, choices=sorted(pretrain.BALANCERS))
    p.add_argument("--fused_adamw", action="store_true", default=None,
                   help="kept for the JAX script's command lines: the port has only the flat AdamW")
    p.add_argument("--no_fused_adamw", action="store_false", dest="fused_adamw")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="train steps per CUDA graph replay group (K sequential steps exactly)")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--no_auto_resume", action="store_false", dest="auto_resume")
    p.add_argument("--compute_dtype", type=str, default=None, choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of a few steps to this directory")
    p.add_argument("--profile_start", type=int, default=10)
    p.add_argument("--profile_steps", type=int, default=3)
    # experiment tracking (pretrain_mmae.py:159-166); without wandb the
    # metrics go to output_dir/wandb_fallback.jsonl
    p.add_argument("--log_wandb", action="store_true")
    p.add_argument("--wandb_entity", type=str, default="")
    p.add_argument("--wandb_project", type=str, default="imf-tpu")
    p.add_argument("--wandb_run_name", type=str, default="")
    p.add_argument("--data_path", type=str, default=None, help="DFC2023-layout dir; synthetic data if empty")
    p.add_argument("--random_crop", action="store_true",
                   help="load rasters at 2x input size and take a shared random crop per sample")
    # not ported yet (ROADMAP Queue 1 item 8): each raises when set
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--sp", action="store_true")
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--pp_microbatches", type=int, default=0)
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    for name, off in UNPORTED.items():
        if getattr(args, name) != off:
            raise NotImplementedError(f"--{name} is not ported yet (the port trains on one device)")


def build_config(args) -> cfg_lib.PretrainConfig:
    if args.config:
        with open(args.config) as f:
            cfg = cfg_lib.from_yaml(f.read())
    else:
        cfg = cfg_lib.PretrainConfig()
    model_cfg = cfg_lib.MODEL_SIZES[args.model_size]
    if args.fusion_mode:
        model_cfg = dataclasses.replace(model_cfg, fusion_mode=args.fusion_mode)
    # fusion tokens must tile the patch grid (multimae_crossattn.py:87)
    input_size = args.input_size or cfg.data.input_size
    patch_size = args.patch_size or cfg.data.patch_size
    n_grid = (input_size // patch_size) ** 2
    if model_cfg.num_fusion_tokens != n_grid:
        model_cfg = dataclasses.replace(model_cfg, num_fusion_tokens=n_grid)
    data_kw = {k: getattr(args, k) for k in ("batch_size", "patch_size", "input_size", "data_path")
               if getattr(args, k) is not None}
    if args.in_domains:
        data_kw["in_domains"] = tuple(args.in_domains.split("-"))
    if args.out_domains:
        data_kw["out_domains"] = tuple(args.out_domains.split("-"))
    mask_kw = {k: getattr(args, k) for k in ("num_encoded_tokens", "alphas") if getattr(args, k) is not None}
    if args.sample_tasks_uniformly:
        mask_kw["sample_tasks_uniformly"] = True
    optim_kw = {k: getattr(args, k) for k in ("blr", "warmup_epochs", "weight_decay", "clip_grad", "skip_grad",
                                              "task_balancer", "fused_adamw") if getattr(args, k) is not None}
    train_kw = {k: getattr(args, k) for k in ("epochs", "save_ckpt_freq", "seed", "output_dir", "compute_dtype",
                                              "use_ema") if getattr(args, k) is not None}
    return cfg_lib.PretrainConfig(
        model=model_cfg, data=dataclasses.replace(cfg.data, **data_kw),
        mask=dataclasses.replace(cfg.mask, **mask_kw),
        decoder=dataclasses.replace(cfg.decoder, **({"style": args.decoder_style} if args.decoder_style else {})),
        optim=dataclasses.replace(cfg.optim, **optim_kw), train=dataclasses.replace(cfg.train, **train_kw))


def send_to(wandb_logger, pending):
    """Each pending (step, metrics) to the wandb logger, in step order (the
    host reads the metrics here); returns the emptied list."""
    if wandb_logger is not None:
        for at, m in pending:
            wandb_logger.set_step(at)
            wandb_logger.update(m)
    return []


def start_profiler(device: str):
    """A running torch.profiler over the host and, on the card, the device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.startswith("cuda") else [])
    profiler = profile(activities=activities)
    profiler.__enter__()
    return profiler


def stop_profiler(profiler, profile_dir: str) -> str:
    """Ends the trace (after the device's queued work) and writes it as
    Chrome JSON to ``profile_dir/trace.json``; returns the path."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    profiler.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    profiler.export_chrome_trace(path)
    print(f"profiler trace written to {path}", flush=True)
    return path


def main(argv=None) -> int:
    args = get_args(argv)
    refuse_unported(args)
    cfg = build_config(args)
    k = max(args.steps_per_call, 1)
    total_steps = args.steps_per_epoch * cfg.train.epochs
    batch_size = cfg.data.batch_size
    print(f"device={args.device} batch={batch_size} total_steps={total_steps} steps_per_call={k}")
    print(json.dumps(dataclasses.asdict(cfg)))

    model, state, _ = pretrain.create_train_state(cfg, cfg.train.seed, total_steps, total_batch_size=batch_size,
                                                  device=args.device)
    print(f"Number of params: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M")
    out_dir = cfg.train.output_dir
    os.makedirs(out_dir, exist_ok=True)
    start_step = 0
    if args.auto_resume and ckpt_lib.latest_step(out_dir) is not None:
        state = ckpt_lib.restore_checkpoint(out_dir, state)
        start_step = state.step
        print(f"Resumed from step {start_step}")
    batches, loader = open_data(cfg, args.random_crop, start_step, k, args.device)
    try:
        return train(args, cfg, model, state, batches, start_step, total_steps, k)
    finally:
        if loader is not None:
            loader.close()


def open_data(cfg, random_crop: bool, start_step: int, k: int, device):
    """The step inputs from ``start_step`` on, K-stacked ({d: [K, B, ...]})
    with K > 1: (iterator, its DeviceLoader or None). A DFC2023 tree
    (``cfg.data.data_path``) goes through pinned buffers to ``device``; the
    synthetic stream gives numpy batches."""
    if cfg.data.data_path:
        source = DFC2023Batches(cfg.data.data_path, cfg.data.in_domains, cfg.data.batch_size, cfg.data.input_size,
                                seed=cfg.train.seed, random_crop=random_crop)
        source.skip(start_step)
        loader = DeviceLoader(source, device, stack=k)
        return loader, loader
    data = synthetic_iterator(cfg.train.seed, cfg.data.in_domains, cfg.data.batch_size, cfg.data.input_size)
    for _ in range(start_step):
        next(data)

    def groups():
        while True:
            stack = [next(data) for _ in range(k)]
            yield {d: np.stack([s[d] for s in stack]) for d in stack[0]} if k > 1 else stack[0]

    return groups(), None


def train(args, cfg, model, state, batches, start_step: int, total_steps: int, k: int) -> int:
    """The loop of scripts/pretrain.py:282-325 from ``start_step``; returns
    the exit code."""
    steps_per_epoch = args.steps_per_epoch
    out_dir = cfg.train.output_dir
    step_fn = pretrain.make_train_step(model, cfg, state.optimizer)
    multi_fn = pretrain.make_multi_step(step_fn, k) if k > 1 else None
    logger = MetricLogger()
    wandb_logger = (WandbLogger(config=dataclasses.asdict(cfg), project=args.wandb_project, entity=args.wandb_entity,
                                run_name=args.wandb_run_name, out_dir=out_dir) if args.log_wandb else None)
    pending = []  # (step, metrics on the device) not yet sent to the wandb logger
    profile_dir, profiler = args.profile_dir, None  # the trace is taken once
    log_path = os.path.join(out_dir, "log.txt")
    step_ms, wait_ms = [], []  # wall ms a step from one group's start to the next's; ms waited for a batch
    t_start = time.time()
    t_group = None
    for step in range(start_step, total_steps, k):
        t0 = time.perf_counter()
        if t_group is not None:
            step_ms.append((t0 - t_group) * 1e3 / k)
        t_group = t0
        epoch = step // steps_per_epoch
        if profile_dir and profiler is None and step - start_step >= args.profile_start:
            profiler = start_profiler(args.device)
        batch = next(batches)
        wait_ms.append((time.perf_counter() - t0) * 1e3)
        if multi_fn is not None:
            state, ms = multi_fn(state, batch)
            metrics = {name: v[-1] for name, v in ms.items()}
            pending += [(step + i, {name: v[i] for name, v in ms.items()}) for i in range(k)]
        else:
            state, metrics = step_fn(state, batch)
            pending.append((step, metrics))
        if profiler is not None and step + k - start_step >= args.profile_start + args.profile_steps:
            stop_profiler(profiler, profile_dir)
            profile_dir, profiler = None, None
        if step % LOG_EVERY == 0:
            vals = {name: float(v) for name, v in metrics.items()}
            logger.update(**vals)
            print(f"epoch {epoch} step {step}: " + " ".join(f"{n}={v:.4f}" for n, v in vals.items()), flush=True)
            pending = send_to(wandb_logger, pending)
            # non-finite-loss abort (pretrain_mmae.py:506-508), read with the
            # logged metrics so the card is not made to wait every step
            if not math.isfinite(vals["recon_loss"]):
                print(f"Loss is {vals['recon_loss']}, stopping training", flush=True)
                return 1
        # epoch boundary: the loop strides K steps, so test whether this
        # group crossed one rather than landed on it
        done = step + k
        if done % steps_per_epoch < k:
            if (epoch + 1) % cfg.train.save_ckpt_freq == 0 or done >= total_steps:
                ckpt_lib.save_checkpoint(out_dir, done, state)
            with open(log_path, "a") as f:
                f.write(logger.jsonl(epoch=epoch, step=step) + "\n")
    send_to(wandb_logger, pending)
    if profiler is not None:
        stop_profiler(profiler, profile_dir)
    if step_ms:
        print(f"step wall p50 {statistics.median(step_ms):.6g} ms; batch wait p50 {statistics.median(wait_ms):.6g} ms "
              f"a {'group' if k > 1 else 'step'}")
    print(f"Training time {time.time() - t_start:.0f}s")
    return 0

if __name__ == "__main__":
    sys.exit(main())
