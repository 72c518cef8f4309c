"""Pretraining CLI of the port (the JAX package's scripts/pretrain.py, one
device; reference pretraining/pretrain_mmae.py:75-185, 251-418).

    python -m incomplete_multimodal_fusion_tpu_torch.cli.pretrain \\
        [-c config.yaml] [--epochs N] [--steps_per_epoch S] [--steps_per_call K] \\
        [--use_ema] [--task_balancer uncertainty] [--output_dir DIR] [--device cuda|cpu]

It reads the flags of scripts/pretrain.py that a single device needs and
runs its loop (scripts/pretrain.py:282-325): a step (or, with
``--steps_per_call K``, K steps replayed from one CUDA graph) on synthetic
batches, the metrics logged every 10 steps, an abort on a non-finite
``recon_loss``, a checkpoint at the epoch boundaries that ``--save_ckpt_freq``
picks (and at the end), and one JSON line of averaged metrics an epoch in
``output_dir/log.txt``. With ``--auto_resume`` (the default) it continues
from the latest checkpoint in ``output_dir``; the synthetic stream is
advanced past the batches the checkpoint's steps took, so a resumed run sees
the batches an unbroken run would. The flags of the real data path,
parallelism, profiling and wandb raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np

from .. import config as cfg_lib
from ..data.synthetic import synthetic_iterator
from ..train import pretrain
from ..utils import checkpoint as ckpt_lib
from ..utils.logging import MetricLogger

# flags of scripts/pretrain.py this port does not run yet, with the value
# that leaves them off
UNPORTED = {"data_path": None, "random_crop": False, "tp": 1, "fsdp": False, "sp": False, "pp": 1,
            "pp_microbatches": 0, "profile_dir": None, "log_wandb": False}


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
    p.add_argument("--fusion_mode", type=str, default=None, choices=["crossattn", "zorro", "lstm"])
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
    # not ported yet (ROADMAP Queue 1 items 8 and 9): each raises when set
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--random_crop", action="store_true")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--sp", action="store_true")
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--pp_microbatches", type=int, default=0)
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--log_wandb", action="store_true")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    for name, off in UNPORTED.items():
        if getattr(args, name) != off:
            raise NotImplementedError(f"--{name} is not ported yet (the port trains on synthetic batches on "
                                      "one device)")


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
    data_kw = {k: getattr(args, k) for k in ("batch_size", "patch_size", "input_size")
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
        mask=dataclasses.replace(cfg.mask, **mask_kw), decoder=cfg.decoder,
        optim=dataclasses.replace(cfg.optim, **optim_kw), train=dataclasses.replace(cfg.train, **train_kw))


def main(argv=None) -> int:
    args = get_args(argv)
    refuse_unported(args)
    cfg = build_config(args)
    k = max(args.steps_per_call, 1)
    steps_per_epoch = args.steps_per_epoch
    total_steps = steps_per_epoch * cfg.train.epochs
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
    data_iter = synthetic_iterator(cfg.train.seed, cfg.data.in_domains, batch_size, cfg.data.input_size)
    for _ in range(start_step):
        next(data_iter)

    step_fn = pretrain.make_train_step(model, cfg, state.optimizer)
    multi_fn = pretrain.make_multi_step(step_fn, k) if k > 1 else None
    logger = MetricLogger()
    log_path = os.path.join(out_dir, "log.txt")
    t_start = time.time()
    for step in range(start_step, total_steps, k):
        epoch = step // steps_per_epoch
        if multi_fn is not None:
            stack = [next(data_iter) for _ in range(k)]
            state, ms = multi_fn(state, {d: np.stack([s[d] for s in stack]) for d in stack[0]})
            metrics = {name: v[-1] for name, v in ms.items()}
        else:
            state, metrics = step_fn(state, next(data_iter))
        if step % 10 == 0:
            vals = {name: float(v) for name, v in metrics.items()}
            logger.update(**vals)
            print(f"epoch {epoch} step {step}: " + " ".join(f"{n}={v:.4f}" for n, v in vals.items()), flush=True)
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
    print(f"Training time {time.time() - t_start:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
