"""Downstream segmentation training CLI of the port (the JAX package's
scripts/train_downstream.py:96-312 on one device; reference
downstream/*/main.py and maskformer_train_ins_vit.py).

    python -m incomplete_multimodal_fusion_tpu_torch.cli.train_downstream \\
        [--task instance|semantic] [--epochs N] [--steps_per_epoch S] [--batch_size B] \\
        [--pretrained DIR] [--match_mode exact|auction|greedy] [--output_dir DIR] [--device cuda|cpu]

The MaskFormer (``MODEL_SIZES[--model_size]`` widths, one fusion token a
patch) is built on the card unless ``--device cpu``, from ``--seed``, and
trained on the script's synthetic instance batches: a step a batch, the
metrics fetched every step, an abort with exit code 1 on a non-finite loss,
the per-epoch mean metrics and the lr printed; every ``--eval_freq`` epochs
the dice of the full-modality forward on a fresh batch (and for
``--task semantic`` the ConfMatrix AA and mIoU), which steps
ReduceLROnPlateau (mode 'max'); a checkpoint every ``--save_freq`` epochs
and at the last (``output_dir/checkpoint-{epoch}``, utils/checkpoint.py).
``--pretrained DIR`` copies the backbone tensors of the latest checkpoint
in DIR that match by name and shape (a pretraining checkpoint of
``cli.pretrain`` or converted weights of ``cli.convert_checkpoint``). The
flags of the real data paths, augmentation and the other backbones and
fusion modes raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import math
import os
import statistics
import sys
import time

import numpy as np
import torch

from ..config import MODEL_SIZES
from ..data.synthetic import synthetic_instances
from ..eval.metrics import ConfMatrix
from ..models.maskformer import MaskFormerConfig, build_maskformer
from ..train import downstream as ds
from ..utils import checkpoint as ckpt_lib

# flags of scripts/train_downstream.py this port does not run yet, with the
# value that leaves them off
UNPORTED = {"coco_root": "", "coco_json": "", "quad_root": "", "ade_root": "", "odgt": "", "aug": False,
            "segm_downsampling_rate": 1, "backbone": "vit", "fusion_mode": "crossattn"}


def get_args(argv=None):
    p = argparse.ArgumentParser("MaskFormer downstream training (PyTorch / CUDA port)")
    p.add_argument("--task", choices=["instance", "semantic"], default="instance")
    p.add_argument("--epochs", type=int, default=51)
    p.add_argument("--steps_per_epoch", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--clip_grad", type=float, default=0.01)
    p.add_argument("--num_classes", type=int, default=1)
    p.add_argument("--num_queries", type=int, default=100)
    p.add_argument("--dec_layers", type=int, default=3)
    p.add_argument("--num_points", type=int, default=12544)
    p.add_argument("--input_size", type=int, default=256)
    p.add_argument("--frozen_stages", type=int, default=11)
    p.add_argument("--model_size", choices=["tiny", "base", "large"], default="tiny")
    p.add_argument("--match_mode", default="exact", choices=["exact", "auction", "greedy"],
                   help="Hungarian matching: exact (scipy on the host), on-device auction, or greedy")
    p.add_argument("--pretrained", default="", help="checkpoint directory of the backbone's weights")
    p.add_argument("--output_dir", default="./save_downstream")
    p.add_argument("--eval_freq", type=int, default=50)
    p.add_argument("--save_freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--per_sample_masks", action="store_true",
                   help="independent token keep-mask per sample (default: one mask for the batch)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # not ported yet (ROADMAP Queue 1 items 6 and 9): each raises when set
    p.add_argument("--backbone", default="vit",
                   choices=["vit", "vit_adapter", "swin", "resnet18", "resnet34", "resnet50", "resnet101",
                            "resnet152"])
    p.add_argument("--fusion_mode", default="crossattn", choices=["crossattn", "sup"])
    p.add_argument("--coco_root", default="")
    p.add_argument("--coco_json", default="")
    p.add_argument("--quad_root", default="")
    p.add_argument("--ade_root", default="")
    p.add_argument("--odgt", default="")
    p.add_argument("--segm_downsampling_rate", type=int, default=1)
    p.add_argument("--aug", action="store_true")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    for name, off in UNPORTED.items():
        if getattr(args, name) != off:
            raise NotImplementedError(f"--{name} is not ported yet (the port trains the 'vit' crossattn backbone "
                                      "on synthetic batches)")


def build_config(args) -> MaskFormerConfig:
    """The model of scripts/train_downstream.py:111-127: the size's widths,
    one fusion token a patch."""
    m = MODEL_SIZES[args.model_size]
    return MaskFormerConfig(
        image_size=args.input_size, num_classes=args.num_classes, dim_tokens=m.dim_tokens, depth=m.depth,
        dim_head=m.dim_head, heads=m.heads, num_fusion_tokens=(args.input_size // 16) ** 2,
        num_queries=args.num_queries, dec_layers=args.dec_layers, frozen_stages=args.frozen_stages)


def main(argv=None) -> int:
    args = get_args(argv)
    refuse_unported(args)
    cfg = build_config(args)
    model = build_maskformer(cfg, device=args.device, generator=torch.Generator().manual_seed(args.seed))
    device = next(model.parameters()).device
    rng = np.random.default_rng(args.seed)

    def data_iter():
        while True:
            yield synthetic_instances(rng, args.batch_size, args.input_size, args.num_classes)

    data = data_iter()
    # the JAX script initialises its parameters on the first batch, so its
    # training stream starts at the second
    next(data)
    print(f"params: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M  queries={cfg.num_queries}")

    if args.pretrained:
        step_n = ckpt_lib.latest_step(args.pretrained)
        if step_n is not None:
            report = ds.load_pretrained_backbone(model, ckpt_lib.load_model_state(args.pretrained, step_n))
            print(f"restored {len(report['copied'])} backbone tensors from {args.pretrained} step {step_n}")

    optimizer = ds.create_downstream_optimizer(model, lr=args.lr, clip_grad=args.clip_grad,
                                               frozen_stages=args.frozen_stages)
    state = ds.DownstreamState(model, optimizer, torch.Generator().manual_seed(args.seed))
    # synthetic targets are padded instances on both tasks: point-sampled
    # mask losses (scripts/train_downstream.py:132)
    step_fn = ds.make_downstream_train_step(model, cfg, optimizer, num_points=args.num_points, dense_masks=False,
                                            compute_dtype=args.compute_dtype, match_mode=args.match_mode,
                                            per_sample_masks=args.per_sample_masks)
    eval_fn = ds.make_eval_step(model, cfg)
    sem_pred_fn = ds.make_semantic_pred_step(model, cfg, out_size=args.input_size)
    sched = ds.ReduceLROnPlateau(lr=args.lr, mode="max")  # maximize dice
    os.makedirs(args.output_dir, exist_ok=True)
    step_ms = []
    t0 = time.time()
    for epoch in range(args.epochs):
        agg = {}
        for _ in range(args.steps_per_epoch):
            batch, targets = next(data)
            t_step = time.perf_counter()
            state, metrics = step_fn(state, batch, targets)
            # one fetch a step, as the JAX script's: the abort needs the loss
            values = torch.stack([v.float() for v in metrics.values()]).tolist()
            step_ms.append((time.perf_counter() - t_step) * 1e3)
            for k, v in zip(metrics, values):
                agg.setdefault(k, []).append(v)
            # non-finite-loss abort (reference pretrain_mmae.py:506-508)
            if not math.isfinite(agg["loss"][-1]):
                print(f"Loss is {agg['loss'][-1]}, stopping training", flush=True)
                return 1
        line = " ".join(f"{k}={np.mean(v):.4f}" for k, v in agg.items())
        print(f"epoch {epoch}: {line} lr={sched.lr:.2e} ({time.time() - t0:.0f}s)", flush=True)
        # dice eval every eval_freq epochs + ReduceLROnPlateau
        # (maskformer_train_ins_vit.py:163-183)
        if (epoch + 1) % args.eval_freq == 0:
            eval_batch, eval_targets = next(data)
            gt = ds.label_map_from_targets(ds.as_targets(eval_targets, device))
            dice = float(eval_fn(None, eval_batch, gt))
            score = dice
            if args.task == "semantic":
                # ConfMatrix AA / mIoU eval (maskformer_train_seg.py:242-285)
                cm = ConfMatrix(args.num_classes + 1)
                cm.add_batch(gt, sem_pred_fn(None, eval_batch))
                score = cm.get_miou()
                print(f"  eval AA={cm.get_aa():.4f} mIoU={score:.4f}", flush=True)
            new_lr = sched.step(score)
            ds.set_learning_rate(optimizer, new_lr)
            print(f"  eval dice={dice:.4f} lr -> {new_lr:.2e}", flush=True)
        if (epoch + 1) % args.save_freq == 0 or epoch + 1 == args.epochs:
            ckpt_lib.save_checkpoint(args.output_dir, epoch + 1, state)
    print(f"done: {len(step_ms)} steps, step wall p50 {statistics.median(step_ms):.6g} ms" if step_ms else "done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
