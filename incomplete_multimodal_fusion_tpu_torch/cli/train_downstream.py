"""Downstream segmentation training CLI of the port (the JAX package's
scripts/train_downstream.py:96-312 on one device; reference
downstream/*/main.py and maskformer_train_ins_vit.py).

    python -m incomplete_multimodal_fusion_tpu_torch.cli.train_downstream \\
        [--task instance|semantic] [--epochs N] [--steps_per_epoch S] [--batch_size B] \\
        [--pretrained DIR] [--match_mode exact|auction|greedy] [--output_dir DIR] [--device cuda|cpu] \\
        [--coco_root DIR --coco_json FILE | --quad_root DIR | --odgt FILE --ade_root DIR] [--aug] \\
        [--segm_downsampling_rate R]

The MaskFormer (``MODEL_SIZES[--model_size]`` widths, one fusion token a
patch) is built on the card unless ``--device cpu``, from ``--seed``, and
trained on the data of scripts/train_downstream.py:133-215: with ``--task
instance --coco_root`` a COCO-json rgb/sar/dsm tree (``--aug``: the shared
geometric augmentation), with ``--task semantic --odgt`` an ADE20k odgt
list (RGB only: the model's one domain is s2; ``--aug`` flips,
``--segm_downsampling_rate`` strides the labels), with ``--task semantic
--quad_root`` a quadruplet tree with land-cover labels (``--aug``), else
the script's synthetic instance batches. The readers' batches are filled by
a producer thread into pinned host buffers and copied to the card on a side
stream (``data.loader.DeviceLoader``); the semantic labels become per-class
targets on the device. As in the JAX script the first batch is taken for
the model's initialisation and training starts at the second. A step a
batch, the metrics fetched every step, an abort with exit code 1 on a non-finite loss,
the per-epoch mean metrics and the lr printed; every ``--eval_freq`` epochs
the dice of the full-modality forward on a fresh batch (and for
``--task semantic`` the ConfMatrix AA and mIoU), which steps
ReduceLROnPlateau (mode 'max'); a checkpoint every ``--save_freq`` epochs
and at the last (``output_dir/checkpoint-{epoch}``, utils/checkpoint.py).
``--pretrained DIR`` copies the backbone tensors of the latest checkpoint
in DIR that match by name and shape (a pretraining checkpoint of
``cli.pretrain`` or converted weights of ``cli.convert_checkpoint``).
``--backbone`` and ``--fusion_mode`` take the JAX script's choices.

Under ``torchrun`` (``torchrun --nproc_per_node N -m
incomplete_multimodal_fusion_tpu_torch.cli.train_downstream ...``) the step
runs data parallel over ``gcd(batch_size, N)`` ranks
(scripts/train_downstream.py:249-274; the other ranks sit out): ``--batch_size``
is the global batch, each rank reads its rows of the global stream
(``data.loader.RowShard``; the synthetic stream's rows), matches its own
rows and draws the points of its rows, the criterion's normalisers and the
gradients are summed over the ranks (train/downstream.py), the eval's dice
is averaged and its confusion matrix summed over them, so every rank steps
the same learning rate. Rank 0 prints and writes the checkpoints.
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
from ..data.loader import DeviceLoader, RowShard
from ..data.synthetic import synthetic_instances
from ..eval.metrics import ConfMatrix
from ..losses.set_criterion import targets_from_semantic_labels
from ..models.maskformer import MaskFormerConfig, build_maskformer
from ..parallel import dist as pdist
from ..parallel.mesh import downstream_layout
from ..train import downstream as ds
from ..utils import checkpoint as ckpt_lib

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
    p.add_argument("--backbone", default="vit",
                   choices=["vit", "vit_adapter", "swin", "resnet18", "resnet34", "resnet50", "resnet101",
                            "resnet152"])
    p.add_argument("--fusion_mode", default="crossattn", choices=["crossattn", "sup"])
    p.add_argument("--coco_root", default="")
    p.add_argument("--coco_json", default="")
    p.add_argument("--quad_root", default="")
    p.add_argument("--ade_root", default="", help="root dir the odgt fpath_img/fpath_segm are relative to")
    p.add_argument("--odgt", default="", help="ADE20k-style odgt json-lines list (main_seg.py:64-92)")
    p.add_argument("--segm_downsampling_rate", type=int, default=1)
    p.add_argument("--aug", action="store_true",
                   help="train-time geometric augmentation (rotate/scale/translate/shear/flip)")
    return p.parse_args(argv)


def build_config(args) -> MaskFormerConfig:
    """The model of scripts/train_downstream.py:111-127: the size's widths,
    one fusion token a patch."""
    m = MODEL_SIZES[args.model_size]
    # the ADE20k odgt path is RGB-only (main_seg.py:64-92): one 's2' domain
    extra = {"in_domains": ("s2",)} if args.odgt else {}
    return MaskFormerConfig(
        image_size=args.input_size, num_classes=args.num_classes, dim_tokens=m.dim_tokens, depth=m.depth,
        dim_head=m.dim_head, heads=m.heads, num_fusion_tokens=(args.input_size // 16) ** 2,
        num_queries=args.num_queries, dec_layers=args.dec_layers, frozen_stages=args.frozen_stages,
        backbone_type=args.backbone, fusion_mode=args.fusion_mode, **extra)


def open_data(args, device, layout=None):
    """The training batches of scripts/train_downstream.py:133-215, as
    (iterator of (batch, targets), its DeviceLoader or None, dense_masks):
    the readers' on ``device`` through pinned buffers, the synthetic
    stream's numpy; under data parallelism this rank's rows of each."""
    index, count = (0, 1) if layout is None else (layout.dp_rank, layout.dp)

    def shard(source):
        return source if count == 1 else RowShard(source, index, count)

    if args.task == "instance" and args.coco_root:
        from ..data.coco_instance import CocoBatches, CocoInstanceDataset, split_targets

        source = CocoBatches(CocoInstanceDataset(args.coco_root, args.coco_json, args.input_size), args.batch_size,
                             seed=args.seed, augment=_augment_config(args))
        loader = DeviceLoader(shard(source), device)
        return (split_targets(b) for b in loader), loader, False
    if args.task == "semantic" and args.odgt:
        from ..data.ade_odgt import ADEBatches, ADEOdgtDataset

        ds = ADEOdgtDataset(args.odgt, root=args.ade_root, img_size=args.input_size,
                            segm_downsampling_rate=args.segm_downsampling_rate, flip=args.aug, seed=args.seed)
        loader = DeviceLoader(shard(ADEBatches(ds, args.batch_size, seed=args.seed)), device)
        # criterion_seg.py:169-204: dense masks
        return (({"s2": b["image"]}, targets_from_semantic_labels(b["label"], args.num_classes))
                for b in loader), loader, True
    if args.task == "semantic" and args.quad_root:
        from ..data.quadruplet import QuadrupletBatches, QuadrupletDataset

        ds = QuadrupletDataset(args.quad_root, unlabeled=False, crop_size=args.input_size)
        loader = DeviceLoader(shard(QuadrupletBatches(ds, args.batch_size, seed=args.seed,
                                                      augment=_augment_config(args))), device)
        return (({k: b[k] for k in ("s1", "s2", "dem")}, targets_from_semantic_labels(b["label"], args.num_classes))
                for b in loader), loader, True
    rng = np.random.default_rng(args.seed)
    rows = slice(index * args.batch_size // count, (index + 1) * args.batch_size // count)

    def synthetic():
        while True:
            batch, targets = synthetic_instances(rng, args.batch_size, args.input_size, args.num_classes)
            yield {k: v[rows] for k, v in batch.items()}, type(targets)(*(t[rows] for t in targets))

    return synthetic(), None, False


def _augment_config(args):
    if not args.aug:
        return None
    from ..data.augment import AugmentConfig

    return AugmentConfig()


def main(argv=None) -> int:
    args = get_args(argv)
    cfg = build_config(args)
    layout = None
    if pdist.init_distributed_mode(args.device):
        layout = downstream_layout(args.batch_size)
    try:
        if layout is not None and layout.dp_rank < 0:
            print(f"rank {pdist.get_rank()}: outside the data mesh of {layout.dp} ranks "
                  f"(gcd of the batch {args.batch_size} and the world {pdist.get_world_size()})")
            return 0
        device = args.device if layout is None or layout.backend != "nccl" else f"cuda:{torch.cuda.current_device()}"
        model = build_maskformer(cfg, device=device, generator=torch.Generator().manual_seed(args.seed))
        data, loader, dense_masks = open_data(args, next(model.parameters()).device, layout)
        try:
            return train(args, cfg, model, data, dense_masks, layout)
        finally:
            if loader is not None:
                loader.close()
    finally:
        pdist.destroy()


def _rank_sum(a: np.ndarray, layout) -> np.ndarray:
    """An array summed over the data ranks (itself on one device)."""
    if layout is None:
        return a
    t = torch.from_numpy(np.asarray(a, np.float64)).to("cuda" if layout.backend == "nccl" else "cpu")
    torch.distributed.all_reduce(t, group=layout.data_group)
    return t.cpu().numpy()


def train(args, cfg: MaskFormerConfig, model, data, dense_masks: bool, layout=None) -> int:
    """The epoch loop of scripts/train_downstream.py:264-309; returns the
    exit code."""
    device = next(model.parameters()).device
    print = pdist.print_main
    # the JAX script initialises its parameters on the first batch, so its
    # training stream starts at the second
    next(data)
    print(f"params: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M  queries={cfg.num_queries}")
    if layout is not None:
        print(f"data parallel over {layout.dp} ranks ({layout.backend}), {args.batch_size // layout.dp} rows each")

    if args.pretrained:
        step_n = ckpt_lib.latest_step(args.pretrained)
        if step_n is not None:
            report = ds.load_pretrained_backbone(model, ckpt_lib.load_model_state(args.pretrained, step_n))
            print(f"restored {len(report['copied'])} backbone tensors from {args.pretrained} step {step_n}")

    optimizer = ds.create_downstream_optimizer(model, lr=args.lr, clip_grad=args.clip_grad,
                                               frozen_stages=args.frozen_stages, layout=layout)
    state = ds.DownstreamState(model, optimizer, torch.Generator().manual_seed(args.seed))
    # padded instances (COCO, synthetic) take point-sampled mask losses, the
    # semantic flows dense ones (scripts/train_downstream.py:132, :157, :177)
    step_fn = ds.make_downstream_train_step(model, cfg, optimizer, num_points=args.num_points,
                                            dense_masks=dense_masks, compute_dtype=args.compute_dtype,
                                            match_mode=args.match_mode, per_sample_masks=args.per_sample_masks,
                                            layout=layout)
    eval_fn = ds.make_eval_step(model, cfg)
    sem_pred_fn = ds.make_semantic_pred_step(model, cfg,
                                             out_size=args.input_size // max(args.segm_downsampling_rate, 1))
    sched = ds.ReduceLROnPlateau(lr=args.lr, mode="max")  # maximize dice
    os.makedirs(args.output_dir, exist_ok=True)
    step_ms, wait_ms = [], []
    t0 = time.time()
    for epoch in range(args.epochs):
        agg = {}
        for _ in range(args.steps_per_epoch):
            t_wait = time.perf_counter()
            batch, targets = next(data)
            t_step = time.perf_counter()
            wait_ms.append((t_step - t_wait) * 1e3)
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
            # a rank's mean dice over its rows; the global batch's over the ranks' equal shares
            dice = float(_rank_sum(np.array([float(eval_fn(None, eval_batch, gt))]), layout)[0]) / \
                (1 if layout is None else layout.dp)
            score = dice
            if args.task == "semantic":
                # ConfMatrix AA / mIoU eval (maskformer_train_seg.py:242-285)
                cm = ConfMatrix(args.num_classes + 1)
                cm.add_batch(gt, sem_pred_fn(None, eval_batch))
                cm.state = _rank_sum(cm.state, layout)  # the global batch's matrix
                score = cm.get_miou()
                print(f"  eval AA={cm.get_aa():.4f} mIoU={score:.4f}", flush=True)
            new_lr = sched.step(score)
            ds.set_learning_rate(optimizer, new_lr)
            print(f"  eval dice={dice:.4f} lr -> {new_lr:.2e}", flush=True)
        if (epoch + 1) % args.save_freq == 0 or epoch + 1 == args.epochs:
            ckpt_lib.save_checkpoint(args.output_dir, epoch + 1, state)
    print(f"done: {len(step_ms)} steps, step wall p50 {statistics.median(step_ms):.6g} ms, batch wait p50 "
          f"{statistics.median(wait_ms):.6g} ms" if step_ms else "done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
