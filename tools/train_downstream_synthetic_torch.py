"""End-to-end downstream training of the PyTorch port on synthetic
COCO-style data, scored by the port's own evaluation stack: the port's
counterpart of tools/train_downstream_synthetic.py, with the same flags,
defaults, samples and JSON keys.

Task: each image carries 1-3 bright rectangles (visible in every modality);
instances = those rectangles, single class. Trains the full MaskFormer
(MaskFormerConfig(frozen_stages=...): the incomplete-fusion ViT backbone,
the MSDA pixel decoder, the Mask2Former decoder, the set criterion with
on-device auction matching) with the reference recipe (loss 0.3 ce + 0.3
dice + 0.4 mask, AdamW, full-model clip) on a pool of 8 batches, then scores
held-out images through infer_segmentation.forward_instance_segmentation and
eval.coco_eval.CocoMaskEvaluator (mAP / AP50 / AP75, detections scored above
0.5) and a binary foreground IoU. Runs on the card unless --cpu.

Usage:
    python tools/train_downstream_synthetic_torch.py --steps 400 --frozen_stages 11 \\
        --out DOWNSTREAM_E2E_TORCH.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from incomplete_multimodal_fusion_tpu_torch.eval.coco_eval import CocoMaskEvaluator  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.infer_segmentation import forward_instance_segmentation  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.losses.set_criterion import SegTargets  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.models.maskformer import MaskFormerConfig, build_maskformer  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.train import downstream as ds  # noqa: E402

DOMAINS = ("s1", "s2", "dem")
CHANNELS = {"s1": 1, "s2": 3, "dem": 1}
IMG = 256
MAX_INST = 8
TAIL = 25  # the steps whose mean loss the summary line gives


def make_sample(rng: np.random.Generator):
    """One image: background noise + K bright rectangles (all modalities)."""
    k = int(rng.integers(1, 4))
    x = {d: 0.3 * rng.standard_normal((IMG, IMG, CHANNELS[d])).astype(np.float32)
         for d in DOMAINS}
    masks = np.zeros((MAX_INST, IMG, IMG), np.float32)
    for i in range(k):
        h = int(rng.integers(40, 100))
        w = int(rng.integers(40, 100))
        r = int(rng.integers(0, IMG - h))
        c = int(rng.integers(0, IMG - w))
        masks[i, r: r + h, c: c + w] = 1.0
        for d in DOMAINS:
            x[d][r: r + h, c: c + w, :] += 2.0
    labels = np.full(MAX_INST, -1, np.int32)
    labels[:k] = 0
    valid = np.zeros(MAX_INST, bool)
    valid[:k] = True
    return x, masks, labels, valid


def make_batch(rng: np.random.Generator, b: int):
    xs, ms, ls, vs = [], [], [], []
    for _ in range(b):
        x, m, l, v = make_sample(rng)
        xs.append(x)
        ms.append(m)
        ls.append(l)
        vs.append(v)
    batch = {d: np.stack([s[d] for s in xs]) for d in DOMAINS}
    return batch, np.stack(ms), np.stack(ls), np.stack(vs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--clip", type=float, default=0.01)
    ap.add_argument("--eval_images", type=int, default=16)
    ap.add_argument("--frozen_stages", type=int, default=0,
                    help="0 = train everything from scratch; 11 = the reference recipe (frozen encoder, "
                         "trainable pyramid/head)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")

    cfg = MaskFormerConfig(frozen_stages=args.frozen_stages)
    model = build_maskformer(cfg, device=device)
    rng = np.random.default_rng(20260817)

    # fixed pool of training batches (the model must fit the task, not
    # memorize one array: rectangles differ across the pool)
    pool = []
    for batch_np, masks, labels, valid in (make_batch(rng, args.batch) for _ in range(8)):
        pool.append(({d: torch.from_numpy(batch_np[d]).to(device) for d in DOMAINS},
                     ds.as_targets(SegTargets(labels, masks, valid), device)))

    optimizer = ds.create_downstream_optimizer(model, lr=args.lr, clip_grad=args.clip,
                                               frozen_stages=args.frozen_stages)
    state = ds.DownstreamState(model, optimizer, torch.Generator().manual_seed(1))
    step = ds.make_downstream_train_step(model, cfg, optimizer, match_mode="auction")

    step_losses = []  # every step's loss, on the device until the end
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch, targets = pool[i % len(pool)]
        state, m = step(state, batch, targets)
        step_losses.append(m["loss"])
        if i % 25 == 0 or i == args.steps - 1:
            loss = float(m["loss"])
            losses.append((i, loss))
            print(f"step {i}: loss {loss:.4f} ({time.time() - t0:.0f}s)", flush=True)
            assert np.isfinite(loss), "non-finite loss"
    train_s = time.time() - t0
    tail = torch.stack(step_losses[-TAIL:]).mean().item()
    print(f"last {min(TAIL, args.steps)} steps: mean loss {tail:.6g}; first step's loss {losses[0][1]:.6g}; "
          f"training {train_s:.1f} s", flush=True)

    # ---- eval on held-out images
    evaluator = CocoMaskEvaluator(num_classes=1, iou_type="segm")
    inter = union = 0.0
    n_eval_batches = max(1, args.eval_images // args.batch)
    for _ in range(n_eval_batches):
        ebatch, emasks, elabels, evalid = make_batch(rng, args.batch)
        results = forward_instance_segmentation(model, None, ebatch)
        for bi, res in enumerate(results):
            scores = res["scores"].cpu().numpy()
            keep = scores > 0.5
            pm = res["pred_masks"].cpu().numpy()[keep]
            pc = res["pred_classes"].cpu().numpy()[keep]
            ps = scores[keep]
            gm = emasks[bi][evalid[bi]]
            gc = elabels[bi][evalid[bi]]
            evaluator.add_image(pm, pc, ps, gm, gc)
            pred_fg = pm.astype(bool).any(0) if len(pm) else np.zeros((IMG, IMG), bool)
            gt_fg = gm.astype(bool).any(0)
            inter += float((pred_fg & gt_fg).sum())
            union += float((pred_fg | gt_fg).sum())

    stats = evaluator.summarize()
    iou = inter / max(union, 1.0)
    result = {
        "steps": args.steps,
        "batch": args.batch,
        "lr": args.lr,
        "clip": args.clip,
        "frozen_stages": args.frozen_stages,
        "loss_curve": losses,
        "loss_first": losses[0][1],
        "loss_last": losses[-1][1],
        "mAP": stats.get("AP"),
        "AP50": stats.get("AP50"),
        "AP75": stats.get("AP75"),
        "binary_foreground_iou": iou,
        "wall_s": round(time.time() - t0, 1),
        "backend": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")


if __name__ == "__main__":
    main()
