"""MAE reconstruction inference CLI of the port (the JAX package's
scripts/infer.py on one device; reference pretraining/infer_mmae.py:291-362).

    python -m incomplete_multimodal_fusion_tpu_torch.cli.infer \\
        [--ckpt_dir DIR] [--num_encoded_tokens E] [--seed S] [--drop dem] [--output grid.png] \\
        [--data_path DIR --tile_index I] [--device cuda|cpu]

Restores the latest checkpoint in ``--ckpt_dir`` (a pretraining checkpoint
of ``cli.pretrain`` or converted weights of ``cli.convert_checkpoint``), or
warns and keeps the seeded initialisation; forwards one tile, the
``--tile_index``-th of the DFC2023 tree ``--data_path`` (read at
``--input_size``) or else a synthetic one from ``--seed``, with random
masks drawn from ``torch.Generator(--seed)`` (or, with ``--drop``, the
named modalities masked out); prints each masked modality's
masked-patch PSNR (a class-map domain such as ``dnw``: the pixel accuracy
of the argmax of its class logits); writes the masked / predicted /
ground-truth grid as PNG (the only format). ``--fusion_mode`` takes
``crossattn``, ``zorro`` and ``lstm``, as the JAX script does. The model
runs in f32, as the JAX script applies its f32 parameters (on the card: the
f32 instances of K1-K3).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from .. import infer as infer_lib
from .. import modalities as modreg
from ..config import MODEL_SIZES, DataConfig, PretrainConfig
from ..data.dfc2023 import DFC2023Dataset
from ..data.synthetic import synthetic_batch
from ..models.multimae import build_multimae
from ..utils import checkpoint as ckpt_lib


def get_args(argv=None):
    p = argparse.ArgumentParser("MultiMAE inference (PyTorch / CUDA port)")
    p.add_argument("--ckpt_dir", default="./save_attention")
    p.add_argument("--model_size", default="tiny", choices=["tiny", "base", "large"])
    p.add_argument("--fusion_mode", default="crossattn", choices=["crossattn", "zorro", "lstm"])
    p.add_argument("--in_domains", default="s1-s2-dem")
    p.add_argument("--input_size", type=int, default=256)
    p.add_argument("--num_encoded_tokens", type=int, default=256)  # infer_mmae.py:330
    p.add_argument("--seed", type=int, default=1)  # torch.manual_seed(1)
    p.add_argument("--drop", default="", help="modalities to ablate, hyphen separated")
    p.add_argument("--data_path", default="", help="DFC2023 tree; synthetic if empty")
    p.add_argument("--tile_index", type=int, default=0)
    p.add_argument("--output", default="output.png", help="the grid, PNG")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = get_args(argv)
    domains = tuple(args.in_domains.split("-"))
    model_cfg = dataclasses.replace(MODEL_SIZES[args.model_size], num_fusion_tokens=(args.input_size // 16) ** 2,
                                    fusion_mode=args.fusion_mode)
    cfg = PretrainConfig(model=model_cfg, data=DataConfig(input_size=args.input_size, in_domains=domains,
                                                          out_domains=domains, batch_size=1))
    model = build_multimae(cfg, device=args.device)
    step = ckpt_lib.latest_step(args.ckpt_dir)
    if step is not None:
        ckpt_lib.restore_params(args.ckpt_dir, model, step)
        print(f"restored params from {args.ckpt_dir} step {step}")
    else:
        print("WARNING: no checkpoint found; using random init")
    model = model.eval()
    device = next(model.parameters()).device

    if args.data_path:
        s = DFC2023Dataset(args.data_path, size=args.input_size)[args.tile_index]
        x = {k: np.ascontiguousarray(v.transpose(1, 2, 0))[None] for k, v in s.items() if k in domains}
    else:
        x = synthetic_batch(np.random.default_rng(args.seed), domains, 1, args.input_size)
    drop = tuple(d for d in args.drop.split("-") if d)
    res = infer_lib.infer(model, None, x, args.num_encoded_tokens, generator=torch.Generator().manual_seed(args.seed),
                          drop_modalities=drop)
    p = cfg.data.patch_size
    for d in domains:
        m = res.task_masks[d]
        masked = int(m[0].sum())
        if int(m.sum()) == 0:
            print(f"{d}: fully visible (no reconstruction target)")
            continue
        if modreg.get(d).adapter == "semseg":
            acc = float(infer_lib.pixel_accuracy(res.preds[d], torch.from_numpy(x[d])))
            print(f"{d}: class-map pixel accuracy {acc:.6f} ({masked}/{m.shape[1]} patches masked)")
            continue
        psnr = float(infer_lib.masked_psnr(res.preds[d], torch.from_numpy(x[d]).to(device), m, p))
        print(f"{d}: masked-patch PSNR {psnr:.6f} dB ({masked}/{m.shape[1]} patches masked)")
    print(f"wrote {infer_lib.plot_reconstructions(x, res, p, args.output)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
