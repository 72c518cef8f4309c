"""Export the MultiMAE serving forward as one artifact (the JAX package's
scripts/export_serving.py): the weights baked in, reloaded on the serving
host by ``serving.load_exported`` with no model code and no checkpoint.

    python -m incomplete_multimodal_fusion_tpu_torch.cli.export_serving CKPT_DIR model.pt2 \\
        [--in_domains s1-s2-dem] [--model_size tiny] [--batch 1] [--input_size 256] \\
        [--patch_size 16] [--device cuda|cpu]

Restores the latest checkpoint in CKPT_DIR (``cli.pretrain`` or
``cli.convert_checkpoint`` output) with ``utils.checkpoint.restore_params``
and exports ``serving.export_infer`` at a static batch and input size on
``--device`` (the card unless ``--device cpu``; the artifact runs where it
was exported). The flat signature is (x_<d0>..x_<dk>, mask_<d0>..mask_<dk>)
with f32 rasters [B, S, S, C] and int32 masks [B, num_patches] (1 = drop that
patch), the incomplete-fusion contract (multimae_crossattn.py:395-399). The
model runs in f32, as the JAX script applies its f32 parameters (on the
card: the f32 instances of K1-K3). ``--fusion_mode`` takes every ported mode
(``crossattn``, ``zorro``, ``lstm``, ``crossattn_v1``) and
``--decoder_style`` the decoder the checkpoint was trained with; a semseg
domain's argument is an int32 class map [B, S, S].
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from .. import serving
from ..config import MODEL_SIZES, DataConfig, DecoderConfig, PretrainConfig
from ..models.multimae import build_multimae
from ..utils import checkpoint as ckpt_lib


def get_args(argv=None):
    p = argparse.ArgumentParser("Export the MultiMAE serving forward (PyTorch / CUDA port)")
    p.add_argument("checkpoint_dir", help="checkpoint directory (cli.pretrain or cli.convert_checkpoint output)")
    p.add_argument("output", help="artifact path, e.g. model.pt2")
    p.add_argument("--in_domains", default="s1-s2-dem")
    p.add_argument("--model_size", default="tiny", choices=["tiny", "base", "large"])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--input_size", type=int, default=256)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--fusion_mode", default="crossattn", choices=["crossattn", "zorro", "lstm", "crossattn_v1"])
    p.add_argument("--decoder_style", default="simple", choices=["simple", "full"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = get_args(argv)
    domains = tuple(args.in_domains.split("-"))
    model_cfg = dataclasses.replace(MODEL_SIZES[args.model_size], fusion_mode=args.fusion_mode,
                                    num_fusion_tokens=(args.input_size // args.patch_size) ** 2)
    cfg = PretrainConfig(model=model_cfg, data=dataclasses.replace(
        DataConfig(), in_domains=domains, out_domains=domains, input_size=args.input_size,
        patch_size=args.patch_size), decoder=DecoderConfig(style=args.decoder_style))
    model = build_multimae(cfg, device=args.device)
    ckpt_lib.restore_params(args.checkpoint_dir, model)
    blob = serving.export_infer(model.eval(), None, batch=args.batch, image_size=args.input_size)
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"exported {len(blob) / 1e6:.2f} MB serving artifact -> {args.output} (batch={args.batch}, "
          f"{args.input_size}^2, domains={'-'.join(domains)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
