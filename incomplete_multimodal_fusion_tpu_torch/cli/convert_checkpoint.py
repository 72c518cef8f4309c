"""Convert a reference PyTorch checkpoint into a port checkpoint (the JAX
package's scripts/convert_checkpoint.py, on the port; reference
utils/checkpoint.py load path and misc.py load_parallal_model's DDP-prefix
stripping).

    python -m incomplete_multimodal_fusion_tpu_torch.cli.convert_checkpoint \\
        mmae_checkpoint.pth ./save_attention --in_domains s1-s2-dem [--arch multimae|maskformer]

Reads the ``.pth`` (a raw state dict or ``{'model': ...}``, ``module.``
prefixes stripped), converts it with ``utils.torch_convert`` and writes
``output_dir/checkpoint-{step}`` holding the port's state dict alone
(``utils.checkpoint.save_params``), which ``restore_params``, ``cli.infer``
and ``cli.train_downstream --pretrained`` read. ``--fusion_mode
crossattn_v1`` converts the 20231203 snapshot (its shared cross-attention
and per-modality pools instead of the fusion blocks).
"""
from __future__ import annotations

import argparse
import sys

import torch

from .. import modalities as modreg
from ..utils import checkpoint as ckpt_lib
from ..utils.torch_convert import convert_maskformer_state, convert_multimae_state


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Convert a reference .pth into a port checkpoint")
    p.add_argument("checkpoint", help=".pth file (raw state dict or {'model': ...})")
    p.add_argument("output_dir", help="checkpoint directory to write")
    p.add_argument("--in_domains", default="s1-s2-dem", help="hyphen separated")
    p.add_argument("--out_domains", default=None, help="default: in_domains")
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--decoder_depth", type=int, default=2)
    p.add_argument("--fusion_mode", default="crossattn", choices=["crossattn", "crossattn_v1"])
    p.add_argument("--arch", default="multimae", choices=["multimae", "maskformer"],
                   help="multimae = pretraining checkpoint; maskformer = downstream (backbone + pixel decoder + "
                        "predictor)")
    p.add_argument("--enc_layers", type=int, default=2)
    p.add_argument("--dec_layers", type=int, default=3)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--step", type=int, default=0, help="step label for the checkpoint")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = get_args(argv)
    raw = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
    state = raw.get("model", raw) if isinstance(raw, dict) else raw
    in_domains = tuple(args.in_domains.split("-"))
    out_domains = tuple((args.out_domains or args.in_domains).split("-"))
    if args.arch == "maskformer":
        params = convert_maskformer_state(state, in_domains, depth=args.depth, enc_layers=args.enc_layers,
                                          dec_layers=args.dec_layers, hidden_dim=args.hidden_dim)
    else:
        # channel counts only matter for the pretraining decoders; resolving
        # them here keeps --arch maskformer usable with unregistered domains
        out_channels = {d: modreg.get(d).num_channels for d in out_domains}
        params = convert_multimae_state(state, in_domains, out_domains, out_channels, patch_size=args.patch_size,
                                        depth=args.depth, decoder_depth=args.decoder_depth,
                                        fusion_mode=args.fusion_mode)
    ckpt_lib.save_params(args.output_dir, args.step, params)
    n = sum(t.numel() for t in params.values())
    print(f"converted {len(state)} torch tensors -> {args.output_dir} (step {args.step}, {n / 1e6:.2f}M params)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
