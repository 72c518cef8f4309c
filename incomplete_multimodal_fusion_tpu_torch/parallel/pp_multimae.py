"""Pipeline parallelism over the MultiMAE trunk (JAX package
parallel/pp_multimae.py).

The trunk is the stack of (FusionBlockFast, EncoderBlock) pairs over the
packed [B, E+F, D] stream; both halves are shape-preserving and the
per-example context they need (``slot``, ``use``, K1's ``types``, the mask
embedding) is layer-constant: what ``pipeline.pipeline_apply`` pipelines.
``make_pp_trunk`` builds the ``trunk_fn`` that ``MultiMAE.forward`` takes
in place of its layer loop; ``train.pretrain.make_train_step`` passes it
through the loss, so the whole step (masks, adapters, pipelined trunk,
decoders, losses, AdamW) runs pipelined. Each stage runs its own layers
with the parameters the step differentiates (``functional_call``'s cast
copies), so the gradients reach the masters of its layers alone.

Constraints (as JAX's): ``fusion_mode='crossattn'``, depth divisible by
the stage count, ``drop_path_rate == 0``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .pipeline import pipeline_apply, stage_layers


def trunk_owner(name: str, depth: int, stages: int) -> Optional[int]:
    """The stage holding parameter ``name`` of the model's trunk
    (``blocks.{i}.`` / ``fus_blocks.{i}.``); None for the parameters every
    stage holds (adapters, tokens, decoders, pools)."""
    head, _, rest = name.partition(".")
    if head not in ("blocks", "fus_blocks"):
        return None
    return int(rest.split(".")[0]) // (depth // stages)


def make_pp_trunk(model, layout, microbatches: int = 0):
    """trunk_fn(tokens, aux) running ``model``'s crossattn layer pairs
    GPipe-pipelined over ``layout.stage_group`` (M = ``microbatches``, or
    the layout's, default one a stage)."""
    if model.fusion_mode != "crossattn":
        raise ValueError("pp trunk supports fusion_mode='crossattn' only")
    if any(blk.dp1.rate != 0.0 for blk in model.blocks):
        raise ValueError("pp trunk requires drop_path_rate == 0")
    depth = len(model.blocks)
    layers = stage_layers(depth, layout.pp, layout.pp_rank)
    use_kernel = model.attn_impl != "xla"
    fusion_type = model.fusion_type

    def stage_fn(tokens: torch.Tensor, aux: Dict[str, torch.Tensor]) -> torch.Tensor:
        e = tokens.shape[1] - model.num_fusion_tokens
        for i in layers:
            fusion_new = model.fus_blocks[i](tokens[:, :e], tokens[:, e:], aux["mask_emb"], aux["slot"], aux["use"],
                                             use_kernel=use_kernel)
            tokens = torch.cat([tokens[:, :e], fusion_new], dim=1)
            tokens = model.blocks[i](tokens, aux["types"], fusion_type, use_kernel=use_kernel)
        return tokens

    def trunk_fn(tokens: torch.Tensor, aux: Dict[str, torch.Tensor]) -> torch.Tensor:
        return pipeline_apply(stage_fn, tokens, aux, layout.stage_group, microbatches or layout.microbatches)

    return trunk_fn
