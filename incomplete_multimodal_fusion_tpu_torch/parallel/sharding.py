"""Tensor parallelism on local shards (JAX package parallel/sharding.py:
``param_spec``'s column- and row-parallel kernels, Megatron-style).

``shard_model_(model, layout)`` cuts a full model (the one-device model,
built from the same seed or carried from JAX by ``params_from_jax``) into
this rank's shard of the ``model`` axis, in place, and marks each sharded
module with the links of parallel/comm.py it runs through:

  * attention (the encoder's ``ZorroAttention`` self-attention, each
    ``FusionBlockFast``, the decoders' ``ViTSelfAttention``) by heads: a
    rank's heads come from each of the q, k and v row blocks;
  * the feed-forwards (``GEGLUFeedForward``, the decoders' ``Mlp``) by
    hidden units: a rank takes the same rows of GEGLU's value and gate
    halves;
  * the input projections column-parallel (``copy``: identity forward,
    all-reduce backward), the output projections row-parallel
    (``reduce``: all-reduce forward, identity backward); a row-parallel
    bias is added once, after the all-reduce; K2's fused LayerNorm weight
    enters through ``copy`` (each rank's kernel gives its hidden units'
    part of its gradient).

A module whose heads or hidden units do not divide tp stays replicated, as
``param_spec`` leaves a kernel that does not divide (``tiny``'s 3 heads at
tp = 2); so does a block on the fused half-block route (one kernel over
all heads). The kernels always get plain local tensors.

With sequence parallelism (``layout.sp``) the encoder block's residual
stream is token-sharded between its attention and its feed-forward and at
its output (``EncoderBlock.sp``): the attention's output is reduce-scattered
onto the stream's token shards (``scatter``), the feed-forward's LayerNorm
runs on the shard (its weight through ``copy``), its input is all-gathered
(``gather``) and its output reduce-scattered; a replicated module ``split``s
its output and ``unsplit``s its input instead. The model all-gathers the
block's output (``unsplit``) for the next fusion block.

``shard_model_`` returns every sharded parameter's cut: (dim, parts), the
tensor along ``dim`` being ``parts`` equal blocks (q / k / v, value / gate)
each cut into tp pieces; ``shard_tensor`` and ``gather_tensor`` move a
tensor between the full and the local layouts (parallel/state.py:
checkpoints, the optimizer's moments).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .comm import collective

Spec = Tuple[int, int]  # (dim, parts)


@dataclass(frozen=True)
class TPLink:
    """How a sharded (or, under sequence parallelism, a replicated) module
    talks to its model group: ``enter`` on its input, ``leave`` on its
    output (ops of comm.collective, None for none)."""

    group: dist.ProcessGroup
    enter: Optional[str] = "copy"
    leave: Optional[str] = "reduce"
    sharded: bool = True  # the module holds a cut of its weights

    def into(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.enter is None else collective(x, self.enter, self.group)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.leave is None else collective(y, self.leave, self.group)

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A replicated weight whose gradient each rank computes in part."""
        return collective(w, "copy", self.group, dim=0)


ATTENTION_SPECS: Dict[str, Spec] = {"to_q.weight": (0, 1), "to_kv.weight": (0, 2), "to_out.weight": (1, 1)}


def _module_specs(module: nn.Module, tp: int) -> Optional[Dict[str, Spec]]:
    """The cut of a module that shards, or None where it stays replicated."""
    from ..models.layers import FusionBlockFast, GEGLUFeedForward, Mlp, ViTSelfAttention, ZorroAttention

    if isinstance(module, (ZorroAttention, FusionBlockFast)):
        return ATTENTION_SPECS if module.heads % tp == 0 else None
    if isinstance(module, GEGLUFeedForward):
        return {"proj_in.weight": (0, 2), "proj_out.weight": (1, 1)} if module.proj_out.weight.shape[1] % tp == 0 \
            else None
    if isinstance(module, ViTSelfAttention):
        if module.num_heads % tp:
            return None
        specs = {"qkv.weight": (0, 3), "proj.weight": (1, 1)}
        if module.qkv.bias is not None:
            specs["qkv.bias"] = (0, 3)
        return specs
    if isinstance(module, Mlp):
        return {"fc1.weight": (0, 1), "fc1.bias": (0, 1), "fc2.weight": (1, 1)} \
            if module.fc1.weight.shape[0] % tp == 0 else None
    return None


def _targets(model: nn.Module):
    """(name, module) of every module tensor parallelism may cut: the
    encoder blocks' self-attention and feed-forward, the fusion blocks and
    their feed-forwards, the decoders' self-attention and MLPs. The pools
    and cross-attentions stay replicated."""
    from ..models.layers import EncoderBlock, FusionBlockFast, ViTBlock, ViTDecoderBlock

    for name, module in model.named_modules():
        if isinstance(module, EncoderBlock):
            if not module.fused_block:
                yield f"{name}.attn", module.attn
            yield f"{name}.mlp", module.mlp
        elif isinstance(module, FusionBlockFast):
            yield name, module
            yield f"{name}.mlp", module.mlp
        elif isinstance(module, ViTBlock):
            yield f"{name}.attn", module.attn
            yield f"{name}.mlp", module.mlp
        elif isinstance(module, ViTDecoderBlock):
            yield f"{name}.self_attn", module.self_attn
            yield f"{name}.mlp", module.mlp


def shard_tensor(t: torch.Tensor, spec: Spec, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s piece of a full tensor: each of the ``parts`` blocks
    along ``dim`` cut into ``tp`` and this rank's pieces concatenated."""
    dim, parts = spec
    blocks = t.chunk(parts, dim=dim)
    return torch.cat([b.chunk(tp, dim=dim)[rank] for b in blocks], dim=dim).contiguous()


def gather_tensor(local: torch.Tensor, spec: Spec, group) -> torch.Tensor:
    """The full tensor from every rank's ``shard_tensor`` piece."""
    dim, parts = spec
    tp = dist.get_world_size(group)
    pieces = [torch.empty_like(local) for _ in range(tp)]
    dist.all_gather(pieces, local.contiguous(), group=group)
    per_rank = [p.chunk(parts, dim=dim) for p in pieces]
    return torch.cat([per_rank[r][j] for j in range(parts) for r in range(tp)], dim=dim)


def shard_model_(model: nn.Module, layout, stream_tokens: int = 0) -> Dict[str, Spec]:
    """Cuts ``model`` (full) into this rank's tensor-parallel shard in place
    and links its modules (module docstring); returns {parameter name:
    (dim, parts)} of every parameter that was cut. A no-op
    returning {} without tensor parallelism. Sequence parallelism needs the
    encoder stream's length ``stream_tokens`` to divide tp; where it does
    not, it is left off, as JAX's ``sp_shard`` leaves such a stream whole."""
    from ..models.layers import EncoderBlock, GEGLUFeedForward, Mlp

    if not layout.tensor_parallel:
        return {}
    tp, rank, group = layout.tp, layout.tp_rank, layout.model_group
    sp = layout.sequence_parallel and stream_tokens % tp == 0
    encoder = {f"{n}.{part}" for n, m in model.named_modules() if isinstance(m, EncoderBlock)
               for part in ("attn", "mlp")}
    specs: Dict[str, Spec] = {}
    for name, module in list(_targets(model)):
        cut = _module_specs(module, tp)
        in_block = name in encoder
        is_ffn = isinstance(module, (GEGLUFeedForward, Mlp))
        if cut is None:
            if sp and in_block:  # replicated, but on the sharded stream
                module.tp = TPLink(group, "unsplit" if is_ffn else None, "split", sharded=False)
            continue
        with torch.no_grad():
            for pname, spec in cut.items():
                owner_name, _, attr = pname.rpartition(".")
                owner = module.get_submodule(owner_name)
                full = getattr(owner, attr)
                setattr(owner, attr, nn.Parameter(shard_tensor(full.detach(), spec, tp, rank),
                                                  requires_grad=full.requires_grad))
                specs[f"{name}.{pname}"] = spec
        if hasattr(module, "heads"):
            module.heads //= tp
        if hasattr(module, "num_heads"):
            module.num_heads //= tp
        enter, leave = ("gather" if is_ffn else "copy", "scatter") if (sp and in_block) else ("copy", "reduce")
        module.tp = TPLink(group, enter, leave)
    if sp:
        for module in model.modules():
            if isinstance(module, EncoderBlock):
                module.sp = group
                module.norm2.tp = TPLink(group)
    return specs


def norm_weights(named_params, specs: Mapping[str, Spec], layout) -> Dict[str, float]:
    """FlatAdamW's ``norm_weights`` under tensor parallelism: 1 for a cut
    parameter, 1 / tp for one every model rank holds whole."""
    return {name: 1.0 if name in specs else 1.0 / layout.tp for name, _ in named_params}
