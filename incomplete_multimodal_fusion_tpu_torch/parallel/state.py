"""A training state between its sharded and its one-device forms.

Checkpoints are written in the one-device format whatever the layout, so a
run resumes at any world size: the parameters, the EMA and FlatAdamW's
moments are gathered into the full model's layout (tensor-parallel cuts
all-gathered over the model group, ZeRO slices over the data group, each
pipeline stage's layers taken from the stage that holds them), and cut
back into a rank's layout on restore. Every function here is a collective
over the groups the layout has; every rank calls it.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist

from .pp_multimae import trunk_owner
from .sharding import gather_tensor, shard_tensor


class StateLayout:
    """What moving a state between layouts needs: the step's ``layout``,
    ``specs`` (parallel.sharding's tensor-parallel cuts) and the trunk
    ``depth`` (the pipeline's owner of each block)."""

    def __init__(self, layout, specs: Mapping[str, Tuple[int, int]], depth: int):
        self.layout, self.specs, self.depth = layout, dict(specs), depth

    def _owner(self, name: str):
        lay = self.layout
        return trunk_owner(name, self.depth, lay.pp) if lay.pipelined else None

    def gather(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{parameter name: tensor} of this rank -> the full layout's."""
        lay = self.layout
        out = {}
        for name, t in tensors.items():
            if name in self.specs:
                t = gather_tensor(t, self.specs[name], lay.model_group)
            owner = self._owner(name)
            if owner is not None:  # the holding stage's value
                t = t.clone() if owner == lay.pp_rank else torch.zeros_like(t)
                dist.all_reduce(t, group=lay.stage_group)
            out[name] = t
        return out

    def shard(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The full layout's {parameter name: tensor} -> this rank's."""
        lay = self.layout
        return {name: shard_tensor(t, self.specs[name], lay.tp, lay.tp_rank) if name in self.specs else t
                for name, t in tensors.items()}

    def gather_flat(self, vec: torch.Tensor, names: Sequence[str], shapes: Sequence[torch.Size]) -> torch.Tensor:
        """A flat vector over this rank's parameters (``names`` with their
        local ``shapes``, in the optimizer's order) -> the full model's."""
        parts = dict(zip(names, (v.view(s) for v, s in zip(vec.split([s.numel() for s in shapes]), shapes))))
        return torch.cat([t.reshape(-1) for t in self.gather(parts).values()])

    def shard_flat(self, vec: torch.Tensor, names: Sequence[str], full_shapes: Sequence[torch.Size]) -> torch.Tensor:
        """The full model's flat vector -> this rank's."""
        parts = dict(zip(names, (v.view(s) for v, s in zip(vec.split([s.numel() for s in full_shapes]),
                                                           full_shapes))))
        return torch.cat([t.reshape(-1) for t in self.shard(parts).values()])

    def full_shapes(self, named: Sequence[Tuple[str, torch.Tensor]]) -> List[torch.Size]:
        """The full model's shape of each (name, local tensor)."""
        tp = self.layout.tp
        out = []
        for name, t in named:
            shape = list(t.shape)
            if name in self.specs:
                shape[self.specs[name][0]] *= tp
            out.append(torch.Size(shape))
        return out
