"""The port's hand-written kernels as ``torch.library`` custom operators.

Every kernel entry of K1 (``zorro_attention``, its separate-q/k/v and
tile-skip modes), K2 (``fused_ffn``, with its task axis), K3
(``fusion_row_attention``) and K6 (``fused_block_attn``), forward and
backward, is one operator of the namespace below, defined by its wrapper
module (ops/cuda_*.py) through :func:`define`. An operator has:

  * a CUDA implementation: the wrapper's launcher, which checks the operands
    (types in range, alignment: checks that read values run here, eagerly),
    launches the kernel, counts the launch, and raises for a dtype it does
    not take;
  * a CPU implementation: the kernel's plain PyTorch version;
  * a fake implementation: outputs of the right shape and dtype, checking
    shapes only, so ``torch.export``, ``torch.compile`` and AOT autograd
    trace through the operator without reading data;
  * for a forward, its backward through ``register_autograd``: the backward
    operator of the same kernel.

A model reaches a kernel only through its operator, so a program exported
with ``torch.export`` holds ``torch.ops.<namespace>.*`` nodes, and a
reloaded program launches (and counts) the kernels exactly as the live
model does. ``Library.define`` / ``impl`` are used rather than
``torch.library.custom_op``, whose Python wrapper adds host work to every
call of an operator that a serving forward calls about 60 times.

Importing the package's ``ops`` registers every operator (ops/__init__.py
imports each wrapper module); a process that loads an exported program
imports it first.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

NAMESPACE = "imf_torch"

_LIB = torch.library.Library(NAMESPACE, "DEF")
_DEFINED: Dict[str, torch._ops.OpOverload] = {}


def define(name: str, schema: str, cpu: Callable, cuda: Callable, fake: Callable,
           backward: Optional[Callable] = None, setup_context: Optional[Callable] = None):
    """Defines the operator ``<namespace>::name`` with ``schema`` (its
    arguments and results, as ``"(Tensor x, int heads) -> Tensor"``), its
    CPU, CUDA and fake implementations, and its backward where given.
    Returns the operator's overload, the handle the wrapper calls."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    qualname = f"{NAMESPACE}::{name}"
    torch.library.register_fake(qualname, _shapes_only(name, fake), lib=_LIB)
    if backward is not None:
        torch.library.register_autograd(qualname, backward, setup_context=setup_context, lib=_LIB)
    op = getattr(getattr(torch.ops, NAMESPACE), name).default
    _DEFINED[name] = op
    return op


def _shapes_only(name: str, fake: Callable) -> Callable:
    """The fake implementation as registered: under a fake mode (tracing)
    the operands are fake tensors of their real device; a tensor of the
    meta device itself has no kernel, so a call on one raises, as on any
    device without a kernel."""
    def run(*args):
        for a in args:
            if isinstance(a, torch.Tensor) and a.device.type == "meta":
                raise ValueError(f"{name}: no kernel for device meta")
        return fake(*args)

    return run


def operators() -> Dict[str, torch._ops.OpOverload]:
    """Every operator defined so far, by name."""
    return dict(_DEFINED)


def is_kernel_op(target) -> bool:
    """Whether a graph node's target is one of these operators."""
    return getattr(target, "namespace", None) == NAMESPACE
