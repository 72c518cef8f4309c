"""Checkpoints of the training states (JAX package utils/checkpoint.py:15-97;
reference pretraining/utils/checkpoint.py: ``torch.save`` of model,
optimizer and epoch, auto-resume from the latest ``checkpoint-*``).

The format is the port's own: one ``torch.save`` file,
``directory/checkpoint-{step}``, each tensor on the CPU, holding
  * for the pretraining ``TrainState``: the f32 masters, FlatAdamW's count
    and moments, the balancer's log-variances and its optimizer's, the EMA,
    the step and the mask generator's state;
  * for the downstream ``DownstreamState``: the f32 masters, the optimizer
    (its moments, step counts and current lr), the step and the generator's
    state;
  * for converted weights (``save_params``): the step label and the model's
    state dict alone.
Each names its kind under ``kind`` ('pretraining', 'downstream', 'params'),
and a state restores only from its own. Every kind keeps the model's state
dict under ``model``, so ``restore_params``
and ``load_model_state`` read all three. A restore copies every tensor into
the state in place, so a step captured in a CUDA graph keeps running on the
restored values.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from ..parallel.dist import is_main_process

PREFIX = "checkpoint-"


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def core_payload(state, kind: str) -> Dict:
    """What every training state's checkpoint holds: its kind, the step, the
    model's state dict, the optimizer's state and the generator's. Each
    state type adds its own parts (``checkpoint_payload``)."""
    return {
        "kind": kind,
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
    }


def restore_core(state, saved: Dict, kind: str) -> None:
    """Puts ``core_payload``'s parts of ``saved`` back into ``state`` in
    place; raises when the checkpoint is of another kind."""
    saved_kind = saved.get("kind", "pretraining")  # checkpoints without a kind are all pretraining ones
    if saved_kind != kind:
        raise ValueError(f"restore_checkpoint: a {saved_kind} checkpoint does not restore a {kind} state")
    copy_into(state.model.state_dict(), saved["model"], "the model")
    state.optimizer.load_state_dict(saved["optimizer"])
    state.generator.set_state(saved["generator"])
    state.step = saved["step"]


def state_payload(state) -> Dict:
    """The checkpoint's content for a training state (train/pretrain.py's
    ``TrainState``, train/downstream.py's ``DownstreamState``), on the CPU."""
    return _host(state.checkpoint_payload())


def _write(directory: str, step: int, payload: Dict) -> str:
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{PREFIX}{step}")
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(directory: str, step: int, state) -> str:
    """Writes ``directory/checkpoint-{step}`` (through a temporary file, so a
    reader never sees half a checkpoint) and returns its path. Under parallel
    training every rank calls it (the payload is gathered into the
    one-device layout) and rank 0 writes."""
    payload = state_payload(state)
    path = os.path.join(os.path.abspath(directory), f"{PREFIX}{step}")
    return _write(directory, step, payload) if is_main_process() else path


def save_params(directory: str, step: int, state_dict: Dict[str, torch.Tensor]) -> str:
    """Writes a weights-only checkpoint (converted reference weights) as
    ``directory/checkpoint-{step}``, the same way; returns its path."""
    return _write(directory, step, _host({"kind": "params", "step": int(step), "model": dict(state_dict)}))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith(PREFIX):
            try:
                steps.append(int(name[len(PREFIX):]))
            except ValueError:
                pass
    return max(steps) if steps else None


def _load(directory: str, step: Optional[int]):
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None
    return torch.load(os.path.join(directory, f"{PREFIX}{step}"), map_location="cpu", weights_only=True)


def copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], what: str) -> None:
    if set(dst) != set(src):
        raise KeyError(f"restore_checkpoint: {what} holds {sorted(set(src) ^ set(dst))} on one side only")
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(src[k])


def restore_checkpoint(directory: str, state, step: Optional[int] = None):
    """Restores the checkpoint of ``step`` (the latest when None) into
    ``state`` (a pretraining or downstream state, through its
    ``restore_payload``) in place and returns it; returns ``state`` unchanged
    when the directory holds none (the auto-resume of reference
    checkpoint.py:103-134)."""
    saved = _load(directory, step)
    if saved is not None:
        state.restore_payload(saved)
    return state


def load_model_state(directory: str, step: Optional[int] = None) -> Optional[Dict[str, torch.Tensor]]:
    """The model's state dict (on the CPU) of the checkpoint of ``step`` (the
    latest when None), whatever its kind; None when there is none."""
    saved = _load(directory, step)
    return None if saved is None else saved["model"]


def restore_params(directory: str, model: torch.nn.Module, step: Optional[int] = None) -> torch.nn.Module:
    """Loads the saved parameters alone into ``model`` where name and shape
    match, whatever the checkpoint's kind (the lenient load of reference
    checkpoint.py:26-72); reports the parameters left at their values.
    Returns ``model`` (unchanged when there is no checkpoint)."""
    source = load_model_state(directory, step)
    if source is None:
        return model
    unmatched = []
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name in source and tuple(source[name].shape) == tuple(t.shape):
                t.copy_(source[name])
            else:
                unmatched.append(name)
    if unmatched:
        print(f"restore_params: {len(unmatched)} tensor(s) not found in the checkpoint (left as they were): "
              f"{', '.join(unmatched[:8])}{' ...' if len(unmatched) > 8 else ''}")
    return model
