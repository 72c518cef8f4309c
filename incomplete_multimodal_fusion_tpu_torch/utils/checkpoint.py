"""Checkpoints of the pretraining state (JAX package utils/checkpoint.py:15-97;
reference pretraining/utils/checkpoint.py: ``torch.save`` of model,
optimizer and epoch, auto-resume from the latest ``checkpoint-*``).

The format is the port's own: one ``torch.save`` file,
``directory/checkpoint-{step}``, holding the f32 masters, FlatAdamW's count
and moments, the balancer's log-variances and its optimizer's, the EMA, the
step and the mask generator's state, each on the CPU. A restore copies every
tensor into the state in place, so a step captured in a CUDA graph keeps
running on the restored values.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

PREFIX = "checkpoint-"


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def state_payload(state) -> Dict:
    """The checkpoint's content for a train/pretrain.py ``TrainState``."""
    return _host({
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "balancer_params": dict(state.balancer_params),
        "balancer_optimizer": (None if state.balancer_optimizer is None
                               else state.balancer_optimizer.state_dict()),
        "ema": state.ema,
        "generator": state.generator.get_state(),
    })


def save_checkpoint(directory: str, step: int, state) -> str:
    """Writes ``directory/checkpoint-{step}`` (through a temporary file, so a
    reader never sees half a checkpoint) and returns its path."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{PREFIX}{step}")
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(state_payload(state), tmp)
    os.replace(tmp, path)
    return path


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


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], what: str) -> None:
    if set(dst) != set(src):
        raise KeyError(f"restore_checkpoint: {what} holds {sorted(set(src) ^ set(dst))} on one side only")
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(src[k])


def restore_checkpoint(directory: str, state, step: Optional[int] = None):
    """Restores the checkpoint of ``step`` (the latest when None) into
    ``state`` in place and returns it; returns ``state`` unchanged when the
    directory holds none (the auto-resume of reference checkpoint.py:103-134)."""
    saved = _load(directory, step)
    if saved is None:
        return state
    _copy_into(state.model.state_dict(), saved["model"], "the model")
    state.optimizer.load_state_dict(saved["optimizer"])
    _copy_into(state.balancer_params, saved["balancer_params"], "the balancer")
    if (state.balancer_optimizer is None) != (saved["balancer_optimizer"] is None):
        raise ValueError("restore_checkpoint: the checkpoint and the state disagree on the balancer")
    if state.balancer_optimizer is not None:
        state.balancer_optimizer.load_state_dict(saved["balancer_optimizer"])
    if (state.ema is None) != (saved["ema"] is None):
        raise ValueError("restore_checkpoint: the checkpoint and the state disagree on the EMA")
    if state.ema is not None:
        _copy_into(state.ema, saved["ema"], "the EMA")
    state.generator.set_state(saved["generator"])
    state.step = saved["step"]
    return state


def restore_params(directory: str, model: torch.nn.Module, step: Optional[int] = None) -> torch.nn.Module:
    """Loads the saved parameters alone into ``model`` where name and shape
    match, whatever the rest of the state (the lenient load of reference
    checkpoint.py:26-72); reports the parameters left at their values.
    Returns ``model`` (unchanged when there is no checkpoint)."""
    saved = _load(directory, step)
    if saved is None:
        return model
    source = saved["model"]
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
