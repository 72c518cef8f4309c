"""Checkpoints of the port's pretraining state (utils/checkpoint.py):

  * resume in fresh processes, as tests/test_checkpoint_resume.py phase 1
    does for the JAX package: an unbroken 6-step run against 3 steps, a
    save, a new process that restores and takes 3 more; the masters,
    FlatAdamW's count and moments, the EMA, the balancer's log-variances and
    its optimizer's state, the step and the mask generator's state are
    bitwise equal (the masks come from the generator, so a generator that
    resumed wrong would change the run);
  * ``latest_step``, ``restore_checkpoint`` on a directory without one, a
    state that disagrees with the checkpoint, and ``restore_params``'
    lenient load.
"""
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from incomplete_multimodal_fusion_tpu_torch import config as tconfig
from incomplete_multimodal_fusion_tpu_torch.models.multimae import build_multimae
from incomplete_multimodal_fusion_tpu_torch.train import pretrain as tpretrain
from incomplete_multimodal_fusion_tpu_torch.utils import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One trainer run in fresh subprocesses. Batches are keyed by the absolute
# step, so any split consumes the same stream; the masks come from the
# state's generator.
_TRAINER = r"""
import sys
import numpy as np
import torch
from incomplete_multimodal_fusion_tpu_torch import config as c
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch
from incomplete_multimodal_fusion_tpu_torch.train import pretrain
from incomplete_multimodal_fusion_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)
mode, ckpt_dir, out, n_steps = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
cfg = c.PretrainConfig(
    model=c.ModelConfig(dim_tokens=32, depth=2, dim_head=16, heads=2, ff_mult=2, num_fusion_tokens=16),
    data=c.DataConfig(input_size=64, patch_size=16, batch_size=2), mask=c.MaskConfig(num_encoded_tokens=24),
    decoder=c.DecoderConfig(dim=32, depth=1, num_heads=2),
    optim=c.OptimConfig(blr=1.0, warmup_epochs=0, min_lr=1e-4, task_balancer="uncertainty", clip_grad=1.0),
    train=c.TrainConfig(epochs=1, compute_dtype="float32", use_ema=True, ema_decay=0.9))
model, state, optimizer = pretrain.create_train_state(cfg, 7, total_steps=10, device="cpu")
if mode == "resume":
    state = ckpt.restore_checkpoint(ckpt_dir, state)
step = pretrain.make_train_step(model, cfg, optimizer)
for _ in range(n_steps):
    batch = synthetic_batch(np.random.default_rng(1000 + state.step), cfg.data.in_domains, 2, 64)
    state, metrics = step(state, batch)
if mode == "save":
    ckpt.save_checkpoint(ckpt_dir, state.step, state)
torch.save(ckpt.state_payload(state), out)
"""


def _run(mode, ckpt_dir, out, steps):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _TRAINER, mode, str(ckpt_dir), str(out), str(steps)],
                       capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    return torch.load(str(out), weights_only=True)


def assert_bitwise(a, b, path="state"):
    """Two checkpoint payloads hold the same values bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            assert_bitwise(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_resume_in_a_fresh_process_is_bitwise_an_unbroken_run(tmp_path):
    full = _run("full", tmp_path / "unused", tmp_path / "full.pt", 6)
    half = _run("save", tmp_path / "ckpt", tmp_path / "half.pt", 3)
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 3
    resumed = _run("resume", tmp_path / "ckpt", tmp_path / "resumed.pt", 3)
    assert full["step"] == resumed["step"] == 6 and half["step"] == 3
    assert_bitwise(resumed, full)
    # the run moved every part of the state it carries
    for part in ("model", "ema", "balancer_params"):
        assert any(not torch.equal(half[part][k], full[part][k]) for k in full[part]), part
    assert not torch.equal(half["generator"], full["generator"])
    assert int(full["optimizer"]["count"]) == 6 and int(full["balancer_optimizer"]["count"]) == 6


def _small_cfg(**train):
    c = tconfig
    return c.PretrainConfig(
        model=c.ModelConfig(dim_tokens=32, depth=1, dim_head=16, heads=2, ff_mult=2, num_fusion_tokens=16),
        data=c.DataConfig(input_size=64, patch_size=16, batch_size=2), mask=c.MaskConfig(num_encoded_tokens=24),
        decoder=c.DecoderConfig(dim=32, depth=1, num_heads=2), train=c.TrainConfig(**train))


def test_latest_step_and_restore_without_a_checkpoint(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    (tmp_path / "checkpoint-junk").write_text("")
    assert ckpt.latest_step(str(tmp_path)) is None
    _, state, _ = tpretrain.create_train_state(_small_cfg(), 0, total_steps=4, device="cpu")
    assert ckpt.restore_checkpoint(str(tmp_path), state) is state and state.step == 0
    ckpt.save_checkpoint(str(tmp_path), 2, state)
    ckpt.save_checkpoint(str(tmp_path), 10, state)
    assert ckpt.latest_step(str(tmp_path)) == 10
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]


def test_restore_refuses_a_state_of_another_shape(tmp_path):
    _, state, _ = tpretrain.create_train_state(_small_cfg(use_ema=True), 0, total_steps=4, device="cpu")
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    _, plain, _ = tpretrain.create_train_state(_small_cfg(), 0, total_steps=4, device="cpu")
    with pytest.raises(ValueError, match="EMA"):
        ckpt.restore_checkpoint(str(tmp_path), plain)


def test_restore_is_in_place(tmp_path):
    """A restore copies into the state's own tensors: a CUDA graph captured
    over them goes on reading the restored values."""
    _, state, _ = tpretrain.create_train_state(_small_cfg(use_ema=True), 0, total_steps=4, device="cpu")
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    ptrs = [t.data_ptr() for t in state.tensors()]
    with torch.no_grad():
        for t in state.tensors():
            t.add_(1)
    state.step = 9
    ckpt.restore_checkpoint(str(tmp_path), state)
    assert [t.data_ptr() for t in state.tensors()] == ptrs and state.step == 0
    _, fresh, _ = tpretrain.create_train_state(_small_cfg(use_ema=True), 0, total_steps=4, device="cpu")
    for a, b in zip(state.tensors(), fresh.tensors()):
        assert torch.equal(a, b)


def test_restore_params_is_lenient(tmp_path, capsys):
    cfg = _small_cfg()
    _, state, _ = tpretrain.create_train_state(cfg, 0, total_steps=4, device="cpu")
    ckpt.save_checkpoint(str(tmp_path), 5, state)
    # a model of another depth: the shared names load, the extra block stays
    deeper = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, depth=2))
    other = build_multimae(deeper, device="cpu", generator=torch.Generator().manual_seed(1))
    extra = other.blocks[1].attn.to_q.weight.detach().clone()
    ckpt.restore_params(str(tmp_path), other)
    saved = dict(state.model.named_parameters())
    for name, p in other.named_parameters():
        if name in saved:
            assert torch.equal(p, saved[name]), name
    assert torch.equal(other.blocks[1].attn.to_q.weight, extra)
    assert "not found in the checkpoint" in capsys.readouterr().out
