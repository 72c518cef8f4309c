"""The port's pretraining CLI (``python -m
incomplete_multimodal_fusion_tpu_torch.cli.pretrain``) on the CPU, in
subprocesses, at a small size (the ``tiny`` widths on 64² rasters, B = 2,
f32, 2 epochs of 2 steps, the balancer and the EMA on):

  * a straight run writes a checkpoint at each epoch boundary and one JSON
    line an epoch in ``log.txt``;
  * a fresh process given only the first epoch's checkpoint resumes with
    ``--auto_resume`` and writes a last checkpoint bitwise equal to the
    straight run's;
  * ``--steps_per_call 2`` (``make_multi_step``, a loop of steps on the CPU)
    writes the same last checkpoint bit for bit;
  * the parallel flags' refusals are the JAX script's, with its words
    (scripts/pretrain.py:169-178), given before any process group forms,
    and the device defaults to ``cuda``;
  * two gloo ranks under torchrun with ``--tp 2`` and with ``--pp 2`` train
    and write checkpoints in the one-device layout (the straight run's
    tensors, names and shapes). ``--data_path`` runs:
    tests/test_torch_data_cli.py.
"""
import json
import os
import re
import shutil
import socket
import subprocess
import sys

import pytest
import torch

from incomplete_multimodal_fusion_tpu_torch.cli import pretrain as cli
from tests.test_torch_checkpoint import assert_bitwise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_RUN = ["--device", "cpu", "--input_size", "64", "--batch_size", "2", "--num_encoded_tokens", "24",
             "--steps_per_epoch", "2", "--epochs", "2", "--save_ckpt_freq", "1", "--warmup_epochs", "0",
             "--compute_dtype", "float32", "--use_ema", "--task_balancer", "uncertainty", "--seed", "3"]


def _cli(out_dir, *extra):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "incomplete_multimodal_fusion_tpu_torch.cli.pretrain", *SMALL_RUN,
                        "--output_dir", str(out_dir), *extra], capture_output=True, text=True, timeout=600,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def _load(path):
    return torch.load(str(path), weights_only=True)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    out = tmp_path_factory.mktemp("straight")
    log = _cli(out)
    return out, log


def test_straight_run_checkpoints_and_logs(straight):
    out, log = straight
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-4", "log.txt"]
    lines = [json.loads(line) for line in (out / "log.txt").read_text().splitlines()]
    assert [(x["epoch"], x["step"]) for x in lines] == [(0, 1), (1, 3)]
    assert all(x["recon_loss"] == x["recon_loss"] for x in lines)  # finite, not NaN
    assert "epoch 0 step 0:" in log and "Resumed" not in log
    last = _load(out / "checkpoint-4")
    assert last["step"] == 4 and int(last["optimizer"]["count"]) == 4
    assert last["ema"] is not None and set(last["balancer_params"]) == {"s1", "s2", "dem"}


def test_auto_resume_continues_bitwise(straight, tmp_path):
    out, _ = straight
    shutil.copy(out / "checkpoint-2", tmp_path / "checkpoint-2")
    log = _cli(tmp_path)
    assert "Resumed from step 2" in log
    assert_bitwise(_load(tmp_path / "checkpoint-4"), _load(out / "checkpoint-4"))


def test_steps_per_call_is_k_sequential_steps(straight, tmp_path):
    out, _ = straight
    _cli(tmp_path, "--steps_per_call", "2")
    assert_bitwise(_load(tmp_path / "checkpoint-4"), _load(out / "checkpoint-4"))


# (flags, world size, the JAX script's words)
REFUSALS = [
    (["--tp", "2"], 1, "--tp 2 does not divide 1 devices"),
    (["--sp"], 1, "--sp needs --tp > 1 (nothing to shard tokens over)"),
    (["--tp", "2", "--pp", "2"], 4, "--pp excludes --tp/--sp (PP composes with DP only)"),
    (["--tp", "2", "--sp", "--pp", "2"], 4, "--pp excludes --tp/--sp (PP composes with DP only)"),
    (["--pp", "3"], 4, "--pp 3 does not divide 4 devices"),
    (["--tp", "3"], 4, "--tp 3 does not divide 4 devices"),
]


@pytest.mark.parametrize("flag", REFUSALS)
def test_unported_flags_raise(flag, tmp_path, monkeypatch):
    """The parallel flags' refusals (all five flags run since they were
    ported): the JAX script's, before any group forms."""
    args, world, words = flag
    monkeypatch.setenv("WORLD_SIZE", str(world))
    with pytest.raises(SystemExit, match=re.escape(words)):
        cli.main(["--device", "cpu", "--output_dir", str(tmp_path), *args])
    assert not os.listdir(tmp_path)  # refused before anything ran


@pytest.mark.parametrize("mode", [["--tp", "2"], ["--pp", "2"]], ids=["tp", "pp"])
def test_two_rank_cli_runs(mode, straight, tmp_path):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_addr",
                        "127.0.0.1", "--master_port", str(port), "-m",
                        "incomplete_multimodal_fusion_tpu_torch.cli.pretrain", *SMALL_RUN, "--output_dir",
                        str(tmp_path), *mode], capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert f"dp=1 tp={2 if mode[0] == '--tp' else 1} pp={2 if mode[0] == '--pp' else 1}" in r.stdout
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-2", "checkpoint-4", "log.txt"]
    lines = [json.loads(line) for line in (tmp_path / "log.txt").read_text().splitlines()]
    assert len(lines) == 2 and all(x["recon_loss"] == x["recon_loss"] for x in lines)
    got, want = _load(tmp_path / "checkpoint-4"), _load(straight[0] / "checkpoint-4")
    for part in ("model", "ema"):
        assert {k: v.shape for k, v in got[part].items()} == {k: v.shape for k, v in want[part].items()}
    assert got["optimizer"]["mu"].shape == want["optimizer"]["mu"].shape and int(got["optimizer"]["count"]) == 4


def test_flags_reach_the_config():
    args = cli.get_args(["--batch_size", "4", "--input_size", "128", "--use_ema", "--task_balancer",
                         "uncertainty", "--in_domains", "s1-s2", "--blr", "0.5", "--skip_grad", "3"])
    cfg = cli.build_config(args)
    assert args.device == "cuda" and args.auto_resume
    assert cfg.data.batch_size == 4 and cfg.data.in_domains == ("s1", "s2")
    assert cfg.model.num_fusion_tokens == (128 // 16) ** 2
    assert cfg.train.use_ema and cfg.optim.task_balancer == "uncertainty"
    assert cfg.optim.blr == 0.5 and cfg.optim.skip_grad == 3.0
