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
  * each flag of the JAX script the port does not run yet (parallelism)
    raises ``NotImplementedError`` naming it, and the device defaults to
    ``cuda``. ``--data_path`` runs: tests/test_torch_data_cli.py.
"""
import json
import os
import shutil
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


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--fsdp"], ["--sp"], ["--pp", "2"], ["--pp_microbatches", "4"]])
def test_unported_flags_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match=flag[0]):
        cli.main(["--device", "cpu", "--output_dir", str(tmp_path), *flag])
    assert not os.listdir(tmp_path)  # refused before anything ran


def test_flags_reach_the_config():
    args = cli.get_args(["--batch_size", "4", "--input_size", "128", "--use_ema", "--task_balancer",
                         "uncertainty", "--in_domains", "s1-s2", "--blr", "0.5", "--skip_grad", "3"])
    cfg = cli.build_config(args)
    assert args.device == "cuda" and args.auto_resume
    assert cfg.data.batch_size == 4 and cfg.data.in_domains == ("s1", "s2")
    assert cfg.model.num_fusion_tokens == (128 // 16) ** 2
    assert cfg.train.use_ema and cfg.optim.task_balancer == "uncertainty"
    assert cfg.optim.blr == 0.5 and cfg.optim.skip_grad == 3.0
