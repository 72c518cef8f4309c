"""Run logging, profiling, activation statistics and the command line of the
pretraining variants, on the CPU:

  * ``WandbLogger`` without wandb writes its fallback file, a JSON line an
    update; ``SummaryWriter`` writes its JSON lines;
  * ``collect_activation_stats``' keys are JAX's flax paths and its values
    JAX's (rtol 1e-4) on the modules both frameworks call;
  * ``cli.pretrain --fusion_mode lstm --log_wandb --profile_dir`` writes a
    fallback line a step and a Chrome trace of the profiled steps; the
    full decoder and the quadruplet train through the CLI.
The other CLIs and the export of the variants: tests/test_torch_variants_serving.py.
"""
import json
import re

import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.models.multimae import MultiMAE as JaxMultiMAE
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.utils import activation_stats as jstats
from incomplete_multimodal_fusion_tpu_torch.cli import pretrain as cli_pretrain
from incomplete_multimodal_fusion_tpu_torch.models.multimae import MultiMAE as TorchMultiMAE, build_multimae
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.utils.activation_stats import collect_activation_stats
from incomplete_multimodal_fusion_tpu_torch.utils.logging import WandbLogger
from incomplete_multimodal_fusion_tpu_torch.utils.summary import SummaryWriter, create_summary
from tests.test_torch_common import CHANNELS, DOMAINS, SMALL, as_jax, port_module, random_params, to_np

SMALL_RUN = ["--device", "cpu", "--input_size", "64", "--batch_size", "2", "--num_encoded_tokens", "24"]


def test_wandb_logger_falls_back_to_jsonl(tmp_path):
    logger = WandbLogger(config={"a": 1}, out_dir=str(tmp_path / "run"))
    for step in range(3):
        logger.set_step(step)
        logger.update({"loss": torch.tensor(1.5 + step), "lr": 0.1, "none": None})
    logger.flush()
    lines = [json.loads(line) for line in (tmp_path / "run" / "wandb_fallback.jsonl").read_text().splitlines()]
    assert lines == [{"step": s, "loss": 1.5 + s, "lr": 0.1} for s in range(3)]


def test_summary_writer_writes_jsonl(tmp_path):
    w = create_summary(str(tmp_path / "tb"))
    assert isinstance(w, SummaryWriter)
    w.add_scalar("loss", torch.tensor(2.0), 3)
    w.add_scalars({"a": 1, "b": 2.5}, 4)
    w.close()
    rows = [json.loads(line) for line in open(w.path)]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [("loss", 2.0, 3), ("a", 1.0, 4), ("b", 2.5, 4)]


def test_activation_stats_match_jax():
    """The flagship at SMALL: every key both frameworks produce for the
    regex agrees (the encoder and fusion blocks, the adapters, the pools'
    modules, the output dict), and the port names no module JAX does not."""
    rng = np.random.default_rng(0)
    x = {d: rng.standard_normal((2, 64, 64, CHANNELS[d])).astype(np.float32) for d in DOMAINS}
    jm = JaxMultiMAE(attn_impl="xla", **SMALL)
    mi = jmask.full_visible_mask_info(DOMAINS, (16,) * 3, 2)
    params = random_params(jm, 1, as_jax(x), mi, 48)
    regex = r"^(block\d|fus_block\d|input_adapter_|output_adapter_\w+/(block\d|out_proj)|(norm|mlp)/__call__|__call__/p)"
    want = jstats.collect_activation_stats(jm, {"params": params}, as_jax(x), mi, 48, filter_regex=regex)
    tm = port_module(TorchMultiMAE(attn_impl="auto", **SMALL), params)
    got = collect_activation_stats(tm, {d: torch.from_numpy(v) for d, v in x.items()},
                                   tmask.full_visible_mask_info(DOMAINS, (16,) * 3, 2), 48, filter_regex=regex)
    common = set(got) & set(want)
    assert {"block0/__call__", "fus_block1/__call__", "input_adapter_s2/__call__", "norm/__call__",
            "output_adapter_s1/block1/__call__", "__call__/preds/dem", "__call__/pooled"} <= common
    assert len(common) >= 60 and set(got) <= set(want), sorted(set(got) - set(want))
    for k in common:
        for stat in ("mean", "std", "absmax"):
            np.testing.assert_allclose(got[k][stat], want[k][stat], rtol=1e-4, atol=1e-5, err_msg=f"{k} {stat}")


def test_pretrain_cli_logs_every_step_and_profiles(tmp_path, capsys):
    out = tmp_path / "run"
    assert cli_pretrain.main([*SMALL_RUN, "--fusion_mode", "lstm", "--steps_per_epoch", "3", "--epochs", "1",
                              "--output_dir", str(out), "--log_wandb", "--profile_dir", str(out / "prof"),
                              "--profile_start", "1", "--profile_steps", "1"]) == 0
    log = capsys.readouterr().out
    lines = [json.loads(line) for line in (out / "wandb_fallback.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and "recon_loss" in r for r in lines)
    step0 = re.search(r"epoch 0 step 0: .*recon_loss=(\S+)", log)
    assert step0 and abs(float(step0.group(1)) - lines[0]["recon_loss"]) < 1e-4
    trace = json.loads((out / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("Optimizer.step" in n or "aten::" in n for n in names)
    assert "profiler trace written to" in log
    assert json.loads((out / "log.txt").read_text().splitlines()[-1])["epoch"] == 0


@pytest.mark.parametrize("flags", [["--fusion_mode", "crossattn", "--decoder_style", "full"],
                                   ["--fusion_mode", "crossattn_v1", "--in_domains", "s1_2ch-s2_4ch-dem-dnw",
                                    "--out_domains", "s1_2ch-s2_4ch-dem-dnw", "--num_encoded_tokens", "32"]])
def test_pretrain_cli_builds_the_variants(flags, tmp_path):
    out = tmp_path / "run"
    assert cli_pretrain.main([*SMALL_RUN, "--steps_per_epoch", "2", "--epochs", "1", "--output_dir", str(out),
                              *flags]) == 0
    saved = torch.load(out / "checkpoint-2", map_location="cpu", weights_only=False)
    assert saved["step"] == 2
    args = cli_pretrain.get_args([*flags])
    cfg = cli_pretrain.build_config(args)
    model = build_multimae(cfg, device="cpu")
    assert set(saved["model"]) == set(model.state_dict())
