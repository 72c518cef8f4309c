"""The port's conversion and inference CLIs on the CPU, in subprocesses:

  * ``cli.convert_checkpoint`` on a ``.pth`` of tests/golden/
    fullmodel_golden.npz's ``w::`` weights with DDP's ``module.`` prefixes
    restores bit for bit to ``convert_multimae_state``'s output, and to the
    JAX package's scripts/convert_checkpoint.py output carried by
    ``params_from_jax``; ``--arch maskformer`` likewise on the three
    downstream goldens as one checkpoint (``crossattn_v1``:
    tests/test_torch_run_logging.py);
  * ``cli.infer`` on a ``cli.pretrain`` checkpoint (the ``tiny`` widths at
    64²; the golden's widths are not a model size the CLI builds) prints
    each masked modality's PSNR equal, to 1e-5, to ``infer.masked_psnr`` of
    the port's ``infer`` under the same generator, "fully visible" for the
    others; ``--drop dem`` masks every dem patch; the PNG grid is written;
    a non-PNG output raises, the device defaults to ``cuda`` (``--data_path``:
    tests/test_torch_data_cli.py).
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.utils import torch_convert as jconvert
from incomplete_multimodal_fusion_tpu_torch import infer as tinfer
from incomplete_multimodal_fusion_tpu_torch.cli import infer as cli_infer
from incomplete_multimodal_fusion_tpu_torch.config import MODEL_SIZES, DataConfig, PretrainConfig
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch
from incomplete_multimodal_fusion_tpu_torch.models.multimae import build_multimae
from incomplete_multimodal_fusion_tpu_torch.utils import checkpoint as ckpt_lib
from incomplete_multimodal_fusion_tpu_torch.utils import torch_convert as tconvert
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import CHANNELS, DOMAINS
from tests.test_torch_convert import FULL_W, _assert_bitwise
from tests.test_torch_downstream import _golden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, *args, expect=0):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", f"incomplete_multimodal_fusion_tpu_torch.cli.{module}", *args],
                       capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == expect, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def test_convert_multimae_is_bitwise_the_converter_and_jaxs_script(tmp_path):
    pth, out, jout = str(tmp_path / "ref.pth"), tmp_path / "port", str(tmp_path / "jax")
    torch.save({"model": {f"module.{k}": torch.from_numpy(v.copy()) for k, v in FULL_W.items()}}, pth)
    log = _run("convert_checkpoint", pth, str(out), "--in_domains", "s1-s2-dem", "--depth", "2",
               "--decoder_depth", "2", "--step", "5")
    assert f"-> {out} (step 5," in log and os.listdir(out) == ["checkpoint-5"]
    got = ckpt_lib.load_model_state(str(out))
    _assert_bitwise(got, tconvert.convert_multimae_state(FULL_W, DOMAINS, DOMAINS, CHANNELS, patch_size=16, depth=2,
                                                         decoder_depth=2))
    # the JAX package's script on the same .pth, carried into the port
    sys.path.insert(0, ROOT)
    import scripts.convert_checkpoint as jscript
    from incomplete_multimodal_fusion_tpu.utils import checkpoint as jckpt
    jscript.main([pth, jout, "--in_domains", "s1-s2-dem", "--depth", "2", "--decoder_depth", "2", "--step", "5"])
    ref = jconvert.convert_multimae_state(FULL_W, DOMAINS, DOMAINS, CHANNELS, depth=2, decoder_depth=2)
    restored = jckpt.restore_checkpoint(jout, {"params": ref})["params"]
    _assert_bitwise(got, params_from_jax(jax.tree.map(np.asarray, restored)))


def test_convert_maskformer_is_bitwise_the_converter(tmp_path):
    state = {}
    for name, prefix in (("vit_baseline", "backbone."), ("pixel_decoder", "sem_seg_head.pixel_decoder."),
                         ("mask2former_decoder", "sem_seg_head.predictor.")):
        state.update({f"module.{prefix}{k}": torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in _golden(name)[1].items()})
    pth = str(tmp_path / "mf.pth")
    torch.save(state, pth)  # a raw state dict
    _run("convert_checkpoint", pth, str(tmp_path / "out"), "--arch", "maskformer", "--depth", "4", "--enc_layers",
         "1", "--dec_layers", "3", "--hidden_dim", "32")
    kw = dict(depth=4, enc_layers=1, dec_layers=3, hidden_dim=32)
    _assert_bitwise(ckpt_lib.load_model_state(str(tmp_path / "out")),
                    params_from_jax(jconvert.convert_maskformer_state(state, DOMAINS, **kw)))


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    out = tmp_path_factory.mktemp("pretrained")
    _run("pretrain", "--device", "cpu", "--input_size", "64", "--batch_size", "2", "--num_encoded_tokens", "24",
         "--steps_per_epoch", "1", "--epochs", "1", "--save_ckpt_freq", "1", "--compute_dtype", "float32",
         "--output_dir", str(out))
    return out


INFER = ["--device", "cpu", "--input_size", "64", "--num_encoded_tokens", "24"]


def _expected(ckpt, seed, num_encoded_tokens, drop=()):
    """(PSNR by masked modality, masked counts) of the port's infer on the
    CLI's model, tile and generator."""
    cfg = PretrainConfig(model=dataclasses.replace(MODEL_SIZES["tiny"], num_fusion_tokens=16),
                         data=DataConfig(input_size=64, in_domains=DOMAINS, out_domains=DOMAINS, batch_size=1))
    model = ckpt_lib.restore_params(str(ckpt), build_multimae(cfg, device="cpu")).eval()
    x = synthetic_batch(np.random.default_rng(seed), DOMAINS, 1, 64)
    res = tinfer.infer(model, None, x, num_encoded_tokens, generator=torch.Generator().manual_seed(seed),
                       drop_modalities=drop)
    return ({d: float(tinfer.masked_psnr(res.preds[d], torch.from_numpy(x[d]), res.task_masks[d], 16))
             for d in DOMAINS if int(res.task_masks[d].sum())},
            {d: int(res.task_masks[d].sum()) for d in DOMAINS})


@pytest.mark.parametrize("seed,tokens", [(1, 24), (4, 16)])
def test_infer_prints_the_masked_psnr(pretrained, tmp_path, seed, tokens):
    png = str(tmp_path / "grid.png")
    log = _run("infer", *INFER, "--ckpt_dir", str(pretrained), "--seed", str(seed), "--num_encoded_tokens",
               str(tokens), "--output", png)
    assert f"restored params from {pretrained} step 1" in log and f"wrote {png}" in log
    psnr, masked = _expected(pretrained, seed, tokens)
    assert psnr
    for d in DOMAINS:
        if d in psnr:
            got = re.search(rf"^{d}: masked-patch PSNR (\S+) dB \((\d+)/16 patches masked\)$", log, re.M)
            assert got and int(got.group(2)) == masked[d], log
            assert abs(float(got.group(1)) - psnr[d]) <= 1e-5
        else:
            assert f"{d}: fully visible (no reconstruction target)" in log
    assert os.path.getsize(png) > 0


def test_infer_drop_masks_every_dem_patch(pretrained, tmp_path):
    png = str(tmp_path / "grid.png")
    log = _run("infer", *INFER, "--ckpt_dir", str(pretrained), "--drop", "dem", "--output", png)
    psnr, masked = _expected(pretrained, 1, 24, drop=("dem",))
    assert masked == {"s1": 0, "s2": 0, "dem": 16}
    got = re.search(r"^dem: masked-patch PSNR (\S+) dB \(16/16 patches masked\)$", log, re.M)
    assert got and abs(float(got.group(1)) - psnr["dem"]) <= 1e-5
    assert "s1: fully visible" in log and "s2: fully visible" in log
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_infer_without_a_checkpoint_warns(tmp_path):
    log = _run("infer", *INFER, "--ckpt_dir", str(tmp_path / "none"), "--output", str(tmp_path / "g.png"))
    assert "WARNING: no checkpoint found; using random init" in log


def test_infer_refuses_other_image_formats_and_defaults_to_cuda(pretrained, tmp_path):
    with pytest.raises(ValueError, match="PNG only"):
        cli_infer.main([*INFER, "--ckpt_dir", str(pretrained), "--output", str(tmp_path / "out.jpg")])
    args = cli_infer.get_args([])
    assert args.device == "cuda" and args.output == "output.png" and args.num_encoded_tokens == 256
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_infer.main(["--ckpt_dir", str(tmp_path)])
