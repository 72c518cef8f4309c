"""The serving and conversion side of the pretraining variants, on the CPU:

  * ``cli.infer`` takes ``zorro`` / ``lstm`` and the ``dnw`` domain (its
    pixel accuracy printed as ``infer.pixel_accuracy`` gives it);
  * ``cli.convert_checkpoint --fusion_mode crossattn_v1`` is bit for bit the
    converter (the port's, and the JAX package's through params_from_jax);
  * ``cli.export_serving`` exports an ``lstm`` checkpoint that reloads and
    answers as the live model;
  * an export round trip of the quadruplet's ``lstm`` model (2E layout,
    class-map input) against the live forward and JAX (atol 5e-5).
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.models.multimae import MultiMAE as JaxMultiMAE
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.utils import torch_convert as jconvert
from incomplete_multimodal_fusion_tpu_torch import infer as tinfer
from incomplete_multimodal_fusion_tpu_torch import serving as tserving
from incomplete_multimodal_fusion_tpu_torch.cli import convert_checkpoint as cli_convert
from incomplete_multimodal_fusion_tpu_torch.cli import export_serving as cli_export
from incomplete_multimodal_fusion_tpu_torch.cli import infer as cli_infer
from incomplete_multimodal_fusion_tpu_torch.config import MODEL_SIZES, DataConfig, DecoderConfig, PretrainConfig
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch
from incomplete_multimodal_fusion_tpu_torch.models.multimae import MultiMAE as TorchMultiMAE, build_multimae
from incomplete_multimodal_fusion_tpu_torch.utils import checkpoint as ckpt_lib
from incomplete_multimodal_fusion_tpu_torch.utils import torch_convert as tconvert
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import CHANNELS, DOMAINS, SMALL, as_jax, port_module, random_params, to_np
from tests.test_torch_convert import FULL_W, _assert_bitwise
from tests.test_torch_variants import ATOL, NP_, QUAD, VARIANT, batch


def _tiny(domains, mode):
    cfg = PretrainConfig(model=dataclasses.replace(MODEL_SIZES["tiny"], num_fusion_tokens=16, fusion_mode=mode),
                         data=DataConfig(input_size=64, in_domains=domains, out_domains=domains, batch_size=1))
    return build_multimae(cfg, device="cpu").eval()


@pytest.mark.parametrize("mode,domains", [("lstm", QUAD), ("zorro", DOMAINS)])
def test_infer_cli_takes_the_modes_and_a_class_map(mode, domains, tmp_path, capsys):
    png = str(tmp_path / "grid.png")
    assert cli_infer.main(["--device", "cpu", "--input_size", "64", "--num_encoded_tokens", "32", "--fusion_mode",
                           mode, "--in_domains", "-".join(domains), "--ckpt_dir", str(tmp_path / "none"),
                           "--output", png]) == 0
    log = capsys.readouterr().out
    x = synthetic_batch(np.random.default_rng(1), domains, 1, 64)
    res = tinfer.infer(_tiny(domains, mode), None, x, 32, generator=torch.Generator().manual_seed(1))
    for d in domains:
        if not int(res.task_masks[d].sum()):
            continue
        if d == "dnw":
            got = re.search(r"^dnw: class-map pixel accuracy (\S+) \(", log, re.M)
            assert got and abs(float(got.group(1)) - float(tinfer.pixel_accuracy(res.preds[d], torch.from_numpy(
                x[d])))) <= 1e-6
        else:
            assert re.search(rf"^{d}: masked-patch PSNR \S+ dB", log, re.M), log
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _crossattn_v1_reference_state():
    """A reference crossattn_v1 state dict at the fullmodel golden's widths:
    its flagship weights without the fusion blocks, plus the snapshot's
    modules (seeded)."""
    rng = np.random.default_rng(3)
    state = {k: v for k, v in FULL_W.items() if not k.startswith("fus_blocks.")}
    d = FULL_W["fusion_tokens"].shape[-1]
    extra = {"attn_pool_modalities.q.weight": (d, d), "attn_pool_modalities.kv.weight": (2 * d, d),
             "attn_pool_modalities.proj.weight": (d, d), "attn_pool_modalities.proj.bias": (d,)}
    for k, v in FULL_W.items():
        if k.startswith("mlp."):
            extra[f"mlp_modalities.{k[4:]}"] = v.shape
            extra.update({f"mlp_{m}.{k[4:]}": v.shape for m in DOMAINS})
        if k.startswith("attn_pool."):
            extra.update({f"attn_{m}.{k[10:]}": v.shape for m in DOMAINS})
    state.update({k: (0.05 * rng.standard_normal(s)).astype(np.float32) for k, s in extra.items()})
    return state


def test_convert_cli_takes_crossattn_v1(tmp_path):
    state = _crossattn_v1_reference_state()
    pth = tmp_path / "v1.pth"
    torch.save({"model": {k: torch.from_numpy(v.copy()) for k, v in state.items()}}, pth)
    assert cli_convert.main([str(pth), str(tmp_path / "out"), "--fusion_mode", "crossattn_v1", "--depth", "2",
                             "--decoder_depth", "2", "--step", "3"]) == 0
    got = ckpt_lib.load_model_state(str(tmp_path / "out"))
    kw = dict(patch_size=16, depth=2, decoder_depth=2, fusion_mode="crossattn_v1")
    _assert_bitwise(got, tconvert.convert_multimae_state(state, DOMAINS, DOMAINS, CHANNELS, **kw))
    _assert_bitwise(got, params_from_jax(jconvert.convert_multimae_state(state, DOMAINS, DOMAINS, CHANNELS, **kw)))
    model = TorchMultiMAE(fusion_mode="crossattn_v1", **SMALL)
    model.load_state_dict(got, strict=True)


def test_export_cli_takes_a_2e_mode(tmp_path, capsys):
    cfg = PretrainConfig(model=dataclasses.replace(MODEL_SIZES["tiny"], num_fusion_tokens=16, fusion_mode="lstm"),
                         data=DataConfig(input_size=64), decoder=DecoderConfig())
    model = build_multimae(cfg, device="cpu", generator=torch.Generator().manual_seed(4)).eval()
    ckpt_lib.save_params(str(tmp_path / "ckpt"), 1, model.state_dict())
    out_path = tmp_path / "lstm.pt2"
    assert cli_export.main([str(tmp_path / "ckpt"), str(out_path), "--input_size", "64", "--fusion_mode", "lstm",
                            "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("exported ")
    x = synthetic_batch(np.random.default_rng(5), DOMAINS, 1, 64)
    args = [x[d] for d in DOMAINS] + [np.full((1, NP_), int(d == "s2"), np.int32) for d in DOMAINS]
    served = tserving.load_exported(out_path.read_bytes())(*args)
    live = tserving.infer_closure(model, None, DOMAINS)(*args)
    for d in DOMAINS:
        np.testing.assert_allclose(to_np(served["preds"][d]), to_np(live["preds"][d]), atol=1e-5)


def test_export_round_trip_of_the_quadruplet_lstm():
    """export_infer -> bytes -> load_exported, s2_4ch dropped: the class
    map goes in as int32; the live forward's answer, and JAX's."""
    kw = dict(VARIANT, in_domains=QUAD, out_domains=QUAD, fusion_mode="lstm")
    jm = JaxMultiMAE(attn_impl="xla", **kw)
    params = random_params(jm, 1, as_jax(batch(QUAD, 0)), jmask.full_visible_mask_info(QUAD, (NP_,) * 4, 2), 4 * NP_)
    tm = port_module(TorchMultiMAE(attn_impl="auto", **kw), params)
    x = batch(QUAD, 6, b=1)
    masks = {d: np.full((1, NP_), int(d == "s2_4ch"), np.int32) for d in QUAD}
    args = [x[d] for d in QUAD] + [masks[d] for d in QUAD]
    serve = tserving.load_exported(tserving.export_infer(tm, None, batch=1, image_size=64))
    assert tserving.input_dtypes(serve.program) == [torch.float32] * 3 + [torch.int32] * 5
    served = serve(*args)
    live = tserving.infer_closure(tm, None, QUAD)(*args)
    ref = jm.apply({"params": params}, as_jax(x), jmask.mask_info_from_task_masks(as_jax(masks), QUAD, 4 * NP_),
                   4 * NP_)
    for d in QUAD:
        np.testing.assert_allclose(to_np(served["preds"][d]), to_np(live["preds"][d]), atol=1e-5)
        np.testing.assert_allclose(to_np(served["preds"][d]), np.asarray(ref["preds"][d]), atol=ATOL)
    np.testing.assert_allclose(to_np(served["pooled"]), np.asarray(ref["pooled"]), atol=ATOL)
