"""The exported serving program (``serving.export_infer`` /
``load_exported``, ``cli.export_serving``): the artifact reloads and
reproduces the live forward (atol 1e-5) and the JAX package's
``model.apply`` on the same weights (atol 5e-5, the slice tests' bound)
with the s2 modality dropped, as tests/test_serving.py pins the JAX export;
its graph reaches the kernels only as the operators of ops/library.py, as
many a forward as the card launches; and a process that reloads it imports
no model code."""
import collections
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.models.multimae import MultiMAE as JaxMultiMAE
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu_torch import serving
from incomplete_multimodal_fusion_tpu_torch.cli import export_serving
from incomplete_multimodal_fusion_tpu_torch.config import MODEL_SIZES, DataConfig, PretrainConfig
from incomplete_multimodal_fusion_tpu_torch.models.multimae import MultiMAE as TorchMultiMAE, build_multimae
from incomplete_multimodal_fusion_tpu_torch.ops import library
from incomplete_multimodal_fusion_tpu_torch.utils import checkpoint as ckpt_lib
from tests.test_torch_common import CHANNELS, DOMAINS, NP_, SMALL, as_jax, port_module, random_params, to_np

ROOT = Path(__file__).resolve().parents[1]
B = 1
CAPACITY = NP_ * len(DOMAINS)


def _request(seed=0, b=B, size=64, dropped=("s2",)):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((b, size, size, CHANNELS[d])).astype(np.float32) for d in DOMAINS]
    n = (size // 16) ** 2
    masks = [np.full((b, n), 1 if d in dropped else 0, np.int32) for d in DOMAINS]
    return xs, masks


@pytest.fixture(scope="module")
def exported():
    xs, masks = _request()
    jm = JaxMultiMAE(attn_impl="auto", **SMALL)
    mi = jmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, B)
    params = random_params(jm, 5, as_jax(dict(zip(DOMAINS, xs))), mi, CAPACITY)
    tm = port_module(TorchMultiMAE(attn_impl="auto", **SMALL), params)
    blob = serving.export_infer(tm, None, batch=B, image_size=64)
    return jm, params, tm, blob


def test_export_roundtrip_matches_live_forward_and_jax(exported, tmp_path):
    jm, params, tm, blob = exported
    assert isinstance(blob, bytes) and len(blob) > 0
    path = tmp_path / "model.pt2"
    path.write_bytes(blob)
    serve = serving.load_exported(path.read_bytes())
    xs, masks = _request()
    out = serve(*xs, *masks)
    live = serving.infer_closure(tm, None, DOMAINS)(*xs, *masks)
    e = CAPACITY
    jmi = jmask.mask_info_from_task_masks(as_jax(dict(zip(DOMAINS, masks))), DOMAINS, e)
    ref = jm.apply({"params": params}, as_jax(dict(zip(DOMAINS, xs))), jmi, e)
    for d in DOMAINS:
        np.testing.assert_allclose(to_np(out["preds"][d]), to_np(live["preds"][d]), atol=1e-5, err_msg=d)
        np.testing.assert_allclose(to_np(out["preds"][d]), np.asarray(ref["preds"][d]), atol=5e-5, err_msg=d)
    np.testing.assert_allclose(to_np(out["pooled"]), to_np(live["pooled"]), atol=1e-5)
    np.testing.assert_allclose(to_np(out["pooled"]), np.asarray(ref["pooled"]), atol=5e-5)


def _kernel_nodes(program):
    return collections.Counter(str(n.target) for n in program.graph.nodes if library.is_kernel_op(n.target))


def test_exported_graph_holds_the_kernels_at_the_per_forward_counts(exported):
    """K1 zorro one an encoder layer, K1 unmasked and K2's MLP one a decoder
    layer and task, K2's GEGLU two an encoder layer, K3 one: the launches of
    a forward on the card (chip_smoke.PER_FORWARD at depth 12)."""
    *_, blob = exported
    program = serving.load_exported(blob).program
    depth, dec, t = SMALL["depth"], SMALL["decoder_depth"], len(DOMAINS)
    assert _kernel_nodes(program) == {"imf_torch.zorro_attention_qkv.default": depth + dec * t,
                                      "imf_torch.geglu_ffn.default": 2 * depth,
                                      "imf_torch.mlp_ffn.default": dec * t,
                                      "imf_torch.fusion_row_attention.default": depth}
    # the forward keeps no lse: serving computes no gradient
    for node in program.graph.nodes:
        if str(node.target) == "imf_torch.zorro_attention_qkv.default":
            assert node.args[-1] is False


def test_exported_batched_decoder_holds_one_kernel_a_layer():
    model = TorchMultiMAE(attn_impl="auto", decoder_batch_tasks=True, **SMALL).eval()
    model.init_weights(torch.Generator().manual_seed(1))
    program = serving.load_exported(serving.export_infer(model, None, batch=2, image_size=64)).program
    depth, dec = SMALL["depth"], SMALL["decoder_depth"]
    assert _kernel_nodes(program) == {"imf_torch.zorro_attention_qkv.default": depth + dec,
                                      "imf_torch.geglu_ffn.default": 2 * depth,
                                      "imf_torch.mlp_ffn_tasks.default": dec,
                                      "imf_torch.fusion_row_attention.default": depth}


RELOAD = """
import json, sys
import numpy as np
from incomplete_multimodal_fusion_tpu_torch import serving
serve = serving.load_exported(open(sys.argv[1], "rb").read())
data = np.load(sys.argv[2])
n = len(data.files) // 2
out = serve(*[data[f"x{i}"] for i in range(n)], *[data[f"m{i}"] for i in range(n)])
np.savez(sys.argv[3], pooled=out["pooled"].numpy(), **{f"p_{d}": v.numpy() for d, v in out["preds"].items()})
print(json.dumps(sorted(m for m in sys.modules if m.startswith("incomplete_multimodal_fusion_tpu"))))
"""


def _reload_in_fresh_process(blob, xs, masks, tmp_path):
    (tmp_path / "model.pt2").write_bytes(blob)
    np.savez(tmp_path / "req.npz", **{f"x{i}": x for i, x in enumerate(xs)}, **{f"m{i}": m for i, m in enumerate(masks)})
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", RELOAD, str(tmp_path / "model.pt2"), str(tmp_path / "req.npz"),
                           str(tmp_path / "out.npz")], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1]), np.load(tmp_path / "out.npz")


def test_reload_in_a_fresh_process_imports_no_model_code(exported, tmp_path):
    *_, tm, blob = exported
    xs, masks = _request(seed=2)
    loaded, out = _reload_in_fresh_process(blob, xs, masks, tmp_path)
    assert "incomplete_multimodal_fusion_tpu_torch.ops.library" in loaded
    assert not [m for m in loaded if m.split(".")[1:2] in (["models"], ["train"], ["losses"],
                                                          ["infer_segmentation"])], loaded
    assert not [m for m in loaded if m.split(".")[0] == "incomplete_multimodal_fusion_tpu"]
    live = serving.infer_closure(tm, None, DOMAINS)(*xs, *masks)
    for d in DOMAINS:
        np.testing.assert_allclose(out[f"p_{d}"], to_np(live["preds"][d]), atol=1e-5)
    np.testing.assert_allclose(out["pooled"], to_np(live["pooled"]), atol=1e-5)


def test_cli_exports_a_checkpoint_that_reloads(tmp_path, capsys):
    """cli.export_serving on weights written by utils.checkpoint.save_params
    (the full-width ``tiny`` model at 64^2, seeded weights unlike the CLI's
    own initialisation): the artifact reloads and answers as the model with
    those weights does; the printed line is the JAX script's."""
    cfg = PretrainConfig(model=dataclasses.replace(MODEL_SIZES["tiny"], num_fusion_tokens=16),
                         data=DataConfig(input_size=64))
    model = build_multimae(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).eval()
    ckpt_lib.save_params(str(tmp_path / "ckpt"), 7, model.state_dict())
    out_path = tmp_path / "tiny.pt2"
    assert export_serving.main([str(tmp_path / "ckpt"), str(out_path), "--input_size", "64", "--batch", "2",
                                "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("exported ") and line.endswith(f"-> {out_path} (batch=2, 64^2, domains=s1-s2-dem)")
    xs, masks = _request(seed=4, b=2, dropped=("dem",))
    out = serving.load_exported(out_path.read_bytes())(*xs, *masks)
    live = serving.infer_closure(model, None, DOMAINS)(*xs, *masks)
    for d in DOMAINS:
        np.testing.assert_allclose(to_np(out["preds"][d]), to_np(live["preds"][d]), atol=1e-5)
    np.testing.assert_allclose(to_np(out["pooled"]), to_np(live["pooled"]), atol=1e-5)


def test_cli_refuses_other_fusion_modes(tmp_path):
    with pytest.raises(NotImplementedError, match="zorro"):
        export_serving.main([str(tmp_path), str(tmp_path / "x.pt2"), "--fusion_mode", "zorro", "--device", "cpu"])


def test_exported_fused_block_encoder_holds_k6():
    """An encoder built with ``fused_block=True`` (at a width its gate
    takes: 2 heads of 32) exports with one K6 node a block, in place of
    the block's K1 zorro node."""
    cfg = dict(SMALL, dim_head=32)
    model = TorchMultiMAE(attn_impl="auto", **cfg).eval()
    model.init_weights(torch.Generator().manual_seed(2))
    for blk in model.blocks:
        blk.fused_block = True
    program = serving.load_exported(serving.export_infer(model, None, batch=1, image_size=64)).program
    depth, dec, t = cfg["depth"], cfg["decoder_depth"], len(DOMAINS)
    assert _kernel_nodes(program) == {"imf_torch.fused_block_attn.default": depth,
                                      "imf_torch.zorro_attention_qkv.default": dec * t,
                                      "imf_torch.geglu_ffn.default": 2 * depth,
                                      "imf_torch.mlp_ffn.default": dec * t,
                                      "imf_torch.fusion_row_attention.default": depth}
