"""The downstream step's data parallelism and the backbone's class-map input
against the JAX package, f32 on the CPU:

  * the data-parallel downstream step on 2 gloo ranks
    (tests/torch_parallel_worker.py, no jax), a row each, against two
    single-device JAX steps (``jax.value_and_grad`` of the JAX loss plus
    ``create_downstream_optimizer``'s optax chain) with the same modality
    subset, masks, matches and PointRend points injected as
    tests/test_torch_downstream_train.py's three-step test injects them:
    each step's loss within 1e-5 relative and its gradient norm within 1e-4,
    then every parameter within 1e-4 absolute (that test's bound); with
    dropout on, the 2-rank step against the same step on one rank;
  * ``ViTBaseline`` with ``in_domains = (s1, s2, dem, dnw)``, the ``dnw``
    class map through the class-map adapter, against the flax module via
    ``params_from_jax``: every token visible, and ``dnw`` dropped (its tokens
    masked and its plane out of the fusion stack; the outputs then do not
    move with the class map);
  * the MaskFormer on that backbone: one step's loss and every gradient
    against ``jax.value_and_grad`` (the class map stays an integer map: JAX
    casts floating leaves only);
  * ``cli.train_downstream`` on 2 gloo ranks under torchrun.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from incomplete_multimodal_fusion_tpu.losses import set_criterion as jsc
from incomplete_multimodal_fusion_tpu.models import maskformer as jmf
from incomplete_multimodal_fusion_tpu.models import vit_baseline as jvit
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.train import downstream as jds
from incomplete_multimodal_fusion_tpu_torch.losses import set_criterion as tsc
from incomplete_multimodal_fusion_tpu_torch.models import maskformer as tmf
from incomplete_multimodal_fusion_tpu_torch.models.layers import Dropout
from incomplete_multimodal_fusion_tpu_torch.models import vit_baseline as tvit
from incomplete_multimodal_fusion_tpu_torch.models.adapters import SemSegInputAdapter
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.train import downstream as tds
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import CHANNELS, as_jax, port_module, random_params, to_np
from tests.test_torch_downstream import _sharpen_masks
from tests.test_torch_downstream_train import CFG, FROZEN, P, _inputs, _jax_loss, _step_inputs, _targets
from tests.test_torch_parallel import ROOT, free_port, spawn

QUAD = ("s1", "s2", "dem", "dnw")
NP_ = 16
LR = 1e-3


def _quad_inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    return {d: (rng.integers(0, 9, (b, 64, 64)).astype(np.int32) if d == "dnw"
                else rng.standard_normal((b, 64, 64, CHANNELS[d])).astype(np.float32)) for d in QUAD}


def _torch_batch(x):
    return {d: torch.from_numpy(v) for d, v in x.items()}


# ---------------------------------------------------------------------------
# data parallel downstream step
# ---------------------------------------------------------------------------

def test_downstream_data_parallel_steps_match_jax(tmp_path):
    jm = jmf.MaskFormerModel(jmf.MaskFormerConfig(**CFG))
    x, t = _inputs(1), _targets(3)
    params = _sharpen_masks(random_params(jm, 2, as_jax(x)))
    value_and_grad = jax.jit(jax.value_and_grad(_jax_loss(jm, jm.cfg.max_encoded_tokens, jnp.float32)))
    tx = jds.create_downstream_optimizer(params, lr=LR, clip_grad=0.01, frozen_stages=FROZEN)
    opt_state, jp = tx.init(params), params
    steps, jlosses, jnorms = [], [], []
    for k in range(2):
        present, flat, matched, coords = _step_inputs(10 + k)
        steps.append((present, flat, matched, coords))
        mi = jmask.mask_info_from_flat_mask(jnp.asarray(flat), tuple(CFG["in_domains"]), (NP_,) * 3, 3 * NP_)
        loss, g = value_and_grad(jp, as_jax(x), jsc.SegTargets(*(jnp.asarray(a) for a in t)), mi,
                                 jnp.asarray(present), jnp.asarray(matched), jnp.asarray(coords))
        upd, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        jlosses.append(float(loss))
        jnorms.append(float(optax.global_norm(g)))
    job = dict(kind="downstream", cfg=CFG, params={k: v.numpy() for k, v in params_from_jax(params).items()},
               batch=x, targets=t, steps=steps, lr=LR, num_points=P)
    out = spawn(job, 2, tmp_path, "downstream_dp")
    np.testing.assert_allclose([m["loss"] for m in out["metrics"]], jlosses, rtol=1e-5)
    np.testing.assert_allclose([m["grad_norm"] for m in out["metrics"]], jnorms, rtol=1e-4)
    want = params_from_jax(jp)
    assert set(want) == set(out["params"])
    for name, w in want.items():
        np.testing.assert_allclose(to_np(out["params"][name]), w.numpy(), atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("rank", [0, 1])
def test_dropout_share_is_the_global_batch_rows(rank):
    """A rank's ``Dropout`` mask (share (rank, 2), n rows) is its rows of the
    one-device mask over the 2n rows of the global batch, under one seed."""
    x = torch.randn(6, 5, 8, generator=torch.Generator().manual_seed(3))
    whole, part = Dropout(0.25), Dropout(0.25)
    part.share = (rank, 2)
    torch.manual_seed(7)
    want = whole(x)[3 * rank:3 * (rank + 1)]
    torch.manual_seed(7)
    got = part(x[3 * rank:3 * (rank + 1)])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert 0 < int((got == 0).sum()) < got.numel()


def test_downstream_data_parallel_dropout_matches_one_device(tmp_path):
    """The data-parallel downstream step with dropout on (the pixel
    decoder's, 0.1) on 2 gloo ranks against the same step on one rank: each
    rank seeds dropout alike and keeps its rows of the global batch's mask,
    so the losses and weights are the one-device step's (f32, 1e-5)."""
    model = tmf.build_maskformer(tmf.MaskFormerConfig(**CFG), device="cpu")
    assert any(isinstance(m, Dropout) and m.rate > 0 for m in model.modules())
    params = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    job = dict(kind="downstream", cfg=CFG, params=params, batch=_inputs(1), targets=_targets(3),
               steps=[_step_inputs(10 + k) for k in range(2)], lr=LR, num_points=P, dropout=True)
    one = spawn(job, 1, tmp_path, "downstream_dropout_1")
    two = spawn(job, 2, tmp_path, "downstream_dropout_2")
    np.testing.assert_allclose([m["loss"] for m in two["metrics"]], [m["loss"] for m in one["metrics"]], rtol=1e-5)
    for name, w in one["params"].items():
        np.testing.assert_allclose(to_np(two["params"][name]), to_np(w), atol=1e-5, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# the class-map backbone
# ---------------------------------------------------------------------------

VIT = dict(in_domains=QUAD, image_size=64, patch_size=16, dim_tokens=32, depth=2, dim_head=16, heads=2,
           num_fusion_tokens=16)


@pytest.fixture(scope="module")
def vit_pair():
    x = _quad_inputs(15)
    jm = jvit.ViTBaseline(**VIT)
    params = random_params(jm, 16, as_jax(x), jmask.full_visible_mask_info(QUAD, (NP_,) * 4, 2), 4 * NP_)
    return jm, params, port_module(tvit.ViTBaseline(**VIT), params), x


@pytest.mark.parametrize("case", ["all", "dnw_dropped"])
def test_classmap_vit_baseline_matches_flax(vit_pair, case):
    jm, params, tm, x = vit_pair
    assert isinstance(tm.input_adapters["dnw"], SemSegInputAdapter)
    present = np.array([True, True, True, case == "all"])
    masks = {d: np.full((2, NP_), int(not p), np.int64) for d, p in zip(QUAD, present)}
    e = 4 * NP_
    jmi = jmask.mask_info_from_task_masks(as_jax(masks), QUAD, e)
    tmi = tmask.mask_info_from_task_masks({d: torch.from_numpy(m) for d, m in masks.items()}, QUAD, e)
    ref = jax.jit(lambda p, x, mi, pr: jm.apply({"params": p}, x, mi, e, present=pr))(
        params, as_jax(x), jmi, jnp.asarray(present))
    with torch.no_grad():
        out = tm(_torch_batch(x), tmi, e, present=torch.from_numpy(present))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(to_np(o), np.asarray(r), atol=1e-4)
    if case == "dnw_dropped":
        other = dict(x, dnw=(x["dnw"] + 4) % 9)
        with torch.no_grad():
            moved = tm(_torch_batch(other), tmi, e, present=torch.from_numpy(present))
        for a, b in zip(out, moved):
            assert torch.equal(a, b)


def _jax_classmap_loss(jm, e):
    """tests/test_torch_downstream_train.py's loss in f32, the class map left
    an integer map (JAX downstream.py:193-196 casts floating leaves only)."""

    def loss(params, batch, targets, mi, present, matched, coords):
        out = jm.apply({"params": params}, batch, mask_info=mi, num_encoded_tokens=e, present=present,
                       deterministic=True)
        losses = jsc.set_criterion(out, targets, jax.random.PRNGKey(0), CFG["num_classes"], num_points=P,
                                   cost_class=2.0, cost_mask=5.0, cost_dice=5.0, matched_override=matched,
                                   point_coords_override=coords)
        parts = {name: w * sum(v for k, v in losses.items() if k.startswith(name))
                 for name, w in (("loss_ce", 2.0), ("loss_dice", 5.0), ("loss_mask", 5.0))}
        return 0.3 * parts["loss_ce"] + 0.3 * parts["loss_dice"] + 0.4 * parts["loss_mask"]

    return loss


def test_classmap_maskformer_step_matches_jax():
    cfg = dict(CFG, in_domains=QUAD)
    jm = jmf.MaskFormerModel(jmf.MaskFormerConfig(**cfg))
    x, t = _quad_inputs(1), _targets(3)
    params = _sharpen_masks(random_params(jm, 2, as_jax(x)))
    e = jm.cfg.max_encoded_tokens
    present, flat3, matched, coords = _step_inputs(4)
    present = np.array([True, True, True, True])
    flat = np.concatenate([flat3, np.zeros((flat3.shape[0], NP_), np.int64)], axis=1)
    jmi = jmask.mask_info_from_flat_mask(jnp.asarray(flat), QUAD, (NP_,) * 4, e)
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_classmap_loss(jm, e)))(
        params, as_jax(x), jsc.SegTargets(*(jnp.asarray(a) for a in t)), jmi, jnp.asarray(present),
        jnp.asarray(matched), jnp.asarray(coords))
    tcfg = tmf.MaskFormerConfig(**cfg)
    model = tmf.build_maskformer(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    opt = tds.create_downstream_optimizer(model, lr=LR, clip_grad=0.01, frozen_stages=FROZEN)
    step = tds.make_downstream_train_step(model, tcfg, opt, num_points=P, compute_dtype="float32")
    tmi = tmask.mask_info_from_flat_mask(torch.from_numpy(flat), QUAD, (NP_,) * 4, e)
    loss, _ = step.loss_fn(dict(model.named_parameters()), _torch_batch(x),
                           tsc.SegTargets(*(torch.from_numpy(np.asarray(a)) for a in t)), tmi,
                           torch.from_numpy(present), 0, matched_override=torch.from_numpy(matched),
                           point_coords_override=torch.from_numpy(coords))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = params_from_jax(jgrads)
    total = float(torch.sqrt(sum(w.square().sum() for w in want.values())))
    assert float(want["backbone.input_adapters.dnw.class_emb"].abs().sum()) > 0
    for name, p in model.named_parameters():
        g, w = p.grad, want[name]
        err = float((g - w).norm())
        assert err <= 1e-4 * float(w.norm()) + 5e-8 * total, (name, err, float(w.norm()))
    # the step's class map stays an integer map through the cast
    state = tds.DownstreamState(model, opt, torch.Generator().manual_seed(0))
    opt.zero_grad()
    state, metrics = step(state, _torch_batch(x), tsc.SegTargets(*(torch.from_numpy(np.asarray(a)) for a in t)),
                          torch.from_numpy(matched), mask_info=tmi, present=torch.from_numpy(present),
                          point_coords_override=torch.from_numpy(coords), deterministic=True)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
    assert dataclasses.is_dataclass(state) and state.step == 1


def test_two_rank_fine_tuning_cli(tmp_path):
    """``cli.train_downstream`` under torchrun on 2 gloo ranks: a row each of
    the global batch of 2, the eval's dice over both, one checkpoint an
    epoch (rank 0's) in the one-device format."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_addr",
                        "127.0.0.1", "--master_port", str(free_port()), "-m",
                        "incomplete_multimodal_fusion_tpu_torch.cli.train_downstream", "--device", "cpu",
                        "--input_size", "64", "--batch_size", "2", "--num_points", "64", "--compute_dtype", "float32",
                        "--epochs", "2", "--steps_per_epoch", "1", "--eval_freq", "1", "--save_freq", "1",
                        "--output_dir", str(tmp_path)], capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "data parallel over 2 ranks (gloo), 1 rows each" in r.stdout
    losses = [float(x) for x in re.findall(r"epoch \d+: loss=(\S+)", r.stdout)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert len(re.findall(r"eval dice=", r.stdout)) == 2  # printed by rank 0 alone
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-1", "checkpoint-2"]
    saved = torch.load(tmp_path / "checkpoint-2", weights_only=True)
    model = tmf.build_maskformer(tmf.MaskFormerConfig(image_size=64, num_classes=1, num_fusion_tokens=16),
                                 device="cpu")
    assert {k: v.shape for k, v in saved["model"].items()} == {k: v.shape for k, v in model.state_dict().items()}
    assert saved["kind"] == "downstream" and saved["step"] == 2
