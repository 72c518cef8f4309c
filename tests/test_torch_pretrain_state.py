"""The port's whole pretraining state against the JAX package's, at the SMALL
widths of tests/test_torch_train.py, f32 compute on the CPU, the same
injected masks on both sides:

  * three steps with ``task_balancer='uncertainty'`` and ``use_ema=True``
    against JAX ``create_train_state`` / ``make_train_step``
    (``fused_adamw=True``): per-step losses rtol 1e-4, then the masters,
    FlatAdamW's moments and the EMA within relative L2 1e-4 a tensor (Adam
    divides each gradient element by its own scale, so an element whose
    gradient is near zero may take a step of a different size in the two
    frameworks), the balancer's log-variances and moments rtol 1e-4 and the
    counts exactly. The key third of the decoder's qkv bias is left out of
    the masters and the EMA: its gradient is zero in exact arithmetic (the
    softmax over keys is shift-invariant per query), so Adam turns the
    rounding noise there into steps of size lr whose signs neither framework
    decides;
  * a step whose gradient norm reaches ``skip_grad`` leaves the masters,
    ``mu``, ``nu`` and ``count`` bitwise unchanged (JAX optim.py:196-201)
    while the balancer and the EMA still move, as in JAX;
  * the optimizer reads lr and wd from device tables and its step syncs
    with no host;
  * the balancer and the EMA alone against JAX's;
  * ``make_multi_step`` on the CPU is bitwise K sequential steps, the
    generator included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from incomplete_multimodal_fusion_tpu import config as jconfig
from incomplete_multimodal_fusion_tpu.losses import balancing as jbal
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.train import ema as jema
from incomplete_multimodal_fusion_tpu.train import pretrain as jpretrain
from incomplete_multimodal_fusion_tpu_torch import config as tconfig
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch
from incomplete_multimodal_fusion_tpu_torch.losses import balancing as tbal
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.train import ema as tema
from incomplete_multimodal_fusion_tpu_torch.train import pretrain as tpretrain
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import DOMAINS, NP_, as_jax, random_params, to_np
from tests.test_torch_train import B, CAPACITY, E, STEPS, _flat_masks

EMA_DECAY = 0.5  # large enough that three steps move the shadow visibly


def _cfg(mod, **optim):
    """The SMALL model with the balancer and the EMA."""
    return mod.PretrainConfig(
        model=mod.ModelConfig(dim_tokens=64, depth=2, dim_head=16, heads=2, ff_mult=4,
                              num_fusion_tokens=16),
        data=mod.DataConfig(input_size=64, patch_size=16, batch_size=B),
        mask=mod.MaskConfig(num_encoded_tokens=E),
        decoder=mod.DecoderConfig(dim=32, depth=2, num_heads=2),
        optim=mod.OptimConfig(blr=1.0, warmup_epochs=0, min_lr=1e-4, task_balancer="uncertainty",
                              balancer_lr_scale=2.0, fused_adamw=True, **optim),
        train=mod.TrainConfig(epochs=1, compute_dtype="float32", use_ema=True, ema_decay=EMA_DECAY))


def _port_state(cfg, params):
    model, state, optimizer = tpretrain.create_train_state(cfg, 0, total_steps=STEPS, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    state.ema = tema.init_ema(model.named_parameters())
    return model, state, optimizer


def _torch_mask_info(flat):
    return tmask.mask_info_from_flat_mask(torch.from_numpy(flat), DOMAINS, (NP_,) * 3, E)


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps from random_params with injected masks: the JAX step
    draws its masks through masking.generate_random_masks, which is patched
    here to read the mask this call passes in."""
    batch = synthetic_batch(np.random.default_rng(0), DOMAINS, B, 64)
    jcfg = _cfg(jconfig)
    model, state, tx = jpretrain.create_train_state(jcfg, jax.random.PRNGKey(0), STEPS)
    params = random_params(model, 1, as_jax(batch), jmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, B),
                           CAPACITY)
    state = state.replace(params=params, ema_params=jema.init_ema(params))
    held = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jpretrain.masking, "generate_random_masks",
               lambda *a, **k: jmask.mask_info_from_flat_mask(held["flat"], DOMAINS, (NP_,) * 3, E))
    raw = jpretrain.make_train_step(model, jcfg, tx)

    @jax.jit
    def step(state, batch, flat):
        held["flat"] = flat
        return raw(state, batch)

    states, metrics = [state], []
    try:
        for k in range(3):
            state, m = step(state, as_jax(batch), jnp.asarray(_flat_masks(10 + k)))
            states.append(state)
            metrics.append(jax.tree.map(np.asarray, m))
    finally:
        mp.undo()
    return batch, params, states, metrics


def _jax_flat_to_port(vec, params):
    """A JAX flat vector (ravel order, padded) as the port's flat order."""
    _, unravel = ravel_pytree(params)
    n = sum(int(np.size(x)) for x in jax.tree.leaves(params))
    return params_from_jax(unravel(jnp.asarray(vec[:n])))


def _split_port(vec, model):
    sizes = [p.numel() for p in model.parameters()]
    return {n: v.view_as(p) for (n, p), v in zip(model.named_parameters(), vec.split(sizes))}


def test_three_steps_with_balancer_and_ema_match_jax(jax_run):
    batch, params, jstates, jmetrics = jax_run
    cfg = _cfg(tconfig)
    model, state, optimizer = _port_state(cfg, params)
    step = tpretrain.make_train_step(model, cfg, optimizer)
    for k in range(3):
        state, metrics = step(state, batch, mask_info=_torch_mask_info(_flat_masks(10 + k)))
        for key in ("loss", "recon_loss", "contra_loss", "s1_loss", "s2_loss", "dem_loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[k][key]), rtol=1e-4,
                                       err_msg=f"step {k}: {key}")
    final = jstates[-1]
    assert state.step == int(final.step) == 3
    assert int(optimizer.count) == int(final.opt_state.count) == 3
    assert int(state.balancer_optimizer.count) == 3

    def close(got, want, what):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, err_msg=what)

    def rel_l2(got, want, what):
        got, want = to_np(got).astype(np.float64), np.asarray(want, np.float64)
        if what.endswith("attn.qkv.bias"):
            third = want.shape[0] // 3
            got, want = np.delete(got, np.s_[third:2 * third]), np.delete(want, np.s_[third:2 * third])
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= 1e-4, f"{what}: relative L2 {err}"

    for name, want in params_from_jax(jax.tree.map(np.asarray, final.params)).items():
        rel_l2(dict(model.named_parameters())[name], want, name)
    for name, want in params_from_jax(jax.tree.map(np.asarray, final.ema_params)).items():
        rel_l2(state.ema[name], want, f"ema {name}")
    for moment in ("mu", "nu"):
        want = _jax_flat_to_port(np.asarray(getattr(final.opt_state, moment)), params)
        got = _split_port(getattr(optimizer, moment), model)
        for name in want:
            if name != "return_tokens":  # its gradient is stopped: zero moments on both sides
                rel_l2(got[name], want[name], f"{moment} {name}")
    # the balancer: log-variances and their AdamW moments (optax.adamw's
    # ScaleByAdamState inside inject_hyperparams)
    adam = final.bal_opt_state.inner_state[0]
    for i, t in enumerate(DOMAINS):
        close(state.balancer_params[t], final.balancer_params[t], f"log_var {t}")
        close(state.balancer_optimizer.mu[i], adam.mu[t], f"balancer mu {t}")
        close(state.balancer_optimizer.nu[i], adam.nu[t], f"balancer nu {t}")
        assert float(state.balancer_params[t].detach()) != 0.0  # the log-variances moved
    name = "blocks.0.attn.to_q.weight"  # the EMA moved off its start
    assert not torch.equal(state.ema[name], params_from_jax(params)[name])


def test_skip_leaves_masters_and_moments_bitwise_unchanged(jax_run):
    """skip_grad below the first step's gradient norm: the model's update is
    skipped whole, while the balancer's group (no skip) and the EMA move, as
    in JAX (pretrain.py:277-298)."""
    batch, params, _, jmetrics = jax_run
    cfg = _cfg(tconfig, skip_grad=float(jmetrics[0]["grad_norm"]) / 2)
    model, state, optimizer = _port_state(cfg, params)
    step = tpretrain.make_train_step(model, cfg, optimizer)
    optimizer.skip_grad = None  # a real update first, so there are moments to keep
    state, _ = step(state, batch, mask_info=_torch_mask_info(_flat_masks(10)))
    optimizer.skip_grad = cfg.optim.skip_grad
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = {k: v.clone() for k, v in optimizer.state_dict().items()}
    ema_before = {n: v.clone() for n, v in state.ema.items()}
    log_var = {t: v.detach().clone() for t, v in state.balancer_params.items()}
    for k in (11, 12):
        state, metrics = step(state, batch, mask_info=_torch_mask_info(_flat_masks(k)))
        assert float(metrics["grad_norm"]) >= cfg.optim.skip_grad
    for n, p in model.named_parameters():
        assert torch.equal(p.detach().view(torch.int32), before[n].view(torch.int32)), n
    for k, v in optimizer.state_dict().items():
        if v.is_floating_point():
            v, moments[k] = v.view(torch.int32), moments[k].view(torch.int32)
        assert torch.equal(v, moments[k]), k
    assert int(optimizer.count) == 1 and state.step == 3
    assert int(state.balancer_optimizer.count) == 3
    assert all(not torch.equal(state.balancer_params[t], log_var[t]) for t in log_var)
    # the EMA goes on pulling toward the (unchanged) masters
    assert any(not torch.equal(state.ema[n], ema_before[n]) for n in ema_before)


def test_step_reads_device_tables_and_never_syncs(monkeypatch, jax_run):
    """lr and wd come from f32 tables indexed by the device count; nothing
    in the step reads a tensor back to the host."""
    batch, params, _, _ = jax_run
    cfg = _cfg(tconfig, skip_grad=1e9, clip_grad=1.0)
    model, state, optimizer = _port_state(cfg, params)
    assert optimizer.lr_table.dtype == torch.float32 and optimizer.lr_table.numel() == STEPS + 1
    assert optimizer.count.dim() == 0 and optimizer.count.dtype == torch.int64
    np.testing.assert_allclose(to_np(state.balancer_optimizer.lr_table),
                               to_np(optimizer.lr_table) * cfg.optim.balancer_lr_scale, rtol=1e-7)
    step = tpretrain.make_train_step(model, cfg, optimizer)
    mi = _torch_mask_info(_flat_masks(10))

    def refuse(*args, **kwargs):
        raise AssertionError("host sync in the step")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    state, metrics = step(state, batch, mask_info=mi)
    monkeypatch.undo()
    assert int(optimizer.count) == 1 and np.isfinite(float(metrics["loss"]))


def test_uncertainty_weighting_matches_jax():
    rng = np.random.default_rng(5)
    losses = {"a": np.float32(0.7), "b": np.float32(0.0), "c": np.float32(2.5)}
    log_var = {t: np.float32(v) for t, v in zip(losses, rng.standard_normal(3))}
    want = jbal.uncertainty_weighting({t: jnp.asarray(v) for t, v in losses.items()},
                                      {t: jnp.asarray(v) for t, v in log_var.items()})
    got = tbal.uncertainty_weighting({t: torch.tensor(v) for t, v in losses.items()},
                                     {t: torch.tensor(v) for t, v in log_var.items()})
    for t in losses:
        np.testing.assert_allclose(float(got[t]), float(want[t]), rtol=1e-6, err_msg=t)
    assert float(got["b"]) == 0.0  # zero-loss masking
    init = tbal.init_uncertainty_params(("a", "b"))
    assert all(v.requires_grad and v.dim() == 0 and float(v) == 0.0 for v in init.values())


def test_ema_matches_jax_and_is_a_copy():
    rng = np.random.default_rng(6)
    p0 = {"w": rng.standard_normal((3, 4)).astype(np.float32), "b": rng.standard_normal(4).astype(np.float32)}
    p1 = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
    want = jema.update_ema(jema.init_ema(as_jax(p0)), as_jax(p1), 0.9)
    params0 = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    ema = tema.init_ema(params0.items())
    assert all(ema[k].data_ptr() != params0[k].data_ptr() for k in ema)
    ptrs = {k: v.data_ptr() for k, v in ema.items()}
    tema.update_ema(ema, {k: torch.from_numpy(v) for k, v in p1.items()}, 0.9)
    assert {k: v.data_ptr() for k, v in ema.items()} == ptrs  # in place
    for k in p0:
        np.testing.assert_allclose(to_np(ema[k]), np.asarray(want[k]), rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("k", [1, 3])
def test_multi_step_on_cpu_is_k_sequential_steps(k):
    """From equal states, ``make_multi_step`` (masks drawn from the state's
    generator) and k ``train_step`` calls give bitwise equal masters,
    moments, balancer, EMA, generator state and metrics."""
    cfg = _cfg(tconfig)
    rng = np.random.default_rng(9)
    batches = [synthetic_batch(rng, DOMAINS, B, 64) for _ in range(k)]
    stacked = {d: np.stack([b[d] for b in batches]) for d in DOMAINS}
    runs = []
    for multi in (False, True):
        model, state, optimizer = tpretrain.create_train_state(cfg, 3, total_steps=STEPS, device="cpu")
        step = tpretrain.make_train_step(model, cfg, optimizer)
        if multi:
            state, metrics = tpretrain.make_multi_step(step, k)(state, stacked)
        else:
            ms = [step(state, b)[1] for b in batches]
            metrics = {name: torch.stack([m[name] for m in ms]) for name in ms[0]}
        runs.append((state, metrics))
    (a, ma), (b, mb) = runs
    assert a.step == b.step == k
    assert set(ma) == set(mb) and all(mb[n].shape == (k,) for n in mb)
    for n in ma:
        assert torch.equal(ma[n], mb[n]), n
    for x, y in zip(a.tensors(), b.tensors()):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_multi_step_takes_injected_masks():
    cfg = dataclasses.replace(_cfg(tconfig), optim=dataclasses.replace(_cfg(tconfig).optim, task_balancer="none"))
    batch = synthetic_batch(np.random.default_rng(2), DOMAINS, B, 64)
    stacked = {d: np.stack([batch[d]] * 2) for d in DOMAINS}
    mis = [_torch_mask_info(_flat_masks(20 + i)) for i in range(2)]
    model, state, optimizer = tpretrain.create_train_state(cfg, 3, total_steps=STEPS, device="cpu")
    g_before = state.generator.get_state()
    state, metrics = tpretrain.make_multi_step(tpretrain.make_train_step(model, cfg, optimizer), 2)(
        state, stacked, mask_infos=mis)
    assert torch.equal(state.generator.get_state(), g_before)  # no draw when the masks are given
    assert metrics["loss"].shape == (2,) and state.balancer_optimizer is None and state.ema is not None
    with pytest.raises(ValueError, match="task_balancer"):
        bad = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, task_balancer="gradnorm"))
        tpretrain.create_train_state(bad, 0, total_steps=STEPS, device="cpu")
