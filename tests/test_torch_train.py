"""The ported pretraining step against the JAX package's at the SMALL widths
of tests/test_torch_common.py, f32 compute on the CPU, with the same injected
masks on both sides:

  * the loss, each task loss, the contrastive term and the gradient of every
    parameter against ``jax.value_and_grad`` of the JAX ``make_loss_fn``
    (loss rtol 1e-5, gradients atol 2e-5), weights and gradients carried by
    ``params_from_jax``;
  * three ``train_step`` calls against the JAX loss function plus
    ``flat_adamw`` (per-step losses rtol 1e-4);
  * the kernels' autograd Functions (plain forward and backward on CPU
    tensors) against autograd of the plain forwards (atol 1e-5);
  * one bf16 step, the entry points' refusal to fall back to the CPU, and
    their refusal of EMA, which the port does not keep.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from incomplete_multimodal_fusion_tpu import config as jconfig
from incomplete_multimodal_fusion_tpu.models.multimae import build_multimae as jbuild
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.train import optim as joptim
from incomplete_multimodal_fusion_tpu.train import pretrain as jpretrain
from incomplete_multimodal_fusion_tpu.train import schedules as jsched
from incomplete_multimodal_fusion_tpu_torch import config as tconfig
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch
from incomplete_multimodal_fusion_tpu_torch.models.multimae import build_multimae
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.train import pretrain as tpretrain
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import DOMAINS, NP_, as_jax, as_torch, random_params, to_np

B, E, STEPS = 2, 24, 6
CAPACITY = NP_ * len(DOMAINS)


def _cfg(mod, compute_dtype="float32", **optim):
    """The SMALL model as a PretrainConfig of either package; the optimizer
    takes steps large enough that three of them move the loss."""
    return mod.PretrainConfig(
        model=mod.ModelConfig(dim_tokens=64, depth=2, dim_head=16, heads=2, ff_mult=4,
                              num_fusion_tokens=16),
        data=mod.DataConfig(input_size=64, patch_size=16, batch_size=B),
        mask=mod.MaskConfig(num_encoded_tokens=E),
        decoder=mod.DecoderConfig(dim=32, depth=2, num_heads=2),
        optim=mod.OptimConfig(blr=1.0, warmup_epochs=0, min_lr=1e-4, **optim),
        train=mod.TrainConfig(epochs=1, compute_dtype=compute_dtype))


def _flat_masks(seed):
    """[B, N] masks with exactly E visible tokens; row 1 sees no s2 token,
    so its s2 pools and losses take the empty-modality branches."""
    rng = np.random.default_rng(seed)
    flat = np.ones((B, CAPACITY), np.int64)
    flat[0, rng.permutation(CAPACITY)[:E]] = 0
    others = np.r_[0:NP_, 2 * NP_:3 * NP_]
    flat[1, rng.permutation(others)[:E]] = 0
    return flat


def _mask_infos(seed):
    flat = _flat_masks(seed)
    return (jmask.mask_info_from_flat_mask(jnp.asarray(flat), DOMAINS, (NP_,) * 3, E),
            tmask.mask_info_from_flat_mask(torch.from_numpy(flat), DOMAINS, (NP_,) * 3, E))


@pytest.fixture(scope="module")
def setup():
    batch = synthetic_batch(np.random.default_rng(0), DOMAINS, B, 64)
    jcfg = _cfg(jconfig)
    jm = jbuild(jcfg)
    params = random_params(jm, 1, as_jax(batch), jmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, B),
                           CAPACITY)
    loss_fn = jpretrain.make_loss_fn(jm, jcfg)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b, mi: loss_fn(p, {}, b, mi, jax.random.PRNGKey(0)), has_aux=True))
    return batch, params, value_and_grad


def _port(cfg, params):
    model, state, optimizer = tpretrain.create_train_state(cfg, 0, total_steps=STEPS, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model, state, optimizer


def _port_grads(model, cfg, batch, mi):
    model.zero_grad(set_to_none=True)
    loss, metrics = tpretrain.make_loss_fn(model, cfg)(dict(model.named_parameters()),
                                                       as_torch(batch), mi)
    loss.backward()
    grads = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    return metrics, grads


def test_loss_and_every_gradient_match_jax(setup):
    batch, params, value_and_grad = setup
    jmi, tmi = _mask_infos(3)
    (jloss, jmetrics), jgrads = value_and_grad(params, as_jax(batch), jmi)
    cfg = _cfg(tconfig)
    model, _, _ = _port(cfg, params)
    metrics, grads = _port_grads(model, cfg, batch, tmi)
    for key in ("loss", "contra_loss", "recon_loss", "s1_loss", "s2_loss", "dem_loss"):
        np.testing.assert_allclose(float(metrics[key].detach()), float(jmetrics[key]), rtol=1e-5,
                                   err_msg=key)
    want = params_from_jax(jgrads)
    assert set(want) == set(grads)
    for name, g in want.items():
        np.testing.assert_allclose(to_np(grads[name]), g.numpy(), atol=2e-5, rtol=0, err_msg=name)
    # the gradient reaches the input adapters (through the pack gather), the
    # mask embedding (through the KV grid's where) and the student pool's
    # token; the teacher pool (return_tokens) is stopped, on both sides
    for name in ("input_adapters.s2.proj.weight", "mask_embedding", "return_token_s1"):
        assert grads[name].abs().sum() > 0, name
    assert not grads["return_tokens"].any()


def test_three_train_steps_match_jax(setup):
    """``train_step`` with injected masks against the JAX loss function and
    ``flat_adamw`` with the schedules ``create_train_state`` builds."""
    batch, params, value_and_grad = setup
    jcfg = _cfg(jconfig)
    o = jcfg.optim
    lr = jsched.cosine_scheduler(jsched.scaled_lr(o.blr, B), o.min_lr, STEPS, warmup_steps=0,
                                 start_warmup_value=o.warmup_lr)
    wd = jsched.cosine_scheduler(o.weight_decay, o.weight_decay, STEPS)
    tx = joptim.flat_adamw(params, lr, wd, betas=o.opt_betas, eps=o.opt_eps)
    opt_state, jp = tx.init(params), params
    cfg = _cfg(tconfig)
    model, state, optimizer = _port(cfg, params)
    step = tpretrain.make_train_step(model, cfg, optimizer)
    jlosses, tlosses = [], []
    for k in range(3):
        jmi, tmi = _mask_infos(10 + k)
        (jloss, _), g = value_and_grad(jp, as_jax(batch), jmi)
        upd, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        jlosses.append(float(jloss))
        state, metrics = step(state, batch, mask_info=tmi)
        tlosses.append(float(metrics["loss"]))
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(g)),
                                   rtol=1e-4)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert state.step == optimizer.count == 3
    assert len(set(np.round(tlosses, 4))) == 3  # the steps moved the loss


def test_kernel_functions_match_autograd_of_plain_forwards(setup):
    """attn_impl='auto' (the kernels' Functions, plain forward and backward
    on CPU tensors) against 'xla' (autograd differentiates the plain
    forwards): the same loss and gradients."""
    batch, params, _ = setup
    _, tmi = _mask_infos(4)
    cfg = _cfg(tconfig)
    model, _, _ = _port(cfg, params)
    metrics_k, grads_k = _port_grads(model, cfg, batch, tmi)
    model.attn_impl = "xla"
    metrics_p, grads_p = _port_grads(model, cfg, batch, tmi)
    np.testing.assert_allclose(float(metrics_k["loss"].detach()), float(metrics_p["loss"].detach()), rtol=1e-6)
    for name in grads_p:
        np.testing.assert_allclose(to_np(grads_k[name]), to_np(grads_p[name]), atol=1e-5, rtol=0,
                                   err_msg=name)


def test_one_bf16_step_on_cpu(setup):
    batch, params, _ = setup
    cfg = _cfg(tconfig, compute_dtype="bfloat16")
    model, state, optimizer = _port(cfg, params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = tpretrain.make_train_step(model, cfg, optimizer)(state, batch)
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())  # the masters stay f32
    assert any(not torch.equal(before[n], p) for n, p in model.named_parameters())


def test_random_masks_come_from_the_state_generator():
    """Without ``mask_info`` the step draws exactly E visible tokens from
    the state's generator: two states with the same seed take equal steps."""
    cfg = _cfg(tconfig)
    batch = synthetic_batch(np.random.default_rng(1), DOMAINS, B, 64)
    losses = []
    for _ in range(2):
        model, state, optimizer = tpretrain.create_train_state(cfg, 7, total_steps=STEPS,
                                                               device="cpu")
        step = tpretrain.make_train_step(model, cfg, optimizer)
        losses.append([float(step(state, batch)[1]["loss"]) for _ in range(2)])
    assert losses[0] == losses[1]


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(tconfig)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_multimae(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpretrain.create_train_state(cfg, 0, total_steps=STEPS)
    assert next(build_multimae(cfg, device="cpu").parameters()).device.type == "cpu"


def test_ema_is_refused_not_dropped():
    cfg = _cfg(tconfig)
    ema_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_ema=True))
    with pytest.raises(NotImplementedError, match="use_ema"):
        tpretrain.create_train_state(ema_cfg, 0, total_steps=STEPS, device="cpu")
    model, _, optimizer = tpretrain.create_train_state(cfg, 0, total_steps=STEPS, device="cpu")
    with pytest.raises(NotImplementedError, match="use_ema"):
        tpretrain.make_train_step(model, ema_cfg, optimizer)
    tpretrain.make_train_step(model, cfg, optimizer)  # without EMA the step builds


def test_uncertainty_balancer_is_not_ported():
    cfg = _cfg(tconfig, task_balancer="uncertainty")
    model = build_multimae(_cfg(tconfig), device="cpu")
    with pytest.raises(NotImplementedError, match="uncertainty"):
        tpretrain.make_loss_fn(model, cfg)
