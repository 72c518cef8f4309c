"""The port's optimizer and schedules against the JAX package's
(train/optim.py ``flat_adamw`` and ``wd_mask``, train/schedules.py), on the
same numpy parameters and gradients, f32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from incomplete_multimodal_fusion_tpu.models.multimae import MultiMAE as JaxMultiMAE
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.train import optim as joptim
from incomplete_multimodal_fusion_tpu.train import schedules as jsched
from incomplete_multimodal_fusion_tpu_torch.models.multimae import MultiMAE as TorchMultiMAE
from incomplete_multimodal_fusion_tpu_torch.train import optim as toptim
from incomplete_multimodal_fusion_tpu_torch.train import schedules as tsched
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import NP_, SMALL, as_jax, random_params

# a small tree with every kind of leaf the no-decay rules tell apart:
# Dense kernels (decay), biases and gammas (ndim 1), token parameters named
# in NO_DECAY_NAMES
SHAPES = {
    "block0": {"attn": {"to_q": {"kernel": (8, 6)}}, "norm1": {"gamma": (8,)}},
    "mlp": {"fc1": {"kernel": (8, 16), "bias": (16,)}},
    "fusion_tokens": (1, 3, 8),
    "output_adapter_s1": {"task_emb": (1, 1, 8)},
}


def _tree(rng, scale):
    return jax.tree.map(lambda s: (scale * rng.standard_normal(s)).astype(np.float32), SHAPES,
                        is_leaf=lambda s: isinstance(s, tuple))


LR = dict(base_value=1e-2, final_value=1e-3, total_steps=10, warmup_steps=2,
          start_warmup_value=1e-4)
WD = dict(base_value=0.05, final_value=0.1, total_steps=10)


@pytest.mark.parametrize("clip,skip", [(None, None), (0.5, None), (None, 5.0), (0.5, 5.0)])
def test_flat_adamw_matches_jax_over_three_updates(clip, skip):
    """Three updates from the same gradients; with ``skip`` the second
    gradient is large enough that the whole update (parameters, moments,
    count) is skipped."""
    rng = np.random.default_rng(0)
    params = _tree(rng, 0.1)
    grads = [_tree(rng, 0.3) for _ in range(3)]
    if skip is not None:
        grads[1] = jax.tree.map(lambda g: g * 100.0, grads[1])

    tx = joptim.flat_adamw(as_jax(params), jsched.cosine_scheduler(**LR),
                           jsched.cosine_scheduler(**WD), clip_grad=clip, skip_grad=skip)
    jp = as_jax(params)
    state = tx.init(jp)
    norms = []
    for g in grads:
        norms.append(float(optax.global_norm(as_jax(g))))
        upd, state = tx.update(as_jax(g), state, jp)
        jp = optax.apply_updates(jp, upd)

    named = {k: torch.nn.Parameter(v) for k, v in params_from_jax(params).items()}
    opt = toptim.create_optimizer(named.items(), tsched.cosine_scheduler(**LR),
                                  tsched.cosine_scheduler(**WD), clip_grad=clip, skip_grad=skip)
    for g, norm in zip(grads, norms):
        for k, v in params_from_jax(g).items():
            named[k].grad = v
        np.testing.assert_allclose(float(opt.step()), norm, rtol=1e-6)

    assert opt.count == int(state.count) == (2 if skip is not None else 3)
    for k, v in params_from_jax(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(named[k].detach().numpy(), v.numpy(), atol=1e-7, rtol=0,
                                   err_msg=k)


def test_wd_mask_matches_jax_name_by_name():
    """The decay mask over the whole SMALL model: the JAX ``wd_mask`` tree,
    carried to port names by ``params_from_jax``, equals the port's
    ``wd_mask`` over its named parameters."""
    jm = JaxMultiMAE(attn_impl="auto", **SMALL)
    x = {d: np.zeros((1, 64, 64, c), np.float32) for d, c in zip(("s1", "s2", "dem"), (1, 3, 1))}
    mi = jmask.full_visible_mask_info(("s1", "s2", "dem"), (NP_,) * 3, 1)
    params = random_params(jm, 0, as_jax(x), mi, 3 * NP_)
    want = {k: bool(v) for k, v in params_from_jax(joptim.wd_mask(params)).items()}
    got = toptim.wd_mask(TorchMultiMAE(**SMALL).named_parameters())
    assert got == want
    assert any(got.values()) and not all(got.values())


@pytest.mark.parametrize("step", [0, 1, 4, 5, 6, 20, 99, 100, 150])
def test_cosine_scheduler_matches_jax(step):
    """Warmup, the warmup/cosine boundary (step 5), the end and past it."""
    kw = dict(base_value=1.5e-4, final_value=1e-6, total_steps=100, warmup_steps=5,
              start_warmup_value=1e-7)
    np.testing.assert_allclose(tsched.cosine_scheduler(**kw)(step),
                               float(jsched.cosine_scheduler(**kw)(step)), rtol=1e-6)


def test_scaled_lr_matches_jax():
    assert tsched.scaled_lr(1e-4, 60) == jsched.scaled_lr(1e-4, 60)
