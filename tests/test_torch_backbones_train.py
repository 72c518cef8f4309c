"""One downstream training step of the ported MaskFormer on the ViT
backbones other than 'vit' crossattn with the Mask2Former decoder --
'vit_adapter', 'sup' and the 'standard' decoder -- against the JAX package
(tests/test_torch_downstream_train.py's procedure at
tests/test_torch_backbones_model.py's size: image 64, dim 32, depth 4; f32
on the CPU, dropout off, the same modality subset, masks, matches and
PointRend points on both sides): the loss to 1e-5 relative and every
parameter's gradient to rel-L2 1e-4 against ``jax.value_and_grad``; at
bf16 compute the loss within 2e-2 of JAX's bf16 loss. The CNN backbones
are in tests/test_torch_backbones_train_cnn.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.models import maskformer as jmf
from incomplete_multimodal_fusion_tpu_torch.models import maskformer as tmf
from incomplete_multimodal_fusion_tpu_torch.train import downstream as tds
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_backbones_model import cfg_of
from tests.test_torch_common import as_jax, random_params
from tests.test_torch_downstream import _sharpen_masks
from tests.test_torch_downstream_train import P, _inputs, _jax_loss, _jax_step_args, _port_step_args, _targets

FROZEN = 1


def step_pair(name, dtype=jnp.float32):
    """(JAX loss value_and_grad (or loss), flax params, port model and step,
    inputs, targets) of a variant."""
    cfg = cfg_of(name, frozen_stages=FROZEN)
    jm = jmf.MaskFormerModel(jmf.MaskFormerConfig(**cfg))
    x = _inputs(1)
    params = _sharpen_masks(random_params(jm, 44, as_jax(x)))
    loss = _jax_loss(jm, jm.cfg.max_encoded_tokens, dtype)
    return (jax.jit(jax.value_and_grad(loss) if dtype == jnp.float32 else loss), params, x, _targets(3),
            tmf.MaskFormerConfig(**cfg))


def port_step(params, cfg, compute_dtype="float32"):
    model = tmf.build_maskformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    opt = tds.create_downstream_optimizer(model, lr=1e-3, clip_grad=0.01, frozen_stages=FROZEN)
    return model, tds.make_downstream_train_step(model, cfg, opt, num_points=P, compute_dtype=compute_dtype)


def assert_every_gradient(model, jgrads):
    """Each parameter's gradient within rel-L2 1e-4 of its own norm, plus
    1e-7 of the global norm for the gradients that are zero in exact
    arithmetic: the biases ahead of a GroupNorm whose groups hold one
    channel (the pixel decoder's at conv_dim 32, the pyramid's up1 at dim
    32), whose f32 rounding follows the global scale (5e-8 of it in 'sup')."""
    want = params_from_jax(jgrads)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(want) == set(grads)
    total = float(torch.sqrt(sum(w.square().sum() for w in want.values())))
    for name, g in want.items():
        got = grads[name]
        assert got is not None, name
        err = float((got - g).norm())
        assert err <= 1e-4 * float(g.norm()) + 1e-7 * total, (name, err, float(g.norm()), total)
    return grads


def check_loss_and_every_gradient(name, nonzero):
    """The step's loss and every gradient against JAX's; ``nonzero``: the
    parameters whose gradient must not vanish (the path reaches them)."""
    value_and_grad, params, x, t, cfg = step_pair(name)
    jloss, jgrads = value_and_grad(params, *_jax_step_args(x, t, 4))
    model, step = port_step(params, cfg)
    batch, targets, mi, present, matched, coords = _port_step_args(x, t, 4)
    loss, _ = step.loss_fn(dict(model.named_parameters()), batch, targets, mi, present, 0,
                           matched_override=matched, point_coords_override=coords)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = assert_every_gradient(model, jgrads)
    for n in nonzero:
        assert float(grads[n].abs().sum()) > 0, n


def check_bf16_loss(name):
    loss_fn, params, x, t, cfg = step_pair(name, jnp.bfloat16)
    jloss = loss_fn(params, *_jax_step_args(x, t, 20))
    model, step = port_step(params, cfg, "bfloat16")
    batch, targets, mi, present, matched, coords = _port_step_args(x, t, 20)
    with torch.no_grad():
        loss, _ = step.loss_fn(dict(model.named_parameters()), batch, targets, mi, present, 0,
                               matched_override=matched, point_coords_override=coords)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)


NONZERO = {
    # the priors' module, an injector's gamma and sampling kernels, an
    # extractor: K4's backward inside the backbone reaches them
    "vit_adapter": ["backbone.spm.stem1.weight", "backbone.injector0.gamma",
                    "backbone.injector1.attn.sampling_offsets.weight",
                    "backbone.extractor0.attn.value_proj.weight", "backbone.adapter_level_embed",
                    "backbone.adapter_up.weight"],
    "sup": ["backbone.return_tokens", "backbone.attn_pool.to_kv.weight", "backbone.blocks.0.attn.to_q.weight",
            "backbone.input_adapters.s2.proj.weight"],
    "vit standard": ["predictor.query_embed", "predictor.dec0.multihead_attn.k_proj.weight",
                     "backbone.fusion_tokens"],
}


@pytest.mark.parametrize("name", list(NONZERO))
def test_loss_and_every_gradient_match_jax(name):
    check_loss_and_every_gradient(name, NONZERO[name])


@pytest.mark.parametrize("name", ["vit_adapter", "sup"])
def test_bf16_loss_near_jax_bf16_loss(name):
    check_bf16_loss(name)
