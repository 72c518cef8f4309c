"""The full decoder's and the quadruplet's pretraining steps against the
JAX package's (tests/test_torch_variants_train.py's comparison, its bounds),
and the layer-wise LR decay: the scales from the port's names through
``flax_path`` against JAX ``layer_decay_scales`` leaf for leaf, and
FlatAdamW's update with them against ``flat_adamw``'s."""
import jax
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu import config as jconfig
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.train import optim as joptim
from incomplete_multimodal_fusion_tpu.train import pretrain as jpretrain
from incomplete_multimodal_fusion_tpu_torch.train import optim as toptim
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import flax_path, params_from_jax
from tests.test_torch_common import as_jax, random_params, to_np
from tests.test_torch_variants import NP_, TRIPLE, B, batch
from tests.test_torch_variants_train import HERE, MODES, _cfg, three_steps_match_jax


@pytest.mark.parametrize("name", [m for m in MODES if m not in HERE])
def test_three_steps_match_jax(name):
    three_steps_match_jax(name)


def _jax_small_params(mode):
    cfg = _cfg(jconfig, mode, "simple", TRIPLE)
    model = jpretrain.build_multimae(cfg)
    x = batch(TRIPLE, 0)
    mi = jmask.full_visible_mask_info(TRIPLE, (NP_,) * 3, B)
    return random_params(model, 5, as_jax(x), mi, 3 * NP_)


@pytest.mark.parametrize("mode", ["crossattn", "lstm"])
def test_layer_decay_scales_match_jax(mode):
    """Each parameter's scale from the port's name through flax_path equals
    JAX's for the same leaf; the flax paths' first keys are the tree's."""
    params = _jax_small_params(mode)
    want = params_from_jax(joptim.layer_decay_scales(jax.tree.map(np.asarray, params), 2, 0.75))
    named = [(n, torch.zeros(())) for n in params_from_jax(params)]
    got = toptim.layer_decay_scales(named, 2, 0.75)
    assert set(got) == set(want)
    for n in got:
        assert np.float32(got[n]) == float(want[n]), n
    heads = {str(getattr(p[0], "key", p[0])) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert {flax_path(n).split("/")[0] for n in got} == heads
    assert {toptim.get_num_layer_for_vit(flax_path(n), 2) for n in got} == {0, 1, 2, 3}


def test_flat_adamw_with_layer_decay_matches_jax():
    """Three FlatAdamW updates with layer_decay 0.75 against flat_adamw's
    on the same gradients (rtol 1e-5): the scales multiply the update
    after the weight decay, in the flat buffer."""
    params = _jax_small_params("crossattn")
    rng = np.random.default_rng(9)
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params) for _ in range(3)]

    def lr(step):
        return 1e-2 * (1.0 + 0 * step)

    def wd(step):
        return 0.05 + 0 * step

    tx = joptim.create_optimizer(params, lr, wd, layer_decay=0.75, num_layers=2, fused=True)
    opt_state, jp = tx.init(params), params
    for g in grads:
        upd, opt_state = tx.update(g, opt_state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
    tparams = {n: torch.nn.Parameter(v.clone()) for n, v in params_from_jax(params).items()}
    opt = toptim.create_optimizer(tparams.items(), torch.full((4,), 1e-2), torch.full((4,), 0.05),
                                  layer_decay=0.75, num_layers=2)
    assert opt.lr_scale is not None and float(opt.lr_scale.min()) == pytest.approx(0.75 ** 3)
    for g in grads:
        for n, v in params_from_jax(g).items():
            tparams[n].grad = v
        opt.step()
    for n, want in params_from_jax(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(to_np(tparams[n]), to_np(want), rtol=1e-5, atol=1e-7, err_msg=n)
    scaled = toptim.scale_by_layer_decay({"blocks.0.attn.to_q.weight": torch.ones(2)},
                                         toptim.layer_decay_scales([("blocks.0.attn.to_q.weight", None)], 2, 0.5))
    assert torch.equal(scaled["blocks.0.attn.to_q.weight"], torch.full((2,), 0.25))
