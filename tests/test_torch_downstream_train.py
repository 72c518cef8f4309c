"""The ported downstream training step (train/downstream.py, the train-time
masking of ops/masking.py, the evaluation metrics) against the JAX package,
on the small MaskFormer of tests/test_torch_downstream.py (image 64, dim 32,
depth 2, 10 queries, 3 decoder layers: 4 prediction levels), f32 on the CPU,
dropout off, with the same modality subset, masks, matches and PointRend
points injected on both sides:

  * the loss to 1e-5 relative and every parameter's gradient (rel-L2 1e-4)
    against
    ``jax.value_and_grad`` of a JAX loss built from
    ``MaskFormerModel.apply(deterministic=True)`` + ``set_criterion``,
    weighted as downstream.py:213-221;
  * three steps of ``make_downstream_train_step`` against that loss plus
    ``create_downstream_optimizer``'s optax chain (AdamW, clip 0.01, frozen
    stages);
  * at ``compute_dtype='bfloat16'`` the loss within 2e-2 relative of JAX's
    bf16 loss (bf16 rounds at other places in the two frameworks);
  * the semantic step (``dense_masks=True``) with 'exact', 'greedy' and
    'auction' matching: each level assigned as JAX's ``hungarian_match``
    assigns the same costs, then the loss and every gradient against JAX's
    dense criterion with those matches, and three dense steps against the
    optax chain;
  * the freeze mask, the optimizer alone over random gradients (to 1e-6),
    ReduceLROnPlateau, label maps, the pretrained-backbone copy, the
    masking invariants, dice, ConfMatrix and the eval steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from incomplete_multimodal_fusion_tpu import config as jconfig
from incomplete_multimodal_fusion_tpu.eval import metrics as jmetrics
from incomplete_multimodal_fusion_tpu.losses import set_criterion as jsc
from incomplete_multimodal_fusion_tpu.models import maskformer as jmf
from incomplete_multimodal_fusion_tpu.models.multimae import build_multimae as jbuild_multimae
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.train import downstream as jds
from incomplete_multimodal_fusion_tpu_torch.eval import metrics as tmetrics
from incomplete_multimodal_fusion_tpu_torch.losses import set_criterion as tsc
from incomplete_multimodal_fusion_tpu_torch.models import maskformer as tmf
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.train import downstream as tds
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import CHANNELS, DOMAINS, as_jax, random_params, to_np
from tests.test_torch_downstream import CFG as FORWARD_CFG
from tests.test_torch_downstream import _sharpen_masks

FROZEN = 1
CFG = dict(FORWARD_CFG, frozen_stages=FROZEN)
B, G, P, LEVELS, NP_ = 2, 3, 24, 4, 16


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return {d: rng.standard_normal((B, 64, 64, CHANNELS[d])).astype(np.float32) for d in DOMAINS}


def _targets(seed):
    rng = np.random.default_rng(seed)
    masks = np.zeros((B, G, 64, 64), np.float32)
    labels = np.array([[0, 2, -1], [1, 1, 2]], np.int32)
    for i in range(B):
        for j in range(G):
            if labels[i, j] >= 0:
                h0, w0 = rng.integers(0, 32, 2)
                hh, ww = rng.integers(8, 32, 2)
                masks[i, j, h0:h0 + hh, w0:w0 + ww] = 1.0
    return labels, masks, labels >= 0


def _step_inputs(seed):
    """present (dem absent), a flat mask of the present tokens (keep 0.9),
    the matches and the PointRend points of every level."""
    rng = np.random.default_rng(seed)
    present = np.array([True, True, False])
    flat = np.ones((B, 3 * NP_), np.int64)
    flat[:, rng.permutation(2 * NP_)[:int(0.9 * 2 * NP_)]] = 0
    matched = np.stack([np.stack([rng.permutation(CFG["num_queries"])[:G] for _ in range(B)])
                        for _ in range(LEVELS)]).astype(np.int32)
    coords = rng.uniform(0.0, 1.0, (LEVELS, B * G, P, 2)).astype(np.float32)
    return present, flat, matched, coords


def _jax_loss(jm, e, dtype, dense_masks=False):
    def loss(params, batch, targets, mi, present, matched, coords):
        cast = (lambda t: jax.tree.map(lambda x: x.astype(dtype), t))
        out = jm.apply({"params": cast(params)}, cast(batch), mask_info=mi, num_encoded_tokens=e,
                       present=present, deterministic=True)
        out = jax.tree.map(lambda x: x.astype(jnp.float32), out)
        losses = jsc.set_criterion(out, targets, jax.random.PRNGKey(0), CFG["num_classes"], num_points=P,
                                   cost_class=2.0, cost_mask=5.0, cost_dice=5.0, dense_masks=dense_masks,
                                   matched_override=matched, point_coords_override=coords)
        parts = {name: w * sum(v for k, v in losses.items() if k.startswith(name))
                 for name, w in (("loss_ce", 2.0), ("loss_dice", 5.0), ("loss_mask", 5.0))}
        return 0.3 * parts["loss_ce"] + 0.3 * parts["loss_dice"] + 0.4 * parts["loss_mask"]

    return loss


@pytest.fixture(scope="module")
def setup():
    jcfg = jmf.MaskFormerConfig(**CFG)
    jm = jmf.MaskFormerModel(jcfg)
    x = _inputs(1)
    params = _sharpen_masks(random_params(jm, 2, as_jax(x)))
    e = jcfg.max_encoded_tokens
    value_and_grad = jax.jit(jax.value_and_grad(_jax_loss(jm, e, jnp.float32)))
    return jm, params, value_and_grad, x, _targets(3)


def _port(params, compute_dtype="float32", lr=1e-3, **step_options):
    cfg = tmf.MaskFormerConfig(**CFG)
    model = tmf.build_maskformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    opt = tds.create_downstream_optimizer(model, lr=lr, clip_grad=0.01, frozen_stages=FROZEN)
    step = tds.make_downstream_train_step(model, cfg, opt, num_points=P, compute_dtype=compute_dtype,
                                          **step_options)
    return model, opt, step, tds.DownstreamState(model, opt, torch.Generator().manual_seed(0))


def _jax_step_args(x, t, seed):
    present, flat, matched, coords = _step_inputs(seed)
    mi = jmask.mask_info_from_flat_mask(jnp.asarray(flat), DOMAINS, (NP_,) * 3, 3 * NP_)
    return (as_jax(x), jsc.SegTargets(*(jnp.asarray(a) for a in t)), mi, jnp.asarray(present),
            jnp.asarray(matched), jnp.asarray(coords))


def _port_step_args(x, t, seed):
    present, flat, matched, coords = _step_inputs(seed)
    mi = tmask.mask_info_from_flat_mask(torch.from_numpy(flat), DOMAINS, (NP_,) * 3, 3 * NP_)
    return ({d: torch.from_numpy(v) for d, v in x.items()},
            tsc.SegTargets(*(torch.from_numpy(np.asarray(a)) for a in t)), mi,
            torch.from_numpy(present), torch.from_numpy(matched), torch.from_numpy(coords))


def _assert_every_gradient(model, jgrads):
    want = params_from_jax(jgrads)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(want) == set(grads)
    total = float(torch.sqrt(sum(w.square().sum() for w in want.values())))
    for name, g in want.items():
        got = grads[name]
        assert got is not None, name
        # each parameter's gradient within rel-L2 1e-4 of its own norm, plus
        # 5e-8 of the global norm for the gradients that are zero in exact
        # arithmetic (a bias ahead of a GroupNorm, a key bias under the
        # softmax), whose f32 rounding follows the global scale
        err = float((got - g).norm())
        assert err <= 1e-4 * float(g.norm()) + 5e-8 * total, (name, err, float(g.norm()), total)
    return grads


def test_loss_and_every_gradient_match_jax(setup):
    jm, params, value_and_grad, x, t = setup
    jloss, jgrads = value_and_grad(params, *_jax_step_args(x, t, 4))
    model, _, step, _ = _port(params)
    batch, targets, mi, present, matched, coords = _port_step_args(x, t, 4)
    loss, metrics = step.loss_fn(dict(model.named_parameters()), batch, targets, mi, present, 0,
                                 matched_override=matched, point_coords_override=coords)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = _assert_every_gradient(model, jgrads)
    # the frozen stages' gradients are computed (the clip's norm needs them)
    frozen = [n for n, tr in tds.freeze_mask(model, FROZEN).items() if not tr]
    assert frozen and all(grads[n] is not None for n in frozen)
    assert float(grads["backbone.blocks.1.mlp.proj_in.weight"].abs().sum()) > 0
    # the MSDA sampling projections and the deformable core's backward
    assert float(grads["pixel_decoder.enc_layer0.self_attn.sampling_offsets.weight"].abs().sum()) > 0


def test_three_train_steps_match_optax(setup):
    jm, params, value_and_grad, x, t = setup
    tx = jds.create_downstream_optimizer(params, lr=1e-3, clip_grad=0.01, frozen_stages=FROZEN)
    opt_state, jp = tx.init(params), params
    model, opt, step, state = _port(params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    jlosses, tlosses = [], []
    for k in range(3):
        jargs = _jax_step_args(x, t, 10 + k)
        jloss, g = value_and_grad(jp, *jargs)
        upd, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        jlosses.append(float(jloss))
        batch, targets, mi, present, matched, coords = _port_step_args(x, t, 10 + k)
        state, metrics = step(state, batch, targets, matched, mask_info=mi, present=present,
                              point_coords_override=coords, deterministic=True)
        tlosses.append(float(metrics["loss"]))
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(g)), rtol=1e-4)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert state.step == 3 and len(set(np.round(tlosses, 5))) == 3
    want = params_from_jax(jp)
    mask = tds.freeze_mask(model, FROZEN)
    for name, p in model.named_parameters():
        # 1e-4 = 1/30 of three steps at lr 1e-3: Adam divides each element
        # by its own gradient scale, so where the gradient is zero in exact
        # arithmetic (a bias ahead of a GroupNorm) its rounding noise, about
        # 1e-10 after the clip, still moves the weight by lr * g / eps ~ 1e-5
        np.testing.assert_allclose(to_np(p), want[name].numpy(), atol=1e-4, rtol=0, err_msg=name)
        if not mask[name]:
            assert torch.equal(p, before[name]), name
    assert sum(not torch.equal(p, before[n]) for n, p in model.named_parameters()) == sum(mask.values())


def test_bf16_loss_near_jax_bf16_loss(setup):
    jm, params, _, x, t = setup
    e = jmf.MaskFormerConfig(**CFG).max_encoded_tokens
    jloss = jax.jit(_jax_loss(jm, e, jnp.bfloat16))(params, *_jax_step_args(x, t, 20))
    model, _, step, _ = _port(params, "bfloat16")
    batch, targets, mi, present, matched, coords = _port_step_args(x, t, 20)
    with torch.no_grad():
        loss, _ = step.loss_fn(dict(model.named_parameters()), batch, targets, mi, present, 0,
                               matched_override=matched, point_coords_override=coords)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    # the head computed in bf16 where flax does: the first prediction level
    # comes from the bf16 query stream, the pixel decoder in f32
    model.eval()
    cast = {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}
    out = torch.func.functional_call(model, cast, ({d: v.to(torch.bfloat16) for d, v in batch.items()},),
                                     dict(mask_info=mi, num_encoded_tokens=3 * NP_, present=present))
    assert out["pred_logits"].dtype == torch.bfloat16 and out["pred_masks"].dtype == torch.float32


def test_steps_draw_from_the_state_generator_and_cost_step_agrees(setup):
    """Without injections the step draws the subset, masks, dropout and key
    from the state's generator: two states of one seed take equal steps, and
    cost_step shows the costs of the step to come without advancing."""
    _, params, _, x, t = setup
    losses, costs = [], []
    for _ in range(2):
        model, _, step, state = _port(params)
        costs.append(step.cost_step(state, x, t))
        gen = state.generator.get_state()
        assert torch.equal(step.cost_step(state, x, t), costs[-1])
        assert torch.equal(state.generator.get_state(), gen)
        losses.append([float(step(state, x, t)[1]["loss"]) for _ in range(2)])
    assert losses[0] == losses[1]
    assert costs[0].shape == (LEVELS, B, CFG["num_queries"], G)
    torch.testing.assert_close(costs[0], costs[1], rtol=0, atol=0)


def test_freeze_mask_matches_jax(setup):
    _, params, _, _, _ = setup
    model = tmf.build_maskformer(tmf.MaskFormerConfig(**CFG), device="cpu")
    for frozen in (0, 1, 2):
        want = {k: bool(v) for k, v in params_from_jax(jds.freeze_mask(params, frozen)).items()}
        assert tds.freeze_mask(model, frozen) == want
    mask = tds.freeze_mask(model, 1)
    assert not mask["backbone.fusion_tokens"] and not mask["backbone.blocks.1.norm1.weight"]
    assert mask["backbone.blocks.0.norm1.weight"] and mask["backbone.mask_embedding"]


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_optimizer_matches_optax_over_random_gradients(setup, optimizer):
    _, params, _, _, _ = setup
    rng = np.random.default_rng(30)
    tx = jds.create_downstream_optimizer(params, lr=1e-3, clip_grad=0.01, frozen_stages=FROZEN,
                                         optimizer=optimizer)
    opt_state, jp = tx.init(params), params
    model = tmf.build_maskformer(tmf.MaskFormerConfig(**CFG), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    opt = tds.create_downstream_optimizer(model, lr=1e-3, clip_grad=0.01, frozen_stages=FROZEN,
                                          optimizer=optimizer)
    for k in range(3):
        scale = (1e-4, 1.0, 30.0)[k]  # under the clip, then over it
        g = jax.tree.map(lambda p: jnp.asarray(scale * rng.standard_normal(p.shape), jnp.float32), params)
        upd, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for name, v in params_from_jax(g).items():
            dict(model.named_parameters())[name].grad = v
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-5)
    want = params_from_jax(jp)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(to_np(p), want[name].numpy(), atol=1e-6, rtol=0, err_msg=name)
    tds.set_learning_rate(opt, 5e-5)
    assert opt.lr == 5e-5


def test_reduce_lr_on_plateau_matches_jax():
    metrics = [0.5, 0.4, 0.45, 0.41, 0.42, 0.43, 0.39, 0.5, 0.5, 0.5]
    for mode in ("min", "max"):
        a, b = jds.ReduceLROnPlateau(1e-3, patience=2, mode=mode), tds.ReduceLROnPlateau(1e-3, patience=2,
                                                                                       mode=mode)
        assert [a.step(m) for m in metrics] == [b.step(m) for m in metrics]


def test_label_map_from_targets_matches_jax():
    t = _targets(31)
    ref = jds.label_map_from_targets(jsc.SegTargets(*(jnp.asarray(a) for a in t)))
    out = tds.label_map_from_targets(tsc.SegTargets(*(torch.from_numpy(np.asarray(a)) for a in t)))
    np.testing.assert_array_equal(to_np(out), np.asarray(ref))
    assert out.dtype == torch.int32


def test_load_pretrained_backbone_matches_jax(setup):
    _, params, _, _, _ = setup
    pcfg = jconfig.PretrainConfig(
        model=jconfig.ModelConfig(dim_tokens=32, depth=2, dim_head=8, heads=2, ff_mult=4,
                                  num_fusion_tokens=16),
        data=jconfig.DataConfig(input_size=64, patch_size=16))
    jmm = jbuild_multimae(pcfg)
    batch = {d: jnp.zeros((1, 64, 64, CHANNELS[d])) for d in DOMAINS}
    pre = random_params(jmm, 32, batch, jmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, 1), 3 * NP_)
    new, report = jds.load_pretrained_backbone(params, pre)
    model = tmf.build_maskformer(tmf.MaskFormerConfig(**CFG), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    got = tds.load_pretrained_backbone(model, params_from_jax(pre))
    assert len(got["copied"]) == len(report["copied"]) > 0
    assert len(got["missing_in_ckpt"]) == len(report["missing_in_ckpt"])
    assert len(got["unused_from_ckpt"]) == len(report["unused_from_ckpt"])
    want = params_from_jax(new)
    for name, p in model.state_dict().items():
        torch.testing.assert_close(p, want[name], rtol=0, atol=0, msg=name)


def test_sample_modality_subset_invariants():
    g = torch.Generator().manual_seed(0)
    draws = [tmask.sample_modality_subset(g, 3) for _ in range(300)]
    assert all(d.dtype == torch.bool and d.shape == (3,) and d.any() for d in draws)
    assert {int(d.sum()) for d in draws} == {1, 2, 3}
    assert {tuple(d.tolist()) for d in draws if int(d.sum()) == 1} == {(True, False, False),
                                                                        (False, True, False),
                                                                        (False, False, True)}


@pytest.mark.parametrize("present,batch_shared", [((True, True, True), True), ((True, False, True), True),
                                                  ((False, True, False), False)])
def test_incomplete_random_masks_invariants(present, batch_shared):
    """floor(keep_ratio * present tokens) visible in every row, absent
    modalities fully masked, visible first in ascending order, the packed
    layout padded to the static size; one mask per batch or per sample."""
    nums, e, b = (NP_,) * 3, 48, 4
    pres = torch.tensor(present)
    mi = tmask.incomplete_random_masks(torch.Generator().manual_seed(1), DOMAINS, nums, pres, e, b,
                                       keep_ratio=0.9, batch_shared=batch_shared)
    want = int(np.floor(0.9 * NP_ * sum(present)))
    flat = torch.cat([mi.task_masks[d] for d in DOMAINS], dim=1)
    assert ((flat == 0).sum(dim=1) == want).all() and (mi.num_visible == want).all()
    for d, p in zip(DOMAINS, present):
        if not p:
            assert (mi.task_masks[d] == 1).all()
    for row in range(b):
        vis = mi.order[row, :want]
        assert (flat[row, vis] == 0).all() and (vis[1:] > vis[:-1]).all()
    assert mi.order.shape == (b, e)
    same = all(torch.equal(flat[0], flat[i]) for i in range(b))
    assert same == batch_shared
    # JAX's sampler on the same subset keeps the same count
    jmi = jmask.incomplete_random_masks(jax.random.PRNGKey(2), DOMAINS, nums, jnp.asarray(present), e, b)
    assert int(jmi.num_visible[0]) == want


def test_dice_and_binary_masks_match_jax():
    rng = np.random.default_rng(33)
    pred = rng.random((3, 8, 9)).astype(np.float32)
    gt = rng.integers(0, 4, (8, 9)).astype(np.int32)
    gt[0, 0] = 255
    np.testing.assert_allclose(
        to_np(tmetrics.binary_mask_from_labels(torch.from_numpy(gt), 3)),
        np.asarray(jmetrics.binary_mask_from_labels(jnp.asarray(gt), 3)))
    tgt = (rng.random((3, 8, 9)) < 0.5).astype(np.float32)
    np.testing.assert_allclose(float(tmetrics.dice_score(torch.from_numpy(pred), torch.from_numpy(tgt))),
                               float(jmetrics.dice_score(jnp.asarray(pred), jnp.asarray(tgt))), rtol=1e-6)


def test_conf_matrix_matches_jax():
    rng = np.random.default_rng(34)
    gt, pred = rng.integers(0, 5, (3, 16, 16)), rng.integers(1, 6, (3, 16, 16))
    a, b = jmetrics.ConfMatrix(5), tmetrics.ConfMatrix(5)
    a.add_batch(gt, pred)
    b.add_batch(torch.from_numpy(gt), torch.from_numpy(pred))
    np.testing.assert_array_equal(b.state, a.state)
    assert (b.get_aa(), b.get_miou(), b.get_existing_classes()) == (a.get_aa(), a.get_miou(),
                                                                   a.get_existing_classes())
    np.testing.assert_array_equal(b.get_sa(), a.get_sa())
    np.testing.assert_array_equal(b.get_iou(), a.get_iou())


def test_eval_steps_match_jax(setup):
    jm, params, _, x, t = setup
    jcfg, cfg = jmf.MaskFormerConfig(**CFG), tmf.MaskFormerConfig(**CFG)
    gt = np.array(jds.label_map_from_targets(jsc.SegTargets(*(jnp.asarray(a) for a in t))))
    jdice = jax.jit(jds.make_eval_step(jm, jcfg))(params, as_jax(x), jnp.asarray(gt))
    jpred = jax.jit(jds.make_semantic_pred_step(jm, jcfg))(params, as_jax(x))
    model = tmf.build_maskformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    dice = tds.make_eval_step(model, cfg)(None, x, torch.from_numpy(gt))
    pred = tds.make_semantic_pred_step(model, cfg)(None, x)
    np.testing.assert_allclose(float(dice), float(jdice), rtol=1e-4)
    assert pred.shape == (B, 64, 64)
    assert (to_np(pred) == np.asarray(jpred)).mean() > 0.99


def test_hostmatch_step_is_the_exact_step_and_unknown_modes_raise():
    cfg = tmf.MaskFormerConfig(**CFG)
    model = tmf.build_maskformer(cfg, device="cpu")
    opt = tds.create_downstream_optimizer(model)
    with pytest.raises(ValueError, match="match_mode"):
        tds.make_downstream_train_step(model, cfg, opt, match_mode="sinkhorn")
    step = tds.make_downstream_hostmatch_step(model, cfg, opt, num_points=P, match_mode="greedy")
    assert hasattr(step, "cost_step")


@pytest.fixture(scope="module")
def dense_value_and_grad(setup):
    jm = setup[0]
    e = jmf.MaskFormerConfig(**CFG).max_encoded_tokens
    return jax.jit(jax.value_and_grad(_jax_loss(jm, e, jnp.float32, dense_masks=True)))


@pytest.mark.parametrize("mode", ["exact", "greedy", "auction"])
def test_dense_step_loss_and_every_gradient_match_jax(setup, dense_value_and_grad, mode):
    """The semantic step (dense_masks=True) matching by ``mode`` on its own:
    every level assigned as JAX's hungarian_match(mode) assigns the port's
    costs of the same forward and key, then the loss (1e-5) and every
    gradient against jax.value_and_grad of JAX's dense criterion with those
    matches."""
    _, params, _, x, t = setup
    model, _, step, _ = _port(params, dense_masks=True, match_mode=mode)
    batch, targets, mi, present, _, _ = _port_step_args(x, t, 5)
    loss, _, aux = step.loss_fn(dict(model.named_parameters()), batch, targets, mi, present, 3, return_aux=True)
    loss.backward()
    assert aux["point_coords"] is None
    with torch.no_grad():
        out = torch.func.functional_call(model, dict(model.named_parameters()), (batch,),
                                         dict(mask_info=mi, num_encoded_tokens=3 * NP_, present=present))
        costs = tsc.set_criterion_costs(out, targets, 3, num_points=P, cost_class=2.0, cost_mask=5.0,
                                        cost_dice=5.0)
    want = np.stack([np.asarray(jsc.hungarian_match(jnp.asarray(to_np(c)), mode=mode)) for c in costs])
    np.testing.assert_array_equal(to_np(aux["matched"]), want)
    jx, jt, jmi, jpresent, _, jcoords = _jax_step_args(x, t, 5)
    jloss, jgrads = dense_value_and_grad(params, jx, jt, jmi, jpresent, jnp.asarray(want), jcoords)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _assert_every_gradient(model, jgrads)


def test_three_dense_train_steps_match_optax(setup, dense_value_and_grad):
    """Three semantic steps (dense masks, matches injected) against JAX's
    dense loss and the optax chain: losses to 1e-5, the gradient norm to
    1e-4, every weight whose gradient is not zero in exact arithmetic to
    1e-4. A weight whose gradient is zero in exact arithmetic (a bias ahead
    of a GroupNorm: its JAX gradient under 1e-6 of the global norm in every
    step) moves by Adam's normalised rounding noise, at most lr a step, so
    it is held to 3 lr."""
    _, params, _, x, t = setup
    lr = 1e-3
    tx = jds.create_downstream_optimizer(params, lr=lr, clip_grad=0.01, frozen_stages=FROZEN)
    opt_state, jp = tx.init(params), params
    model, _, step, state = _port(params, lr=lr, dense_masks=True)
    jlosses, tlosses, noise_only = [], [], None
    for k in range(3):
        jloss, g = dense_value_and_grad(jp, *_jax_step_args(x, t, 30 + k))
        total = float(optax.global_norm(g))
        tiny = {n for n, v in params_from_jax(g).items() if float(v.norm()) <= 1e-6 * total}
        noise_only = tiny if noise_only is None else noise_only & tiny
        upd, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        jlosses.append(float(jloss))
        batch, targets, mi, present, matched, _ = _port_step_args(x, t, 30 + k)
        state, metrics = step(state, batch, targets, matched, mask_info=mi, present=present, deterministic=True)
        tlosses.append(float(metrics["loss"]))
        np.testing.assert_allclose(float(metrics["grad_norm"]), total, rtol=1e-4)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    want = params_from_jax(jp)
    for name, p in model.named_parameters():
        atol = 3 * lr if name in noise_only else 1e-4
        np.testing.assert_allclose(to_np(p), want[name].numpy(), atol=atol, rtol=0, err_msg=name)
