"""The ported Mask2Former set criterion (losses/set_criterion.py) against the
JAX package's on the same numpy inputs: the two matching costs, the whole
cost matrix at the points JAX draws, the scipy assignment, the on-device
greedy and auction assignments (equal to JAX's on costs with ties and
padded columns; the auction within G eps of the optimum), PointRend's
uncertain points with JAX's uniform draws injected, the per-level losses
(point-sampled, and with dense masks at target sizes above and below the
predictions') and the full criterion with the matches and points injected
or, with dense masks, matched by each mode, and the semantic targets. Loss
tolerance 1e-5 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.losses import set_criterion as jsc
from incomplete_multimodal_fusion_tpu_torch.losses import set_criterion as tsc
from tests.test_torch_common import to_np

B, Q, G, K, P = 2, 5, 3, 3, 20
HP, HT = 8, 16  # prediction and target mask sizes


def _outputs(seed, levels=3):
    """A model's output dict with ``levels`` - 1 aux levels, as numpy."""
    rng = np.random.default_rng(seed)

    def level():
        return {"pred_logits": rng.standard_normal((B, Q, K + 1)).astype(np.float32),
                "pred_masks": (2 * rng.standard_normal((B, Q, HP, HP))).astype(np.float32)}

    out = level()
    out["aux_outputs"] = [level() for _ in range(levels - 1)]
    return out


def _targets(seed):
    """Padded targets: image 0 has 3 instances, image 1 one (two padding
    columns, label -1)."""
    rng = np.random.default_rng(seed)
    masks = (rng.random((B, G, HT, HT)) < 0.3).astype(np.float32)
    labels = np.array([[0, 2, 1], [1, -1, -1]], np.int32)
    valid = labels >= 0
    masks[~valid] = 0.0
    return labels, masks, valid


def _jt(t):
    return jsc.SegTargets(*(jnp.asarray(a) for a in t))


def _tt(t):
    return tsc.SegTargets(*(torch.from_numpy(np.asarray(a)) for a in t))


def _jout(out):
    return jax.tree.map(jnp.asarray, out)


def _tout(out):
    return {"pred_logits": torch.from_numpy(out["pred_logits"]),
            "pred_masks": torch.from_numpy(out["pred_masks"]),
            "aux_outputs": [{k: torch.from_numpy(v) for k, v in a.items()} for a in out["aux_outputs"]]}


def test_cost_functions_match_jax():
    rng = np.random.default_rng(0)
    logits = (2 * rng.standard_normal((Q, P))).astype(np.float32)
    tgt = (rng.random((G, P)) < 0.4).astype(np.float32)
    for jfn, tfn in ((jsc.batch_dice_cost, tsc.batch_dice_cost),
                     (jsc.batch_sigmoid_ce_cost, tsc.batch_sigmoid_ce_cost)):
        ref = np.asarray(jax.jit(jfn)(jnp.asarray(logits), jnp.asarray(tgt)))
        out = tfn(torch.from_numpy(logits), torch.from_numpy(tgt))
        assert out.shape == (Q, G)
        np.testing.assert_allclose(to_np(out), ref, rtol=1e-5, atol=1e-6)
        # batched over images, as match_costs runs them
        both = tfn(torch.from_numpy(np.stack([logits, logits[::-1]])),
                   torch.from_numpy(np.stack([tgt, tgt])))
        np.testing.assert_allclose(to_np(both[0]), ref, rtol=1e-5, atol=1e-6)


def test_match_costs_match_jax_at_jax_points():
    out, t = _outputs(1), _targets(2)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax.jit(lambda o, tg, k: jsc.match_costs(
        o["pred_logits"], o["pred_masks"], tg, k, P, 2.0, 5.0, 5.0))(_jout(out), _jt(t), key))
    coords = np.array(jax.random.uniform(key, (B, 1, P, 2)))  # what match_costs draws
    got = tsc.match_costs(torch.from_numpy(out["pred_logits"]), torch.from_numpy(out["pred_masks"]),
                          _tt(t), None, P, 2.0, 5.0, 5.0, coords=torch.from_numpy(coords))
    assert got.shape == (B, Q, G) and not got.requires_grad
    np.testing.assert_allclose(to_np(got), ref, rtol=1e-5, atol=1e-5)
    assert np.all(to_np(got)[1, :, 1:] == tsc.PAD_COST)


def test_scipy_assignment_matches_jax():
    cost = np.random.default_rng(4).random((3, B, Q, G)).astype(np.float32)
    ref = np.asarray(jsc.scipy_assign_host(cost))
    np.testing.assert_array_equal(tsc.scipy_assign_host(cost), ref)
    out = tsc.hungarian_match(torch.from_numpy(cost))
    np.testing.assert_array_equal(to_np(out), ref)


def _costs(case, seed, levels=3, b=4, q=12, g=5):
    """[L, B, Q, G] costs: 'ties' small integers (many equal costs),
    'padded' the same with the last columns of some images at PAD_COST,
    'continuous' uniform."""
    rng = np.random.default_rng(seed)
    if case == "continuous":
        return rng.random((levels, b, q, g)).astype(np.float32)
    cost = rng.integers(0, 6, (levels, b, q, g)).astype(np.float32)
    if case == "padded":
        pad = rng.random((levels, b, 1, 2)) < 0.5
        cost[..., 3:] = np.where(pad, tsc.PAD_COST, cost[..., 3:])
    return cost


@pytest.mark.parametrize("mode", ["greedy", "auction"])
@pytest.mark.parametrize("case", ["ties", "padded", "continuous"])
def test_on_device_assignments_match_jax(mode, case):
    """greedy_assign and auction_assign over every level and image at once
    give JAX's assignment of each [B, Q, G] level bit for bit: the lowest
    index among equal costs and bids (argmax, mask, max for the top two),
    padded columns included."""
    cost = _costs(case, {"ties": 20, "padded": 21, "continuous": 22}[case])
    ref = np.stack([np.asarray(jax.jit(lambda c: jsc.hungarian_match(c, mode=mode))(jnp.asarray(c)))
                    for c in cost])
    out = tsc.hungarian_match(torch.from_numpy(cost), mode=mode)
    assert out.shape == cost.shape[:-2] + cost.shape[-1:]
    np.testing.assert_array_equal(to_np(out), ref)
    assert all(len(set(row)) == len(row) for row in to_np(out).reshape(-1, cost.shape[-1]))


@pytest.mark.parametrize("seed", [23, 24])
def test_auction_is_within_g_eps_of_the_optimum(seed):
    """The auction's assignment costs at most G eps (eps = 1e-3 x the cost
    spread) more than scipy's optimum, image by image."""
    cost = _costs("continuous", seed, levels=1, b=6, q=20, g=8)[0]
    got = to_np(tsc.auction_assign(torch.from_numpy(cost)))
    best = tsc.scipy_assign_host(cost)
    for c, a, o in zip(cost, got, best):
        eps = 1e-3 * (c.max() - c.min())
        total, optimum = c[a, np.arange(c.shape[1])].sum(), c[o, np.arange(c.shape[1])].sum()
        assert optimum - 1e-5 <= total <= optimum + c.shape[1] * eps + 1e-5


def test_unknown_match_mode_raises():
    cost = torch.from_numpy(_costs("continuous", 25))
    with pytest.raises(ValueError, match="match_mode"):
        tsc.hungarian_match(cost, mode="sinkhorn")


def test_match_outputs_to_targets_is_the_assignment_of_the_costs():
    """The per-level matcher: the exact assignment of match_costs at the
    points its generator draws."""
    out, t = _tout(_outputs(18, levels=1)), _tt(_targets(19))
    got = tsc.match_outputs_to_targets(out["pred_logits"], out["pred_masks"], t,
                                       torch.Generator().manual_seed(5), P, 2.0, 5.0, 5.0)
    cost = tsc.match_costs(out["pred_logits"], out["pred_masks"], t, torch.Generator().manual_seed(5), P,
                           2.0, 5.0, 5.0)
    np.testing.assert_array_equal(to_np(got), tsc.scipy_assign_host(to_np(cost)))
    assert got.shape == (B, G)


def test_uncertain_point_coords_match_jax_with_its_draws():
    logits = (2 * np.random.default_rng(5).standard_normal((B * G, HP, HP))).astype(np.float32)
    key = jax.random.PRNGKey(6)
    n_points, over, imp = 16, 3.0, 0.75
    ref = np.asarray(jax.jit(lambda lg, k: jsc.uncertain_point_coords(k, lg, n_points, over, imp))(
        jnp.asarray(logits), key))
    k1, k2 = jax.random.split(key)
    draws = (torch.from_numpy(np.array(jax.random.uniform(k1, (B * G, 48, 2)))),
             torch.from_numpy(np.array(jax.random.uniform(k2, (B * G, 4, 2)))))
    out = tsc.uncertain_point_coords(None, torch.from_numpy(logits), n_points, over, imp, draws=draws)
    assert out.shape == (B * G, n_points, 2)
    np.testing.assert_array_equal(to_np(out), ref)


def _overrides(seed, levels=3, n_points=P):
    rng = np.random.default_rng(seed)
    matched = np.stack([np.stack([rng.permutation(Q)[:G] for _ in range(B)]) for _ in range(levels)])
    coords = rng.uniform(-0.05, 1.05, (levels, B * G, n_points, 2)).astype(np.float32)
    return matched.astype(np.int32), coords


def test_criterion_losses_match_jax():
    out, t = _outputs(7, levels=1), _targets(8)
    matched, coords = _overrides(9, levels=1)
    num_masks = float(max(t[2].sum(), 1))
    ref = jax.jit(lambda o, tg, m, c: jsc.criterion_losses(
        o["pred_logits"], o["pred_masks"], tg, m, jax.random.PRNGKey(0), K, jnp.float32(num_masks),
        0.1, P, point_coords_override=c))(_jout(out), _jt(t), jnp.asarray(matched[0]),
                                          jnp.asarray(coords[0]))
    got, used = tsc.criterion_losses(
        torch.from_numpy(out["pred_logits"]), torch.from_numpy(out["pred_masks"]), _tt(t),
        torch.from_numpy(matched[0]), None, K, torch.tensor(num_masks), 0.1, P,
        point_coords_override=torch.from_numpy(coords[0]))
    assert set(got) == set(ref) == {"loss_ce", "loss_mask", "loss_dice"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(to_np(used), coords[0])


def test_set_criterion_matches_jax_with_matches_and_points_injected():
    out, t = _outputs(10), _targets(11)
    matched, coords = _overrides(12)
    ref = jax.jit(lambda o, tg, m, c: jsc.set_criterion(
        o, tg, jax.random.PRNGKey(0), K, num_points=P, matched_override=m,
        point_coords_override=c))(_jout(out), _jt(t), jnp.asarray(matched), jnp.asarray(coords))
    tout = _tout(out)
    for v in [tout["pred_masks"]] + [a["pred_masks"] for a in tout["aux_outputs"]]:
        v.requires_grad_()
    got = tsc.set_criterion(tout, _tt(t), 0, K, num_points=P, matched_override=torch.from_numpy(matched),
                            point_coords_override=torch.from_numpy(coords))
    assert set(got) == set(ref) and len(got) == 9  # 3 terms x (final + 2 aux)
    for k in got:
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=1e-5, err_msg=k)
    # the mask losses' gradient reaches every level's masks through K5b's
    # plain version
    sum(got.values()).backward()
    assert all(float(v.grad.abs().sum()) > 0 for v in [tout["pred_masks"]]
               + [a["pred_masks"] for a in tout["aux_outputs"]])


def test_set_criterion_key_contract():
    """set_criterion(key) matches as the host assignment of
    set_criterion_costs(key) does, and draws the same PointRend points: the
    split step (costs, scipy, then the losses with the matches given) is the
    exact step."""
    out, t = _tout(_outputs(13)), _tt(_targets(14))
    losses, aux = tsc.set_criterion(out, t, 1234, K, num_points=P, return_aux=True)
    matched = tsc.hungarian_match(tsc.set_criterion_costs(out, t, 1234, num_points=P))
    torch.testing.assert_close(aux["matched"], matched, rtol=0, atol=0)
    again = tsc.set_criterion(out, t, 1234, K, num_points=P, matched_override=matched)
    for k in losses:
        torch.testing.assert_close(again[k], losses[k], rtol=0, atol=0)
    other = tsc.set_criterion(out, t, 99, K, num_points=P)
    assert any(float(other[k]) != float(losses[k]) for k in losses)
    assert aux["point_coords"].shape == (3, B * G, P, 2)


def _targets_of_size(seed, size):
    labels, masks, valid = _targets(seed)
    rng = np.random.default_rng(seed + 100)
    masks = (rng.random((B, G, size, size)) < 0.3).astype(np.float32)
    masks[~valid] = 0.0
    return labels, masks, valid


@pytest.mark.parametrize("size", [16, 12, 6])
def test_dense_criterion_losses_match_jax(size):
    """dense_masks=True: the targets resized to the predictions' 8 x 8 by
    jax.image.resize(method='nearest') on JAX's side and
    F.interpolate(mode='nearest-exact') on the port's (targets of 16, 12
    and 6 pixels: larger and smaller), the losses over the whole masks, no
    PointRend points (None)."""
    out, t = _outputs(30, levels=1), _targets_of_size(31, size)
    matched, _ = _overrides(32, levels=1)
    num_masks = float(max(t[2].sum(), 1))
    ref = jax.jit(lambda o, tg, m: jsc.criterion_losses(
        o["pred_logits"], o["pred_masks"], tg, m, jax.random.PRNGKey(0), K, jnp.float32(num_masks), 0.1, P,
        dense_masks=True))(_jout(out), _jt(t), jnp.asarray(matched[0]))
    masks = torch.from_numpy(out["pred_masks"]).requires_grad_()
    got, coords = tsc.criterion_losses(torch.from_numpy(out["pred_logits"]), masks, _tt(t),
                                       torch.from_numpy(matched[0]), None, K, torch.tensor(num_masks), 0.1, P,
                                       dense_masks=True)
    assert coords is None and set(got) == set(ref)
    for k in got:
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=1e-5, err_msg=k)
    sum(got.values()).backward()
    assert float(masks.grad.abs().sum()) > 0


@pytest.mark.parametrize("mode", ["exact", "greedy", "auction"])
def test_dense_set_criterion_with_each_match_mode_matches_jax(mode):
    """set_criterion(dense_masks=True, match_mode=mode) assigns every level
    as JAX's hungarian_match(mode) does on the same costs (the port's
    set_criterion_costs under the same key) and gives JAX's losses with
    those matches."""
    out, t = _outputs(33), _targets_of_size(34, 16)
    tout = _tout(out)
    costs = tsc.set_criterion_costs(tout, _tt(t), 77, num_points=P, cost_class=2.0, cost_mask=5.0, cost_dice=5.0)
    want = np.stack([np.asarray(jsc.hungarian_match(jnp.asarray(to_np(c)), mode=mode)) for c in costs])
    losses, aux = tsc.set_criterion(tout, _tt(t), 77, K, num_points=P, cost_class=2.0, cost_mask=5.0,
                                    cost_dice=5.0, dense_masks=True, match_mode=mode, return_aux=True)
    np.testing.assert_array_equal(to_np(aux["matched"]), want)
    assert aux["point_coords"] is None
    ref = jax.jit(lambda o, tg, m: jsc.set_criterion(o, tg, jax.random.PRNGKey(0), K, num_points=P,
                                                     dense_masks=True, matched_override=m))(
        _jout(out), _jt(t), jnp.asarray(want))
    assert set(losses) == set(ref) and len(losses) == 9
    for k in losses:
        np.testing.assert_allclose(float(losses[k]), float(ref[k]), rtol=1e-5, err_msg=k)


def test_targets_from_semantic_labels_match_jax():
    label_map = np.random.default_rng(17).integers(0, 4, (B, HT, HT)).astype(np.int32)
    label_map[1][label_map[1] == 2] = 255  # class 2 absent from image 1; 255 is ignore
    ref = jsc.targets_from_semantic_labels(jnp.asarray(label_map), 5)
    out = tsc.targets_from_semantic_labels(torch.from_numpy(label_map), 5)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(to_np(o), np.asarray(r))
    assert not bool(out.valid[1, 2]) and not bool(out.valid[0, 4])
