"""The ported serving slice -- MultiMAE crossattn forward through
``infer.infer`` and ``serving.infer_closure`` -- against the JAX package on
the same weights and inputs (atol 5e-5, f32 on CPU), against the executed
reference's frozen outputs in tests/golden/fullmodel_golden.npz, and on the
dropped-modality invariance that is the model's headline property."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu import infer as jinfer
from incomplete_multimodal_fusion_tpu import serving as jserving
from incomplete_multimodal_fusion_tpu.models.multimae import MultiMAE as JaxMultiMAE
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.utils.torch_convert import convert_multimae_state
from incomplete_multimodal_fusion_tpu_torch import infer as tinfer
from incomplete_multimodal_fusion_tpu_torch import serving as tserving
from incomplete_multimodal_fusion_tpu_torch.models.multimae import MultiMAE as TorchMultiMAE
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from tests.test_torch_common import (CHANNELS, DOMAINS, NP_, SMALL, as_jax, as_torch,
                                     port_module, random_params, to_np)

ATOL = 5e-5
B = 2
CAPACITY = NP_ * len(DOMAINS)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    x = {d: rng.standard_normal((B, 64, 64, CHANNELS[d])).astype(np.float32) for d in DOMAINS}
    jm = JaxMultiMAE(attn_impl="auto", **SMALL)
    mi = jmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, B)
    params = random_params(jm, 1, as_jax(x), mi, CAPACITY)
    tm = port_module(TorchMultiMAE(attn_impl="auto", **SMALL), params)
    return jm, params, tm, x


def _drop_masks(dropped):
    return {d: np.full((B, NP_), 1 if d in dropped else 0, np.int64) for d in DOMAINS}


def _random_flat_mask():
    flat = (np.random.default_rng(3).random((B, CAPACITY)) < 0.6).astype(np.int64)
    flat[1, NP_:2 * NP_] = 1  # row 1 has no visible s2 token
    return flat


REQUESTS = {
    "full": dict(dropped=()),
    "drop_one": dict(dropped=("dem",)),
    "drop_two": dict(dropped=("s1", "dem")),
    "random_e24": dict(e=24),
}


def _mask_infos(req):
    """The same MaskInfo on both sides: the task masks of a drop request at
    full capacity, or an injected random flat mask at e < capacity."""
    if "dropped" in req:
        masks = _drop_masks(req["dropped"])
        return (jmask.mask_info_from_task_masks(as_jax(masks), DOMAINS, CAPACITY),
                tmask.mask_info_from_task_masks(as_torch(masks), DOMAINS, CAPACITY), CAPACITY)
    flat = _random_flat_mask()
    e = req["e"]
    return (jmask.mask_info_from_flat_mask(jnp.asarray(flat), DOMAINS, (NP_,) * 3, e),
            tmask.mask_info_from_flat_mask(torch.from_numpy(flat), DOMAINS, (NP_,) * 3, e), e)


@pytest.mark.parametrize("kind", sorted(REQUESTS))
def test_forward_matches_jax(pair, kind):
    """Every output of the forward: preds, pooled (a fully dropped
    modality's row is the uniform average over the valid keys on both
    sides), fusion_tokens, ori_tokens over the visible slots, pooled_mod."""
    jm, params, tm, x = pair
    jmi, tmi, e = _mask_infos(REQUESTS[kind])
    ref = jm.apply({"params": params}, as_jax(x), jmi, e)
    with torch.no_grad():
        out = tm(as_torch(x), tmi, e)
    for d in DOMAINS:
        np.testing.assert_allclose(to_np(out["preds"][d]), np.asarray(ref["preds"][d]), atol=ATOL,
                                   err_msg=f"preds[{d}]")
        np.testing.assert_allclose(to_np(out["pooled_mod"][d]), np.asarray(ref["pooled_mod"][d]),
                                   atol=ATOL, err_msg=f"pooled_mod[{d}]")
    np.testing.assert_allclose(to_np(out["pooled"]), np.asarray(ref["pooled"]), atol=ATOL)
    np.testing.assert_allclose(to_np(out["fusion_tokens"]), np.asarray(ref["fusion_tokens"]),
                               atol=ATOL)
    for row in range(B):
        n_vis = int(tmi.num_visible[row])
        np.testing.assert_allclose(to_np(out["ori_tokens"][row, :n_vis]),
                                   np.asarray(ref["ori_tokens"][row, :n_vis]), atol=ATOL)


@pytest.mark.parametrize("dropped", [(), ("dem",), ("s1", "dem")])
def test_infer_and_serving_match_jax(pair, dropped):
    """The two entry points a user calls, side by side: ``infer.infer``
    with ``drop_modalities`` and the flat-signature serving closure."""
    jm, params, tm, x = pair
    masks = _drop_masks(dropped)
    ref = jinfer.infer(jm, params, as_jax(x), 24, task_masks=as_jax(masks))
    out = tinfer.infer(tm, None, x, 24, drop_modalities=dropped,
                       task_masks=None if dropped else as_torch(masks))
    for d in DOMAINS:
        np.testing.assert_allclose(to_np(out.preds[d]), np.asarray(ref.preds[d]), atol=ATOL)
        np.testing.assert_array_equal(to_np(out.task_masks[d]), np.asarray(ref.task_masks[d]))
    np.testing.assert_allclose(to_np(out.pooled), np.asarray(ref.pooled), atol=ATOL)

    args = [x[d] for d in DOMAINS] + [masks[d] for d in DOMAINS]
    ref_s = jserving._infer_closure(jm, params, DOMAINS)(*as_jax(args))
    out_s = tserving.infer_closure(tm, None, DOMAINS)(*args)
    for d in DOMAINS:
        np.testing.assert_allclose(to_np(out_s["preds"][d]), np.asarray(ref_s["preds"][d]),
                                   atol=ATOL)
    np.testing.assert_allclose(to_np(out_s["pooled"]), np.asarray(ref_s["pooled"]), atol=ATOL)


def test_infer_random_masks_runs_at_e(pair):
    """Seeded random masks: exactly e visible tokens per row, finite outputs
    of the served shapes, the same result from the same seed."""
    _, _, tm, x = pair
    res = [tinfer.infer(tm, None, x, 24, generator=torch.Generator().manual_seed(5))
           for _ in range(2)]
    flat = torch.cat([res[0].task_masks[d] for d in DOMAINS], dim=1)
    assert ((flat == 0).sum(dim=1) == 24).all()
    for d in DOMAINS:
        assert res[0].preds[d].shape == (B, 64, 64, CHANNELS[d])
        assert torch.isfinite(res[0].preds[d]).all()
        torch.testing.assert_close(res[0].preds[d], res[1].preds[d], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the executed reference's frozen outputs (tests/test_fullmodel_parity.py)
# ---------------------------------------------------------------------------

G = dict(np.load(os.path.join(os.path.dirname(__file__), "golden", "fullmodel_golden.npz")))
E_GOLDEN = 24


@pytest.fixture(scope="module")
def golden_port():
    from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax

    state = {k[len("w::"):]: v for k, v in G.items() if k.startswith("w::")}
    params = convert_multimae_state(state, DOMAINS, DOMAINS, CHANNELS, patch_size=16,
                                    depth=2, decoder_depth=2)
    model = TorchMultiMAE(attn_impl="auto", **SMALL)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model.eval()


def _golden_forward(model, tag, x=None):
    if x is None:
        x = {d: torch.from_numpy(G[f"x_{d}"].transpose(0, 2, 3, 1).copy()) for d in DOMAINS}
    masks = {d: torch.from_numpy(G[f"{tag}::mask_{d}"]) for d in DOMAINS}
    mi = tmask.mask_info_from_task_masks(masks, DOMAINS, E_GOLDEN)
    with torch.no_grad():
        return model(x, mi, E_GOLDEN)


@pytest.mark.parametrize("tag", ["full", "drop"])
def test_golden_reference_outputs(golden_port, tag):
    out = _golden_forward(golden_port, tag)
    for d in DOMAINS:
        np.testing.assert_allclose(to_np(out["preds"][d]),
                                   G[f"{tag}::pred_{d}"].transpose(0, 2, 3, 1), atol=ATOL)
        np.testing.assert_allclose(to_np(out["pooled_mod"][d]), G[f"{tag}::pool_{d}"][:, 0],
                                   atol=ATOL)
    # the rows tests/test_fullmodel_parity.py:91-98 compares: present
    # modalities and the fusion row
    rows = [i for i, d in enumerate(DOMAINS) if (G[f"{tag}::mask_{d}"][0] == 0).any()]
    rows.append(len(DOMAINS))
    np.testing.assert_allclose(to_np(out["pooled"])[:, rows], G[f"{tag}::return_tokens"][:, rows],
                               atol=ATOL)
    np.testing.assert_allclose(to_np(out["fusion_tokens"]), G[f"{tag}::fusion_tokens"], atol=ATOL)
    n_vis = sum(int((G[f"{tag}::mask_{d}"][0] == 0).sum()) for d in DOMAINS)
    np.testing.assert_allclose(to_np(out["ori_tokens"])[:, :n_vis],
                               G[f"{tag}::ori_tokens"][:, :n_vis], atol=ATOL)


def test_dropped_modality_input_invariance(golden_port):
    """With dem's task mask all ones, the forward does not depend on dem's
    pixels at all (tests/test_fullmodel_parity.py:125-139, on the port)."""
    out1 = _golden_forward(golden_port, "drop")
    x = {d: torch.from_numpy(G[f"x_{d}"].transpose(0, 2, 3, 1).copy()) for d in DOMAINS}
    x["dem"] = x["dem"] * 0.0 + 123.0
    out2 = _golden_forward(golden_port, "drop", x)
    for d in DOMAINS:
        np.testing.assert_allclose(to_np(out1["preds"][d]), to_np(out2["preds"][d]), atol=1e-6)
    np.testing.assert_allclose(to_np(out1["pooled"]), to_np(out2["pooled"]), atol=1e-6)


def test_jax_tree_names_map_one_to_one(pair):
    """Every flax leaf lands on exactly one port parameter and back."""
    from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax

    _, params, tm, _ = pair
    sd = params_from_jax(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    assert set(sd) == set(tm.state_dict())
