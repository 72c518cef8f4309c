"""Port parity for the plain tensor ops: patches, posemb, the Zorro masks,
the packed-layout bookkeeping and the masking engine, against the JAX
package on the same numpy inputs (atol 1e-6; integer outputs exactly)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.ops import attention as jattn
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.ops import patches as jpatches
from incomplete_multimodal_fusion_tpu.ops import posemb as jposemb
from incomplete_multimodal_fusion_tpu_torch.ops import attention as tattn
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.ops import patches as tpatches
from incomplete_multimodal_fusion_tpu_torch.ops import posemb as tposemb
from tests.test_torch_common import DOMAINS, to_np

ATOL = 1e-6
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference_golden.npz")


@pytest.mark.parametrize("b,h,w,c,p", [(2, 32, 32, 3, 16), (1, 48, 32, 1, 8)])
def test_patchify_unpatchify_conv_embed(b, h, w, c, p):
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((b, h, w, c)).astype(np.float32)
    # xavier-sized weights keep the sums near 1, where f32 rounding of the
    # two summation orders stays below ATOL
    kernel = rng.standard_normal((p * p * c, 24)).astype(np.float32) * (p * p * c) ** -0.5 * 0.3
    bias = rng.standard_normal(24).astype(np.float32) * 0.1
    pj = np.asarray(jpatches.patchify(jnp.asarray(imgs), p))
    pt = to_np(tpatches.patchify(torch.from_numpy(imgs), p))
    np.testing.assert_array_equal(pt, pj)
    back = tpatches.unpatchify(torch.from_numpy(pt), p, h // p, w // p, c)
    np.testing.assert_array_equal(to_np(back), imgs)
    ej = jpatches.conv_patch_embed(jnp.asarray(imgs), jnp.asarray(kernel), jnp.asarray(bias), p)
    et = tpatches.conv_patch_embed(torch.from_numpy(imgs), torch.from_numpy(kernel),
                                   torch.from_numpy(bias), p)
    np.testing.assert_allclose(to_np(et), np.asarray(ej), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("h,w,d", [(4, 4, 32), (16, 16, 192), (3, 5, 8)])
def test_posemb_matches_jax(h, w, d):
    np.testing.assert_allclose(to_np(tposemb.build_2d_sincos_posemb(h, w, d)),
                               np.asarray(jposemb.build_2d_sincos_posemb(h, w, d)), atol=ATOL)


@pytest.mark.parametrize("key,h,d", [("posemb_4x4x32", 4, 32), ("posemb_16x16x192", 16, 192)])
def test_posemb_matches_reference_golden(key, h, d):
    ref = np.load(GOLDEN)[key][0]  # [d, h, w], the reference's 'b d h w'
    ref = ref.reshape(d, h * h).T
    np.testing.assert_allclose(to_np(tposemb.build_2d_sincos_posemb(h, h, d)), ref, atol=ATOL)


@pytest.mark.parametrize("src,dst", [((4, 4), (6, 6)), ((8, 8), (4, 4))])
def test_resize_posemb_matches_jax(src, dst):
    pos = np.random.default_rng(1).standard_normal((src[0] * src[1], 8)).astype(np.float32)
    out_j = np.asarray(jposemb.resize_posemb(jnp.asarray(pos), src, dst))
    out_t = to_np(tposemb.resize_posemb(torch.from_numpy(pos), src, dst))
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)


def _types(rng, b, n, n_types=3, pad_frac=0.2):
    t = rng.integers(0, n_types + 1, (b, n))
    return np.where(rng.random((b, n)) < pad_frac, 255, t).astype(np.int32)


def test_zorro_masks_match_jax():
    rng = np.random.default_rng(2)
    types = _types(rng, 2, 40)
    np.testing.assert_array_equal(
        to_np(tattn.zorro_mask_from_padded_types(torch.from_numpy(types), 3, 255)),
        np.asarray(jattn.zorro_mask_from_padded_types(jnp.asarray(types), 3, 255)))
    tq = rng.integers(0, 4, (2, 4)).astype(np.int32)
    tk = rng.integers(0, 4, (2, 40)).astype(np.int32)
    valid = rng.random((2, 40)) < 0.7
    for vk in (None, valid):
        mj = jattn.zorro_mask_from_types(jnp.asarray(tq), jnp.asarray(tk), 3,
                                         valid_k=None if vk is None else jnp.asarray(vk))
        mt = tattn.zorro_mask_from_types(torch.from_numpy(tq), torch.from_numpy(tk), 3,
                                         valid_k=None if vk is None else torch.from_numpy(vk))
        np.testing.assert_array_equal(to_np(mt), np.asarray(mj))


@pytest.mark.parametrize("empty_rows", [False, True])
def test_multihead_attention_matches_jax(empty_rows):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
    mask = rng.random((2, 1, 4, 12)) < 0.5
    mask[:, :, 1] = False  # an all-masked query row
    uniform = rng.random((2, 1, 1, 12)) < 0.6 if empty_rows else None
    oj = jattn.multihead_attention(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(mask),
                                   empty_rows_uniform_over=None if uniform is None
                                   else jnp.asarray(uniform))
    ot = tattn.multihead_attention(*map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask),
                                   empty_rows_uniform_over=None if uniform is None
                                   else torch.from_numpy(uniform))
    np.testing.assert_allclose(to_np(ot), np.asarray(oj), atol=ATOL)


def _flat_mask(rng, b, n, p_masked):
    return (rng.random((b, n)) < p_masked).astype(np.int64)


@pytest.mark.parametrize("e", [48, 24])
def test_packed_layout_matches_jax(e):
    rng = np.random.default_rng(4)
    flat = _flat_mask(rng, 3, 48, 0.5)
    flat[1] = 0
    flat[2, 16:32] = 1  # a dropped modality
    mj = jmask.mask_info_from_flat_mask(jnp.asarray(flat), DOMAINS, (16,) * 3, e)
    mt = tmask.mask_info_from_flat_mask(torch.from_numpy(flat), DOMAINS, (16,) * 3, e)
    for a, b in ((mt.order, mj.order), (mt.ids_restore, mj.ids_restore),
                 (mt.num_visible, mj.num_visible)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    for d in DOMAINS:
        np.testing.assert_array_equal(to_np(mt.task_masks[d]), np.asarray(mj.task_masks[d]))
    tj = jattn.packed_token_types(mj.order, (16,) * 3, e, 16, 3)
    tt = tattn.packed_token_types(mt.order, (16,) * 3, e, 16, 3)
    np.testing.assert_array_equal(to_np(tt), np.asarray(tj))
    np.testing.assert_array_equal(to_np(tattn.packed_valid(mt.num_visible, e, 16)),
                                  np.asarray(jattn.packed_valid(mj.num_visible, e, 16)))


def test_mask_info_from_task_masks_matches_jax():
    rng = np.random.default_rng(5)
    masks = {d: _flat_mask(rng, 2, 16, 0.4) for d in DOMAINS}
    masks["dem"][:] = 1
    mj = jmask.mask_info_from_task_masks({d: jnp.asarray(m) for d, m in masks.items()}, DOMAINS, 48)
    mt = tmask.mask_info_from_task_masks({d: torch.from_numpy(m) for d, m in masks.items()},
                                         DOMAINS, 48)
    for a, b in ((mt.order, mj.order), (mt.ids_restore, mj.ids_restore),
                 (mt.num_visible, mj.num_visible)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    full_t = tmask.full_visible_mask_info(DOMAINS, (16,) * 3, 2)
    full_j = jmask.full_visible_mask_info(DOMAINS, (16,) * 3, 2)
    np.testing.assert_array_equal(to_np(full_t.order), np.asarray(full_j.order))
    np.testing.assert_array_equal(to_np(full_t.num_visible), np.asarray(full_j.num_visible))


@pytest.mark.parametrize("batch_shared,uniform", [(True, False), (False, False), (False, True)])
def test_random_masks_invariants(batch_shared, uniform):
    """The Dirichlet sampler is held to its invariants, not to JAX's bits:
    exactly E visible per row, every task within its size, a permutation
    and its inverse, one mask for the batch when shared, and the same masks
    from the same seed."""
    e, b, n_t = 20, 4, (16, 16, 16)

    def sample(seed):
        return tmask.generate_random_masks(torch.Generator().manual_seed(seed), DOMAINS, n_t, e,
                                           b, sample_tasks_uniformly=uniform,
                                           batch_shared=batch_shared)

    mi = sample(7)
    flat = torch.cat([mi.task_masks[d] for d in DOMAINS], dim=1)
    assert flat.shape == (b, 48)
    assert ((flat == 0).sum(dim=1) == e).all()
    assert (mi.num_visible == e).all()
    for d, n in zip(DOMAINS, n_t):
        vis = (mi.task_masks[d] == 0).sum(dim=1)
        assert ((vis >= 0) & (vis <= n)).all()
    ar = torch.arange(48)
    assert (torch.gather(mi.order, 1, mi.ids_restore) == ar).all()
    assert (flat.gather(1, mi.order[:, :e]) == 0).all()
    if batch_shared:
        assert (flat == flat[:1]).all()
    again = sample(7)
    assert all(torch.equal(again.task_masks[d], mi.task_masks[d]) for d in DOMAINS)


def test_psnr_and_masked_input_match_jax():
    from incomplete_multimodal_fusion_tpu import infer as jinfer
    from incomplete_multimodal_fusion_tpu_torch import infer as tinfer

    rng = np.random.default_rng(8)
    pred = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    target = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    mask = (rng.random((2, 16)) < 0.5).astype(np.int64)
    pj, tj, mj = map(jnp.asarray, (pred, target, mask))
    pt, tt, mt = map(torch.from_numpy, (pred, target, mask))
    np.testing.assert_array_equal(to_np(tinfer.masked_input(pt, mt, 8)),
                                  np.asarray(jinfer.masked_input(pj, mj, 8)))
    np.testing.assert_allclose(float(tinfer.psnr(pt, tt)), float(jinfer.psnr(pj, tj)), rtol=1e-5)
    np.testing.assert_allclose(float(tinfer.masked_psnr(pt, tt, mt, 8)),
                               float(jinfer.masked_psnr(pj, tj, mj, 8)), rtol=1e-5)


def test_synthetic_batch_is_the_jax_package_batch():
    from incomplete_multimodal_fusion_tpu.data import synthetic as jsyn
    from incomplete_multimodal_fusion_tpu_torch.data import synthetic as tsyn

    a = jsyn.synthetic_batch(np.random.default_rng(9), DOMAINS + ("dnw",), 2, 32)
    b = tsyn.synthetic_batch(np.random.default_rng(9), DOMAINS + ("dnw",), 2, 32)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_one_yaml_drives_both_packages():
    from incomplete_multimodal_fusion_tpu import config as jcfg
    from incomplete_multimodal_fusion_tpu_torch import config as tcfg

    text = jcfg.to_yaml(jcfg.PretrainConfig(model=jcfg.MODEL_SIZES["base"]))
    assert tcfg.to_yaml(tcfg.from_yaml(text)) == text
    assert jcfg.to_yaml(jcfg.PretrainConfig()) == tcfg.to_yaml(tcfg.PretrainConfig())
    assert {k: v.__dict__ for k, v in jcfg.MODEL_SIZES.items()} == {
        k: v.__dict__ for k, v in tcfg.MODEL_SIZES.items()}
