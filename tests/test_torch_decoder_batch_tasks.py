"""The batched decoder trunk (``decoder_batch_tasks=True``): the T tasks'
trunks as one chain over a task axis, K1 over the T * B rows and K2's MLP
with its task axis (``cuda_ffn.mlp_ffn_tasks``). Against the JAX package's
batched decoder (multimae.py:237-296, ``jax.vmap`` over the stacked trunk)
on the same weights and inputs, forward (atol 1e-5) and every gradient (the
setting and bounds of tests/test_model.py's
``test_batched_grads_match_sequential``), and against the port's own
per-task decoder; the task-axis MLP's plain version against T calls of the
plain MLP, bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu.models.multimae import MultiMAE as JaxMultiMAE
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu_torch.models.multimae import MultiMAE as TorchMultiMAE
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_ffn
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import CHANNELS, DOMAINS, NP_, SMALL, as_jax, as_torch, port_module, random_params, \
    to_np

B = 2
CAPACITY = NP_ * len(DOMAINS)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(7)
    x = {d: rng.standard_normal((B, 64, 64, CHANNELS[d])).astype(np.float32) for d in DOMAINS}
    jm = JaxMultiMAE(attn_impl="auto", decoder_batch_tasks=True, **SMALL)
    mi = jmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, B)
    params = random_params(jm, 3, as_jax(x), mi, CAPACITY)
    batched = port_module(TorchMultiMAE(attn_impl="auto", decoder_batch_tasks=True, **SMALL), params)
    per_task = port_module(TorchMultiMAE(attn_impl="auto", **SMALL), params)
    return jm, params, batched, per_task, x


def _flat_mask():
    flat = (np.random.default_rng(3).random((B, CAPACITY)) < 0.6).astype(np.int64)
    flat[1, NP_:2 * NP_] = 1  # row 1 has no visible s2 token
    return flat


def test_batched_forward_matches_jax(models):
    jm, params, batched, _, x = models
    flat = _flat_mask()
    e = 24
    jmi = jmask.mask_info_from_flat_mask(jnp.asarray(flat), DOMAINS, (NP_,) * 3, e)
    tmi = tmask.mask_info_from_flat_mask(torch.from_numpy(flat), DOMAINS, (NP_,) * 3, e)
    ref = jax.jit(lambda p, xx: jm.apply({"params": p}, xx, jmi, e))(params, as_jax(x))
    with torch.no_grad():
        out = batched(as_torch(x), tmi, e)
    for d in DOMAINS:
        np.testing.assert_allclose(to_np(out["preds"][d]), np.asarray(ref["preds"][d]), atol=1e-5, err_msg=d)
        np.testing.assert_allclose(to_np(out["preds_patch"][d]), np.asarray(ref["preds_patch"][d]), atol=1e-5)


def _port_grads(model, x, mi):
    model.zero_grad(set_to_none=True)
    out = model(as_torch(x), mi, CAPACITY)
    sum(torch.sum(v ** 2) for v in out["preds"].values()).backward()
    return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


# tests/test_model.py's tiny_model and its batch(8): the setting of its
# test_batched_grads_match_sequential, weights from the flax init
TINY = dict(in_domains=DOMAINS, out_domains=DOMAINS, image_size=64, patch_size=16, dim_tokens=32, depth=2,
            dim_head=8, heads=2, ff_mult=2, num_fusion_tokens=NP_, decoder_dim=32, decoder_depth=1,
            decoder_num_heads=2)


def _grad_atol(name, ref):
    """The JAX test's atol, 1e-4; for the encoder's tensors, whose entries
    reach a few hundred here (the input adapters' sums over every pixel),
    at least 2e-6 of the tensor's largest entry: the port's per-task
    decoder misses 1e-4 there against JAX by up to 3.5e-4 too (the input
    adapters of s2 and dem), from the order of f32 sums, not the decoder."""
    return 1e-4 if name.startswith("output_adapters.") else max(1e-4, 2e-6 * float(np.abs(np.asarray(ref)).max()))


def test_batched_gradients_match_jax():
    """Every gradient of sum(preds^2) at full visibility, in the JAX test's
    setting (its tiny model, flax-initialized weights, its inputs) and with
    its bounds (rtol 1e-3, atol 1e-4 on the decoder's tensors, which the
    batching changes: the stacked and the sequential chains sum in
    different orders; ``_grad_atol`` on the encoder's)."""
    r = np.random.default_rng(8)
    x = {d: r.standard_normal((B, 64, 64, CHANNELS[d])).astype(np.float32) for d in DOMAINS}
    jm = JaxMultiMAE(decoder_batch_tasks=True, **TINY)
    jmi = jmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, B)
    x0 = {d: jnp.asarray(np.random.default_rng(0).standard_normal((B, 64, 64, CHANNELS[d])), jnp.float32)
          for d in DOMAINS}
    params = JaxMultiMAE(**TINY).init(jax.random.PRNGKey(0), x0, jmi, CAPACITY)["params"]

    def loss(p):
        out = jm.apply({"params": p}, as_jax(x), jmi, CAPACITY)
        return sum(jnp.sum(v ** 2) for v in out["preds"].values())

    ref = params_from_jax(jax.jit(jax.grad(loss))(params))
    batched = port_module(TorchMultiMAE(attn_impl="auto", decoder_batch_tasks=True, **TINY), params)
    got = _port_grads(batched, x, tmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, B))
    decoder = [n for n in got if n.startswith("output_adapters.")]
    assert decoder and len(decoder) == len([n for n in ref if n.startswith("output_adapters.")])
    for name, g in got.items():
        np.testing.assert_allclose(to_np(g), np.asarray(ref[name]), rtol=1e-3, atol=_grad_atol(name, ref[name]),
                                   err_msg=name)


def test_batched_matches_the_per_task_decoder(models):
    """The port's two decoders on the same weights: forward and every
    gradient, at JAX's own bounds between its two decoders."""
    _, _, batched, per_task, x = models
    tmi = tmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, B)
    with torch.no_grad():
        ob, os_ = batched(as_torch(x), tmi, CAPACITY), per_task(as_torch(x), tmi, CAPACITY)
    for d in DOMAINS:
        np.testing.assert_allclose(to_np(ob["preds"][d]), to_np(os_["preds"][d]), atol=1e-5, err_msg=d)
    gb, gs = _port_grads(batched, x, tmi), _port_grads(per_task, x, tmi)
    assert gb.keys() == gs.keys()
    for name in gb:
        np.testing.assert_allclose(to_np(gb[name]), to_np(gs[name]), rtol=1e-3, atol=_grad_atol(name, to_np(gs[name])),
                                   err_msg=name)


def test_one_task_or_unequal_trunks_run_per_task():
    """A single task, or trunks that differ in shape, take the per-task
    loop, as in JAX (multimae.py:264-267): no task-axis MLP in the graph."""
    from incomplete_multimodal_fusion_tpu_torch.ops import library

    cfg = dict(SMALL, out_domains=("s2",))
    model = TorchMultiMAE(attn_impl="auto", decoder_batch_tasks=True, **cfg).eval()
    model.init_weights(torch.Generator().manual_seed(0))
    x = {d: torch.randn(1, 64, 64, CHANNELS[d]) for d in DOMAINS}
    mi = tmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, 1)

    class Fwd(torch.nn.Module):
        def forward(self, *xs):
            return model(dict(zip(DOMAINS, xs)), mi, CAPACITY)["preds"]

    ep = torch.export.export(Fwd(), tuple(x[d] for d in DOMAINS), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes if library.is_kernel_op(n.target)]
    assert targets.count("imf_torch.mlp_ffn_tasks.default") == 0
    assert targets.count("imf_torch.mlp_ffn.default") == SMALL["decoder_depth"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_task_axis_plain_version_is_t_plain_mlps_bitwise(dtype):
    g = torch.Generator().manual_seed(5)
    t, m, d, h, o = 3, 40, 32, 64, 48
    x, w1, b1 = torch.randn(t, m, d, generator=g), torch.randn(t, h, d, generator=g), torch.randn(t, h, generator=g)
    w2, b2 = torch.randn(t, o, h, generator=g), torch.randn(t, o, generator=g)
    args = [v.to(dtype) for v in (x, w1, b1, w2, b2)]
    got = cuda_ffn.mlp_ffn_tasks(*args)  # the operator: its CPU implementation is the plain version
    assert got.shape == (t, m, o) and got.dtype == dtype
    for i in range(t):
        assert torch.equal(got[i], cuda_ffn.mlp_ffn_reference(*(v[i] for v in args)))
