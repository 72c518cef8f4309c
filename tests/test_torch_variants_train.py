"""The pretraining step of each variant against the JAX package's, f32 on the
CPU, at tests/test_variants.py's widths: three steps from the same random
parameters and injected masks (a modality dropped in row 1, so the 2E
layout's padding sits mid-sequence) against JAX ``create_train_state`` /
``make_train_step`` (``fused_adamw=True``), at the bounds of
tests/test_torch_pretrain_state.py: each step's losses and gradient norm
rtol 1e-4, the final masters within relative L2 1e-4 a tensor. Left out:
the key part of the decoders' qkv and the full decoder's kv biases and the
BiLSTM score's bias, whose gradient is zero in exact arithmetic (a softmax
is shift-invariant), so Adam turns rounding noise there into steps of size
lr whose signs neither framework decides.
The other modes and the layer-wise LR decay: tests/test_torch_variants_train_more.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu import config as jconfig
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.train import pretrain as jpretrain
from incomplete_multimodal_fusion_tpu_torch import config as tconfig
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.train import pretrain as tpretrain
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import as_jax, random_params, to_np
from tests.test_torch_variants import NP_, QUAD, TRIPLE, B, E, batch, flat_mask

STEPS = 6
MODES = {
    "zorro": ("zorro", "simple", TRIPLE),
    "lstm": ("lstm", "simple", TRIPLE),
    "crossattn_v1": ("crossattn_v1", "simple", TRIPLE),
    "crossattn-full": ("crossattn", "full", TRIPLE),
    "quadruplet-crossattn": ("crossattn", "simple", QUAD),
}
HERE = ("zorro", "lstm", "crossattn_v1")  # the rest in tests/test_torch_variants_train_more.py


def _cfg(mod, mode, style, domains):
    return mod.PretrainConfig(
        model=mod.ModelConfig(dim_tokens=32, depth=2, dim_head=8, heads=2, ff_mult=2, num_fusion_tokens=NP_,
                              fusion_mode=mode),
        data=mod.DataConfig(input_size=64, patch_size=16, batch_size=B, in_domains=domains, out_domains=domains),
        mask=mod.MaskConfig(num_encoded_tokens=E),
        decoder=mod.DecoderConfig(dim=32, depth=1, num_heads=2, style=style),
        optim=mod.OptimConfig(blr=1.0, warmup_epochs=0, min_lr=1e-4, fused_adamw=True),
        train=mod.TrainConfig(epochs=1, compute_dtype="float32"))


def _masks(domains, k):
    return flat_mask(domains, 20 + k, dropped=(k + 1) % len(domains))


def jax_run(name):
    mode, style, domains = MODES[name]
    cfg = _cfg(jconfig, mode, style, domains)
    x = batch(domains, 7)
    model, state, tx = jpretrain.create_train_state(cfg, jax.random.PRNGKey(0), STEPS)
    params = random_params(model, 3, as_jax(x), jmask.full_visible_mask_info(domains, (NP_,) * len(domains), B),
                           NP_ * len(domains))
    state = state.replace(params=params)
    held = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jpretrain.masking, "generate_random_masks",
               lambda *a, **k: jmask.mask_info_from_flat_mask(held["flat"], domains, (NP_,) * len(domains), E))
    raw = jpretrain.make_train_step(model, cfg, tx)

    @jax.jit
    def step(state, batch, flat):
        held["flat"] = flat
        return raw(state, batch)

    metrics = []
    try:
        for k in range(3):
            state, m = step(state, as_jax(x), jnp.asarray(_masks(domains, k)))
            metrics.append(jax.tree.map(np.asarray, m))
    finally:
        mp.undo()
    return x, params, state, metrics


def rel_l2(got, want, what):
    got, want = to_np(got).astype(np.float64), np.asarray(want, np.float64)
    if what.endswith("attn.qkv.bias"):
        third = want.shape[0] // 3
        got, want = np.delete(got, np.s_[third:2 * third]), np.delete(want, np.s_[third:2 * third])
    if what.endswith("decoder.kv.bias"):
        half = want.shape[0] // 2
        got, want = got[half:], want[half:]
    if what == "attn_lstm.attention.bias":
        return
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= 1e-4, f"{what}: relative L2 {err}"


def three_steps_match_jax(name):
    mode, style, domains = MODES[name]
    x, params, final, jmetrics = jax_run(name)
    cfg = _cfg(tconfig, mode, style, domains)
    model, state, optimizer = tpretrain.create_train_state(cfg, 0, total_steps=STEPS, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    step = tpretrain.make_train_step(model, cfg, optimizer)
    for k in range(3):
        flat = torch.from_numpy(_masks(domains, k))
        mi = tmask.mask_info_from_flat_mask(flat, domains, (NP_,) * len(domains), E)
        state, metrics = step(state, x, mask_info=mi)
        for key in ["loss", "recon_loss", "contra_loss", "grad_norm"] + [f"{d}_loss" for d in domains]:
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[k][key]), rtol=1e-4,
                                       err_msg=f"step {k}: {key}")
    assert int(optimizer.count) == int(final.opt_state.count) == 3
    own = dict(model.named_parameters())
    for pname, want in params_from_jax(jax.tree.map(np.asarray, final.params)).items():
        rel_l2(own[pname], want, pname)


@pytest.mark.parametrize("name", HERE)
def test_three_steps_match_jax(name):
    three_steps_match_jax(name)
