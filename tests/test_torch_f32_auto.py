"""f32 under attn_impl='auto' on the CPU, where the kernels' autograd
Functions run their plain forward and backward (a CUDA tensor would reach
the kernel wrappers, which take bf16 only and refuse f32):

  * the SMALL MultiMAE forward (every encoder block on the fused K6 route)
    and one pretraining step in f32 under 'auto' call every kernel's
    Function and agree with 'xla' within rel 1e-5 on the same weights and
    injected ``MaskInfo``.
"""
import numpy as np
import torch

from incomplete_multimodal_fusion_tpu_torch import config as tconfig
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch
from incomplete_multimodal_fusion_tpu_torch.models.multimae import MultiMAE
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_attn, cuda_block_attn, cuda_ffn, cuda_fusion_attn
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask
from incomplete_multimodal_fusion_tpu_torch.train import pretrain as tpretrain
from tests.test_torch_common import CHANNELS, DOMAINS, NP_, SMALL


def _flat_mask(b, e, seed=5):
    rng = np.random.default_rng(seed)
    flat = np.ones((b, NP_ * len(DOMAINS)), np.int64)
    for row in flat:
        row[rng.permutation(row.size)[:e]] = 0
    return torch.from_numpy(flat)


def _images(b, seed=6):
    g = torch.Generator().manual_seed(seed)
    return {d: torch.randn(b, 64, 64, CHANNELS[d], generator=g) for d in DOMAINS}


WRAPPERS = ((cuda_attn, ("zorro_attention_qkv", "zorro_attention_qkv_backward")),
            (cuda_ffn, ("geglu_ffn", "mlp_ffn", "geglu_ffn_backward", "mlp_ffn_backward")),
            (cuda_fusion_attn, ("fusion_row_attention", "fusion_row_attention_backward")),
            (cuda_block_attn, ("fused_block_attn", "fused_block_attn_backward")))


def _count_wrapper_calls(monkeypatch):
    """Counts each kernel wrapper's calls (each still runs, here its plain
    version on the CPU tensors)."""
    calls = {name: 0 for _, names in WRAPPERS for name in names}
    for module, names in WRAPPERS:
        for name in names:
            def spy(*args, _real=getattr(module, name), _name=name, **kwargs):
                calls[_name] += 1
                return _real(*args, **kwargs)
            monkeypatch.setattr(module, name, spy)
    return calls


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-12))


def test_f32_forward_under_auto_calls_the_functions_and_matches_xla(monkeypatch):
    """Every forward wrapper of the path runs (on the CPU, its plain
    version) under 'auto', none under 'xla'; the outputs agree."""
    torch.manual_seed(4)
    model = MultiMAE(**{**SMALL, "dim_head": 32}).eval()  # I = 64: the fused route takes the blocks
    for blk in model.blocks:
        blk.fused_block = True
    mi = tmask.mask_info_from_flat_mask(_flat_mask(2, 24, seed=8), DOMAINS, (NP_,) * 3, 24)
    x = _images(2, seed=9)
    outs, calls = {}, _count_wrapper_calls(monkeypatch)
    for impl in ("auto", "xla"):
        model.attn_impl = impl
        with torch.no_grad():
            outs[impl] = model(x, mi, 24)
        if impl == "auto":
            called = {name for name, n in calls.items() if n}
            assert called == {"zorro_attention_qkv", "geglu_ffn", "mlp_ffn", "fusion_row_attention",
                              "fused_block_attn"}, called
            calls.update(dict.fromkeys(calls, 0))
    assert not any(calls.values())
    for d in DOMAINS:
        assert _rel(outs["auto"]["preds"][d], outs["xla"]["preds"][d]) <= 1e-5
        assert _rel(outs["auto"]["pooled_mod"][d], outs["xla"]["pooled_mod"][d]) <= 1e-5


def _cfg():
    return tconfig.PretrainConfig(
        model=tconfig.ModelConfig(dim_tokens=64, depth=2, dim_head=16, heads=2, ff_mult=4, num_fusion_tokens=16),
        data=tconfig.DataConfig(input_size=64, patch_size=16, batch_size=2),
        mask=tconfig.MaskConfig(num_encoded_tokens=24),
        decoder=tconfig.DecoderConfig(dim=32, depth=2, num_heads=2),
        optim=tconfig.OptimConfig(blr=1.0, warmup_epochs=0, min_lr=1e-4),
        train=tconfig.TrainConfig(epochs=1, compute_dtype="float32"))


def test_f32_pretraining_step_under_auto_calls_the_functions_and_matches_xla(monkeypatch):
    """One f32 step from the same state under 'auto' (every forward and
    backward wrapper of the path called) and 'xla': the loss and the
    gradient norm within rel 1e-5, every updated weight finite. (The
    weights are not compared: AdamW's first update is lr * sign(g), so a
    gradient that is zero but for rounding, as the key bias's is, moves by
    +-lr on either side; test_torch_train holds the gradients themselves.)"""
    cfg = _cfg()
    batch = synthetic_batch(np.random.default_rng(2), DOMAINS, 2, 64)
    mi = tmask.mask_info_from_flat_mask(_flat_mask(2, 24, seed=11), DOMAINS, (NP_,) * 3, 24)
    results, calls = {}, _count_wrapper_calls(monkeypatch)
    for impl in ("auto", "xla"):
        model, state, optimizer = tpretrain.create_train_state(cfg, 0, total_steps=4, device="cpu")
        assert model.attn_impl == "auto"
        model.attn_impl = impl
        _, metrics = tpretrain.make_train_step(model, cfg, optimizer)(state, batch, mask_info=mi)
        results[impl] = (metrics, {n: p.detach().clone() for n, p in model.named_parameters()})
        called = {name for name, n in calls.items() if n}
        assert called == (set(calls) - {"fused_block_attn", "fused_block_attn_backward"} if impl == "auto"
                          else set()), called
        calls.update(dict.fromkeys(calls, 0))
    (m_a, p_a), (m_x, p_x) = results["auto"], results["xla"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m_a[key]), float(m_x[key]), rtol=1e-5, err_msg=key)
    assert set(p_a) == set(p_x) and all(torch.isfinite(p).all() for p in p_a.values())
