"""The hand-written kernels at the shapes tensor parallelism gives them
(parallel/sharding.py), forward and backward, against their plain PyTorch
versions on the card, in bf16:

  * K2 / K2b GEGLU at the encoder's rows of a rank (M = 30 or 60 images x
    640 tokens, and a microbatch's) with ``tiny``'s inner width cut in two
    (I = 256) and in four (I = 128);
  * K2 / K2b MLP at the decoder's rows with its hidden width cut in two
    (H = 512) and four (H = 256);
  * K1 / K1b zorro mode over fewer heads a rank (of a 4-head, 64-wide
    encoder at tp 2 and 4), K1 / K1b unmasked at the decoder's 4 and 2
    heads of 32;
  * K3 / K3b over a rank's heads (of 4 at tp 2 and 4);
  * the data-parallel downstream step's dropout (``models.layers.Dropout``
    with a share): a rank's rows of ``F.dropout``'s mask over the global
    batch, bitwise, at the pixel decoder's widths.

These tests need a CUDA card and skip without one; on a card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_parallel_cuda.py -q

(this file imports nothing of JAX).
"""
import pytest
import torch
import torch.nn.functional as F

from incomplete_multimodal_fusion_tpu_torch.models.layers import Dropout
from incomplete_multimodal_fusion_tpu_torch.ops import cuda_attn, cuda_ffn, cuda_fusion_attn

pytestmark = pytest.mark.cuda

REL_L2 = 2e-2  # bf16 kernel vs bf16 plain version on the same inputs


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(dev, *shape, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, device=dev, generator=g) * scale).to(torch.bfloat16)


def _rel(a, b):
    """rel-L2; a reference that is zero in exact arithmetic is measured
    against a norm of 1e-3."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm()) / max(float(b.norm()), 1e-3)


@pytest.mark.parametrize("m", [60 * 640, 30 * 640, 15 * 640])
@pytest.mark.parametrize("inner", [256, 128])
def test_geglu_at_a_ranks_inner_width(dev, m, inner):
    d = 192
    x, dy = _randn(dev, m, d, seed=1), _randn(dev, m, d, seed=2)
    gamma = (1 + 0.1 * _randn(dev, d, seed=3).float()).to(torch.bfloat16)
    w_in, w_out = _randn(dev, 2 * inner, d, scale=d ** -0.5, seed=4), _randn(dev, d, inner, scale=inner ** -0.5,
                                                                             seed=5)
    out = cuda_ffn.geglu_ffn(x, gamma, w_in, w_out)
    ref = cuda_ffn.geglu_ffn_reference(x, gamma, w_in, w_out)
    grads = cuda_ffn.geglu_ffn_backward(x, gamma, w_in, w_out, dy)
    ref_grads = cuda_ffn.geglu_ffn_backward_reference(x, gamma, w_in, w_out, dy)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= REL_L2
    assert max(_rel(g, r) for g, r in zip(grads, ref_grads)) <= REL_L2


@pytest.mark.parametrize("m", [60 * 256, 30 * 256])
@pytest.mark.parametrize("hidden", [512, 256])
def test_mlp_at_a_ranks_hidden_width(dev, m, hidden):
    d = out_dim = 256
    x, dy = _randn(dev, m, d, seed=6), _randn(dev, m, out_dim, seed=7)
    w1, b1 = _randn(dev, hidden, d, scale=d ** -0.5, seed=8), _randn(dev, hidden, scale=0.1, seed=9)
    w2 = _randn(dev, out_dim, hidden, scale=hidden ** -0.5, seed=10)
    b2 = torch.zeros(out_dim, dtype=torch.bfloat16, device=dev)  # the bias joins after the all-reduce
    out = cuda_ffn.mlp_ffn(x, w1, b1, w2, b2)
    ref = cuda_ffn.mlp_ffn_reference(x, w1, b1, w2, b2)
    grads = cuda_ffn.mlp_ffn_backward(x, w1, b1, w2, b2, dy)
    ref_grads = cuda_ffn.mlp_ffn_backward_reference(x, w1, b1, w2, b2, dy)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= REL_L2
    assert max(_rel(g, r) for g, r in zip(grads, ref_grads)) <= REL_L2


def _types(dev, b, e=384, f=256, visible=330, t_mod=3):
    """K1's packed types: ``visible`` slots of the modalities, PAD to e, the
    fusion tokens."""
    row = [i % t_mod for i in range(visible)] + [255] * (e - visible) + [t_mod] * f
    return torch.tensor([row] * b, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("heads", [2, 1])
def test_zorro_attention_at_a_ranks_heads(dev, heads):
    b, dh = 8, 64
    types = _types(dev, b)
    qkv = _randn(dev, b, types.shape[1], 3 * heads * dh, seed=11)
    out, lse = cuda_attn.zorro_attention_qkv(qkv, heads, types, 3, return_lse=True)
    ref, ref_lse = cuda_attn.zorro_attention_qkv_reference(qkv, heads, types, 3, return_lse=True)
    do = _randn(dev, *out.shape, seed=12)
    dqkv = cuda_attn.zorro_attention_qkv_backward(qkv, types, out, lse, do, heads, 3)
    ref_dqkv = cuda_attn.zorro_attention_qkv_backward_reference(qkv, types, ref, ref_lse, do, heads, 3)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= REL_L2
    assert max(_rel(a, r) for a, r in zip(dqkv.chunk(3, dim=-1), ref_dqkv.chunk(3, dim=-1))) <= REL_L2


@pytest.mark.parametrize("heads", [4, 2])
def test_unmasked_attention_at_the_decoders_heads(dev, heads):
    b, n, dh = 30, 256, 32
    qkv = _randn(dev, b, n, 3 * heads * dh, seed=13)
    out, lse = cuda_attn.zorro_attention_qkv(qkv, heads, return_lse=True)
    ref, ref_lse = cuda_attn.zorro_attention_qkv_reference(qkv, heads, return_lse=True)
    do = _randn(dev, *out.shape, seed=14)
    dqkv = cuda_attn.zorro_attention_qkv_backward(qkv, None, out, lse, do, heads)
    ref_dqkv = cuda_attn.zorro_attention_qkv_backward_reference(qkv, None, ref, ref_lse, do, heads)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= REL_L2
    assert max(_rel(a, r) for a, r in zip(dqkv.chunk(3, dim=-1), ref_dqkv.chunk(3, dim=-1))) <= REL_L2


@pytest.mark.parametrize("heads", [2, 1])
def test_fusion_row_attention_at_a_ranks_heads(dev, heads):
    b, f, t_mod, dh = 8, 256, 3, 64
    inner = heads * dh
    q = _randn(dev, b, f, inner, seed=15)
    kvg, kvf = _randn(dev, b, t_mod * f, 2 * inner, seed=16), _randn(dev, b, f, 2 * inner, seed=17)
    q.requires_grad_(True)
    kvg.requires_grad_(True)
    kvf.requires_grad_(True)
    out = cuda_fusion_attn.fusion_row_attention(q, kvg, kvf, heads, dh)
    ref = cuda_fusion_attn.fusion_row_attention_reference(q, kvg, kvf, heads, dh)
    do = _randn(dev, *out.shape, seed=18)
    grads = torch.autograd.grad(out, (q, kvg, kvf), do)
    ref_grads = torch.autograd.grad(ref, (q, kvg, kvf), do)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= REL_L2
    assert max(_rel(g, r) for g, r in zip(grads, ref_grads)) <= REL_L2


@pytest.mark.parametrize("rank", [0, 1])
def test_dropout_share_is_the_global_batch_rows(dev, rank):
    """A rank of 2 holding 15 of the 30 rows drops, under one seed, what
    ``F.dropout`` (``nn.Dropout``) drops for those rows of the global batch
    [30, 1344, 1024] (the pixel decoder's FFN, f32)."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(30, 1344, 1024, device=dev, generator=g)
    rows = slice(15 * rank, 15 * (rank + 1))
    torch.manual_seed(7)
    want = F.dropout(x, 0.1, training=True)[rows]
    part = Dropout(0.1)
    part.share = (rank, 2)
    torch.manual_seed(7)
    got = part(x[rows])
    assert torch.equal(got, want)
