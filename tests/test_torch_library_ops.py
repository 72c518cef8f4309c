"""The kernels' operators (ops/library.py) under ``torch.library.opcheck``
on the CPU: each registered operator's schema (no input mutated, no output
aliasing an input), its fake implementation against the real one's shapes
and dtypes, its autograd registration and AOT dispatch (its backward traced
and run), at small shapes in f32 and in bf16. Also: every kernel entry the
model calls is one of them, their namespace is named in ops/library.py
alone, and a graph of the model reaches the kernels only through them."""
from pathlib import Path

import pytest
import torch

from incomplete_multimodal_fusion_tpu_torch.ops import (cuda_attn, cuda_block_attn, cuda_ffn, cuda_fusion_attn,
                                                        cuda_zorro_sparse, library)

ROOT = Path(__file__).resolve().parents[1]


def _r(*shape, seed, scale=1.0, dtype=torch.float32, grad=False):
    g = torch.Generator().manual_seed(seed)
    t = (torch.randn(*shape, generator=g) * scale).to(dtype)
    return t.requires_grad_(grad)


def _types(b, n, pad=1, fusion=2):
    g = torch.Generator().manual_seed(n)
    t = torch.randint(0, 3, (b, n), generator=g, dtype=torch.int32)
    t[:, -fusion:] = 3
    t[:, n - fusion - pad:n - fusion] = cuda_attn.PAD_TYPE
    return t


def _sparse_types():
    t = torch.cat([torch.zeros(1, 100, dtype=torch.int32), torch.ones(1, 100, dtype=torch.int32),
                   torch.full((1, 40), cuda_attn.PAD_TYPE, dtype=torch.int32),
                   torch.full((1, 16), 3, dtype=torch.int32)], dim=1)
    return t


def _cases(dtype):
    """(operator name, arguments) of every operator; forwards with inputs
    that require a gradient, so the autograd registration is exercised."""
    kw = dict(dtype=dtype)
    b, n, heads, dh = 2, 7, 2, 4
    inner = heads * dh
    qkv = _r(b, n, 3 * inner, seed=1, **kw, grad=True)
    types = _types(b, n)
    scale = dh ** -0.5
    o, lse = cuda_attn.zorro_attention_qkv_reference(qkv.detach(), heads, types, 3, return_lse=True)
    o_u, lse_u = cuda_attn.zorro_attention_qkv_reference(qkv.detach(), heads, None, None, return_lse=True)
    do = _r(b, n, inner, seed=2, **kw)
    q, k, v = (_r(b, n, inner, seed=s, **kw, grad=True) for s in (3, 4, 5))
    op_, lsep = cuda_attn.zorro_attention_packed_reference(q.detach(), k.detach(), v.detach(), types, heads, 3,
                                                           return_lse=True)
    sq = _r(1, 256, 3 * 16, seed=6, **kw, grad=True)
    stypes = _sparse_types()
    so, slse = cuda_zorro_sparse.zorro_sparse_attention_qkv_reference(sq.detach(), stypes, 2, 3, return_lse=True)
    sdo = _r(1, 256, 16, seed=7, **kw)
    x = _r(5, 8, seed=8, **kw, grad=True)
    gamma, w_in, w_out = (_r(*s, seed=9 + i, scale=0.3, **kw, grad=True)
                          for i, s in enumerate(((8,), (12, 8), (8, 6))))
    w1, b1, w2, b2 = (_r(*s, seed=12 + i, scale=0.3, **kw, grad=True)
                      for i, s in enumerate(((10, 8), (10,), (16, 10), (16,))))
    xt = _r(3, 5, 8, seed=16, **kw, grad=True)
    tw = [_r(*s, seed=17 + i, scale=0.3, **kw, grad=True)
          for i, s in enumerate(((3, 10, 8), (3, 10), (3, 16, 10), (3, 16)))]
    f, t_mod = 3, 3
    fq, fg, ff = (_r(*s, seed=21 + i, **kw, grad=True)
                  for i, s in enumerate(((b, f, inner), (b, t_mod * f, 2 * inner), (b, f, 2 * inner))))
    bx = _r(b, n, 8, seed=24, **kw, grad=True)
    bw = [_r(*s, seed=25 + i, scale=0.3, **kw, grad=True)
          for i, s in enumerate(((8,), (8,), (inner, 8), (2 * inner, 8), (8, inner)))]

    def plain(t):
        return t.detach()

    return [
        ("zorro_attention_qkv", (qkv, types, heads, 3, scale, True)),
        ("zorro_attention_qkv", (qkv, None, heads, None, scale, True)),
        ("zorro_attention_qkv", (plain(qkv), types, heads, 3, scale, False)),
        ("zorro_attention_qkv_backward", (plain(qkv), types, o, lse, do, heads, 3, scale)),
        ("zorro_attention_qkv_backward", (plain(qkv), None, o_u, lse_u, do, heads, None, scale)),
        ("zorro_attention_packed", (q, k, v, types, heads, 3, scale, True)),
        ("zorro_attention_packed_backward", (plain(q), plain(k), plain(v), types, op_, lsep, do, heads, 3, scale)),
        ("zorro_sparse_attention_qkv", (sq, stypes, 2, 3, 8 ** -0.5, True)),
        ("zorro_sparse_attention_qkv_backward", (plain(sq), stypes, so, slse, sdo, 2, 3, 8 ** -0.5)),
        ("geglu_ffn", (x, gamma, w_in, w_out)),
        ("geglu_ffn_backward", tuple(map(plain, (x, gamma, w_in, w_out))) + (_r(5, 8, seed=30, **kw),)),
        ("mlp_ffn", (x, w1, b1, w2, b2)),
        ("mlp_ffn_backward", tuple(map(plain, (x, w1, b1, w2, b2))) + (_r(5, 16, seed=31, **kw),)),
        ("mlp_ffn_tasks", (xt, *tw)),
        ("fusion_row_attention", (fq, fg, ff, heads, dh)),
        ("fusion_row_attention_backward", tuple(map(plain, (fq, fg, ff))) + (_r(b, f, inner, seed=32, **kw),
                                                                             heads, dh)),
        ("fused_block_attn", (bx, types, *bw, heads, 3)),
        ("fused_block_attn_backward", (plain(bx), types, *map(plain, bw), _r(b, n, 8, seed=33, **kw), heads, 3)),
    ]


def _ids(dtype):
    seen = {}
    out = []
    for name, _ in _cases(dtype):
        seen[name] = seen.get(name, 0) + 1
        out.append(f"{name}-{seen[name]}")
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(_cases(torch.float32))), ids=_ids(torch.float32))
def test_opcheck(dtype, case):
    name, args = _cases(dtype)[case]
    torch.library.opcheck(library.operators()[name], args)


def test_every_kernel_entry_is_an_operator():
    assert set(library.operators()) == {
        "zorro_attention_qkv", "zorro_attention_qkv_backward", "zorro_attention_packed",
        "zorro_attention_packed_backward", "zorro_sparse_attention_qkv", "zorro_sparse_attention_qkv_backward",
        "geglu_ffn", "geglu_ffn_backward", "mlp_ffn", "mlp_ffn_backward", "mlp_ffn_tasks",
        "fusion_row_attention", "fusion_row_attention_backward", "fused_block_attn", "fused_block_attn_backward"}
    for op in library.operators().values():
        assert library.is_kernel_op(op)


def test_the_namespace_is_named_in_the_library_alone():
    pkg = ROOT / "incomplete_multimodal_fusion_tpu_torch"
    named = [p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py") if library.NAMESPACE in p.read_text()]
    assert named == ["ops/library.py"]


def test_fake_implementations_read_no_data():
    """Under a fake mode (what torch.export and torch.compile trace with)
    every forward gives its outputs' shapes and dtypes without a real
    tensor; on the meta device itself, as on any device without a kernel,
    a call raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        qkv = mode.from_tensor(torch.empty(2, 640, 576, dtype=torch.bfloat16, device="cpu"))
        types = mode.from_tensor(torch.empty(2, 640, dtype=torch.int32))
        out, lse = library.operators()["zorro_attention_qkv"](qkv, types, 3, 3, 0.125, True)
        assert out.shape == (2, 640, 192) and out.dtype == torch.bfloat16
        assert lse.shape == (2, 3, 640) and lse.dtype == torch.float32
        x = mode.from_tensor(torch.empty(3, 512, 256, dtype=torch.bfloat16))
        w1, b1 = mode.from_tensor(torch.empty(3, 1024, 256)), mode.from_tensor(torch.empty(3, 1024))
        w2, b2 = mode.from_tensor(torch.empty(3, 128, 1024)), mode.from_tensor(torch.empty(3, 128))
        assert cuda_ffn.mlp_ffn_tasks(x, w1, b1, w2, b2).shape == (3, 512, 128)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_fusion_attn.fusion_row_attention(*(torch.empty(s, device="meta") for s in ((1, 4, 32), (1, 12, 64),
                                                                                       (1, 4, 64))), 1, 32)


def test_the_thin_function_forms_call_the_operators():
    """The autograd-Function calling forms are the operators themselves:
    on the CPU the plain forward and its gradient, no kernel launched."""
    from incomplete_multimodal_fusion_tpu_torch import ops

    ops.reset_kernel_launches()
    x = _r(4, 8, seed=40, grad=True)
    w = [_r(*s, seed=41 + i, scale=0.3, grad=True) for i, s in enumerate(((8,), (12, 8), (8, 6)))]
    cuda_ffn.GegluFFN.apply(x, *w).sum().backward()
    torch.testing.assert_close(x.grad, cuda_ffn.geglu_ffn_backward_reference(
        x.detach(), *(t.detach() for t in w), torch.ones(4, 8))[0])
    bx = _r(1, 7, 8, seed=45, grad=True)
    bw = [_r(*s, seed=46 + i, scale=0.3) for i, s in enumerate(((8,), (8,), (8, 8), (16, 8), (8, 8)))]
    cuda_block_attn.FusedBlockAttn.apply(bx, _types(1, 7), *bw, 2, 3).sum().backward()
    assert bx.grad is not None and all(n == 0 for n in ops.kernel_launches().values())
