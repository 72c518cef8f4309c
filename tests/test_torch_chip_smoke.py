"""The card smoke's own bookkeeping, checked on the CPU: every kernel entry
of its kernels line (the f32 instances' too) has the device kernels that
phase 3 times apart from the wrapper's host work, and each of their names
is a kernel of the entry's CUDA source; every f32 C entry a wrapper binds
is defined in csrc/; without a card the script fails and prints no
result."""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _source_text(path: Path) -> str:
    """A CUDA source with the csrc/ headers it includes, recursively."""
    text = path.read_text()
    for header in re.findall(r'#include "(\w+\.cuh)"', text):
        text += _source_text(path.parent / header)
    return text


def _kernels_of(source: Path):
    """The names of the __global__ functions a CUDA source compiles."""
    return set(re.findall(r"__global__ void(?: __launch_bounds__\((?:[^()]|\([^()]*\))*\))?\s+(\w+)",
                          _source_text(source)))


def test_every_kernel_entry_has_its_device_kernels(smoke):
    for entry, (source, _) in smoke.REPLACES.items():
        names, per_call = smoke.entry_kernels(entry)
        assert per_call >= 1 and names, entry
        kernels = _kernels_of(ROOT / smoke.PKG / source)
        for name in names:
            assert any(name in k for k in kernels), (entry, name, sorted(kernels))


@pytest.mark.parametrize("entry,kernels", [
    ("fused_ffn/geglu_backward", 3), ("fused_ffn/mlp_backward", 3), ("point_sample/forward", 1),
    ("point_sample/backward", 1), ("zorro_attention_qkv/zorro_backward", 2), ("fused_block_attn/backward", 8),
    ("fused_block_attn/forward", 3), ("fused_ffn/geglu", 1), ("fused_ffn/mlp", 1), ("ms_deform_attn/backward", 1), ("ms_deform_attn/forward", 1),
    ("fusion_row_attention/fusion_row_backward", 1), ("fusion_row_attention/fusion_row", 1)])
def test_kernels_per_call(smoke, entry, kernels):
    assert smoke.entry_kernels(entry)[1] == kernels


def test_k6_launches_are_the_ones_profiled(smoke):
    """K6 launches its projection pass, K1's forward and its out
    projection; K6b its projection pass, dout, K1's forward with the D
    epilogue, K1b's dq and dk/dv kernels, its row pass and wgrad.cuh's
    product and reduction: phase 3 profiles each by its name, and no K6
    kernel is left out."""
    source = ROOT / smoke.PKG / "csrc" / "fused_block_attn.cu"
    kernels = _kernels_of(source)
    own = {k for k in kernels if "block_attn" in k}
    assert own == {"block_attn_proj_kernel", "block_attn_out_kernel", "block_attn_dout_kernel",
                   "block_attn_bwd_rows_kernel"}
    for entry, used in (("fused_block_attn/forward", {"block_attn_proj_kernel", "block_attn_out_kernel",
                                                      "zorro_attention_kernel"}),
                        ("fused_block_attn/backward", own - {"block_attn_out_kernel"} | {
                            "zorro_attention_kernel", "zorro_attention_dq_kernel", "zorro_attention_dkdv_kernel",
                            "wgrad_kernel", "wgrad_reduce_kernel"})):
        names, per_call = smoke.entry_kernels(entry)
        assert per_call == len(used) and used <= kernels
        assert all(any(n in k for n in names) for k in used), entry
    assert "atomicAdd" not in source.read_text()


def test_every_forward_kernel_of_k2_is_profiled(smoke):
    """K2's forward launches its row kernel, with its split's reduction at
    small M, or its wide path's kernels; phase 3 profiles them all by one
    name."""
    names, _ = smoke.entry_kernels("fused_ffn/geglu")
    # the bf16 instance's kernels (the f32 instance's simt_f32 kernels have
    # their own entry)
    kernels_of_source = {k for k in _kernels_of(ROOT / smoke.PKG / "csrc" / "fused_ffn.cu") if "f32" not in k}
    assert {"ffn_fwd_rows_kernel", "ffn_fwd_split_reduce_kernel", "ffn_fwd_wide_norm_kernel",
            "ffn_fwd_wide_act_kernel", "ffn_fwd_wide_out_kernel"} == kernels_of_source
    assert all(any(n in k for n in names) for k in kernels_of_source)


def test_every_backward_kernel_of_k4b_is_profiled(smoke):
    """K4b launches its kernel and, where a slice's queries split over
    blocks, the reduction of the partial slices; phase 3 profiles both by
    one name."""
    names, _ = smoke.entry_kernels("ms_deform_attn/backward")
    kernels_of_source = _kernels_of(ROOT / smoke.PKG / "csrc" / "ms_deform_attn.cu")
    assert {"ms_deform_attn_bwd_kernel", "ms_deform_attn_bwd_reduce_kernel"} <= kernels_of_source
    assert all(any(n in k for n in names) for k in kernels_of_source if "bwd" in k)


@pytest.mark.parametrize("entry,source,kernels", [
    ("ms_deform_attn/forward", "ms_deform_attn.cu", {"ms_deform_attn_fwd_kernel"}),
    ("fusion_row_attention/fusion_row_backward", "fusion_row_attention.cu", {"fusion_row_bwd_kernel"}),
    ("fusion_row_attention/fusion_row", "fusion_row_attention.cu", {"fusion_row_kernel"}),
    ("point_sample/backward", "point_sample.cu", {"point_sample_bwd_fixed_kernel", "point_sample_bwd_global_kernel"})])
def test_k4_and_k3_kernels_are_the_ones_profiled(smoke, entry, source, kernels):
    """K4 launches one kernel whatever the shape (the slice staged in
    shared memory, the taps past it from global memory), K3 / K3b one each,
    and K5b one (its fixed-point kernel, or past shared memory its
    global-atomics one); phase 3 profiles exactly those by their names."""
    names, per_call = smoke.entry_kernels(entry)
    kernels_of_source = _kernels_of(ROOT / smoke.PKG / "csrc" / source)
    assert kernels <= kernels_of_source and per_call == 1
    assert {k for k in kernels_of_source if any(n in k for n in names)} == kernels


@pytest.mark.parametrize("t_mod", [1, 3, 8])
def test_fusion_row_library_call_computes_k3s_function(smoke, t_mod):
    """The library call phase 3 times beside K3 and K3b (SDPA over each
    position's stacked slots) computes the plain K3's function and, on its
    retained graph, the plain K3b's gradients; in f32 on the CPU only the
    order of the sums differs (rel-L2 1e-5)."""
    import torch
    from incomplete_multimodal_fusion_tpu_torch.ops import cuda_fusion_attn

    g = torch.Generator().manual_seed(t_mod)
    b, f, heads, dh = 2, 5, 3, 32
    q, kvg, kvf = (torch.randn(*s, generator=g) for s in ((b, f, heads * dh), (b, t_mod * f, 2 * heads * dh),
                                                          (b, f, 2 * heads * dh)))

    def rel(a, r):
        return float((a - r).norm() / r.norm())

    out = smoke.fusion_row_sdpa_case(q, kvg, kvf, heads, "forward")()
    assert rel(out.reshape(b, f, heads * dh), cuda_fusion_attn.fusion_row_attention_reference(q, kvg, kvf, heads,
                                                                                               dh)) <= 1e-5
    torch.manual_seed(7)
    grads = smoke.fusion_row_sdpa_case(q, kvg, kvf, heads, "backward")()
    torch.manual_seed(7)
    do = torch.randn(b * f, heads, 1, dh).reshape(b, f, heads * dh)
    ref = smoke.fusion_row_stacked(*cuda_fusion_attn.fusion_row_attention_backward_reference(q, kvg, kvf, do, heads,
                                                                                            dh), heads)
    for got, want in zip(grads, ref):
        assert got.shape == want.shape and rel(got, want) <= 1e-5


@pytest.mark.parametrize("masked", [True, False], ids=["zorro", "none"])
def test_sdpa_yardstick_computes_k1s_function_in_the_plain_layout(smoke, masked):
    """Phase 3's check of the f32 library column (``sdpa_outputs``) returns
    SDPA's output [B, N, I] and, given dO, its dqkv [B, N, 3I] in the plain
    K1 / K1b's layout: on the CPU in f32 within 1e-5 of them (only the order
    of the sums differs), a ragged N with PAD and fusion rows."""
    import torch
    from incomplete_multimodal_fusion_tpu_torch.ops import cuda_attn

    g = torch.Generator().manual_seed(5)
    b, n, heads, dh = 2, 37, 3, 16
    qkv = torch.randn(b, n, 3 * heads * dh, generator=g)
    do = torch.randn(b, n, heads * dh, generator=g)
    row = [0] * 10 + [1] * 9 + [2] * 8 + [255] * 4 + [3] * 6
    types = torch.tensor([row, row[::-1]], dtype=torch.int32) if masked else None

    def rel(a, r):
        return float((a - r).norm() / r.norm())

    out, lse = cuda_attn.zorro_attention_qkv_reference(qkv, heads, types, 3, return_lse=True)
    dqkv = cuda_attn.zorro_attention_qkv_backward_reference(qkv, types, out, lse, do, heads, 3)
    mask = smoke.zorro_mask(types)
    assert rel(smoke.sdpa_outputs(qkv, heads, mask)(), out) <= 1e-5
    got = smoke.sdpa_outputs(qkv, heads, mask, do)()
    assert got.shape == dqkv.shape
    for part, want in zip(got.chunk(3, dim=-1), dqkv.chunk(3, dim=-1)):
        assert rel(part, want) <= 1e-5


@pytest.mark.parametrize("geglu,hid,launched,planned", [(True, 2730, 2736, 3), (True, 512, 512, 2),
                                                         (False, 1024, 1024, 1)])
def test_k2_forward_kernels_are_the_librarys_plan(monkeypatch, geglu, hid, launched, planned):
    """Phase 3 counts K2's kernels a call as the library plans them, asked
    at the hidden width it launches (a GEGLU inner width padded to 16)."""
    from incomplete_multimodal_fusion_tpu_torch.ops import cuda_ffn
    asked = []
    monkeypatch.setattr(cuda_ffn, "_fwd_kernels_fn", lambda: lambda *a: asked.append(a) or planned)
    assert cuda_ffn.forward_kernels(geglu, 1024, 192, hid, 192) == planned
    assert asked == [(0 if geglu else 1, 1024, 192, launched, 192)]


def test_k2_forward_kernels_refuse_shapes_the_library_does_not_take(monkeypatch):
    from incomplete_multimodal_fusion_tpu_torch.ops import cuda_ffn
    monkeypatch.setattr(cuda_ffn, "_fwd_kernels_fn", lambda: lambda *a: -1)
    with pytest.raises(ValueError):
        cuda_ffn.forward_kernels(False, 1024, 200, 1024, 200)


@pytest.mark.parametrize("floats,kernels", [(0, 1), (2_752_512, 2)])
def test_k4b_kernels_follow_the_librarys_scratch(monkeypatch, floats, kernels):
    """K4b launches a second kernel exactly where its library asks for a
    scratch of partial slices (a slice's queries split over blocks)."""
    from incomplete_multimodal_fusion_tpu_torch.ops import cuda_msda
    asked = []
    monkeypatch.setattr(cuda_msda, "_bwd_scratch_fn", lambda: lambda *a: asked.append(a[:7]) or floats)
    assert cuda_msda.backward_kernels(1, 1344, 8, 32, ((8, 8), (16, 16), (32, 32)), 4) == kernels
    assert asked == [(1, 1344, 1344, 8, 32, 3, 4)]


@pytest.mark.parametrize("entry,kernels", [("fused_ffn/geglu_backward", 5), ("fused_ffn/mlp_backward", 3)])
def test_kernels_per_call_on_the_wide_path(smoke, entry, kernels):
    """Past the row pass's widths K2b launches its wide path's kernels: GEGLU
    the norm, the activations' products, the weight gradients and dxn in one
    launch, the LN backward and wgrad.cuh's reduction; MLP the three without
    the norm and the LN backward."""
    names, per_call = smoke.entry_kernels(entry, f"M=8192 d=768 {smoke.WIDE}")
    assert per_call == kernels
    # the bf16 instance's kernels (the f32 instance's have their own entry)
    kernels_of_source = {k for k in _kernels_of(ROOT / smoke.PKG / "csrc" / "fused_ffn_bwd.cu") if "f32" not in k}
    assert {"ffn_bwd_wide_norm_kernel", "ffn_bwd_wide_act_kernel", "ffn_bwd_wide_products_kernel",
            "ffn_bwd_wide_ln_kernel", "wgrad_reduce_kernel"} <= kernels_of_source
    assert not {"ffn_bwd_wide_rows_kernel", "ffn_bwd_wide_dx_kernel"} & kernels_of_source
    assert all(any(n in k for n in names) for k in kernels_of_source)


@pytest.mark.parametrize("geglu,hid,launched,planned", [(True, 2730, 2736, 5), (True, 2048, 2048, 5),
                                                         (False, 3072, 3072, 3), (True, 512, 512, 3)])
def test_k2b_backward_kernels_are_the_librarys_plan(monkeypatch, geglu, hid, launched, planned):
    """Phase 3 counts K2b's kernels a call on its wide rows as the library
    plans them (``ffn_bwd_kernels``), asked at the hidden width it launches
    (a GEGLU inner width padded to 16)."""
    from incomplete_multimodal_fusion_tpu_torch.ops import cuda_ffn
    asked = []
    monkeypatch.setattr(cuda_ffn, "_bwd_kernels_fn", lambda: lambda *a: asked.append(a) or planned)
    d = 192 if hid == 512 else 768
    assert cuda_ffn.backward_kernels(geglu, 8192, d, hid, d) == planned
    assert asked == [(0 if geglu else 1, 8192, d, launched, d)]


def test_k2b_backward_kernels_refuse_shapes_the_library_does_not_take(monkeypatch):
    from incomplete_multimodal_fusion_tpu_torch.ops import cuda_ffn
    monkeypatch.setattr(cuda_ffn, "_bwd_kernels_fn", lambda: lambda *a: -1)
    with pytest.raises(ValueError):
        cuda_ffn.backward_kernels(False, 1024, 200, 1024, 200)


def test_the_wide_kernels_plan_exports_are_defined_in_csrc():
    """The plan queries phase 3 and the wrappers read (kernels a call,
    workspace and scratch sizes) are C entries of the libraries they load."""
    csrc = ROOT / "incomplete_multimodal_fusion_tpu_torch" / "csrc"
    assert "ffn_bwd_kernels" in _extern_c(csrc / "fused_ffn_bwd.cu")
    assert "ffn_bwd_scratch_floats" in _extern_c(csrc / "fused_ffn_bwd.cu")
    assert {"ffn_fwd_kernels", "ffn_fwd_workspace_bytes"} <= _extern_c(csrc / "fused_ffn.cu")


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::ffn_bwd_wide_rows_kernel<0>(__nv_bfloat16 const*, int)", "ffn_bwd_wide_rows_kernel"),
    ("(anonymous namespace)::ffn_bwd_wide_ln_kernel(__nv_bfloat16 const*, int)", "ffn_bwd_wide_ln_kernel"),
    ("void wgrad::wgrad_kernel<3>(wgrad::WGrad, wgrad::WGrad, int, int)", "wgrad_kernel"),
    ("point_sample_fwd_cached_kernel(float const*, int)", "point_sample_fwd_cached_kernel")])
def test_kernel_names_lose_return_type_namespace_template_and_arguments(smoke, name, short):
    assert smoke.kernel_name(name) == short


def _fake_profiler(smoke, monkeypatch, events_per_call):
    """profiled_ms standing in for torch.profiler: it makes the calls (3
    warm-ups, 10 profiled) and reports ``events_per_call`` device kernels a
    call, 0.25 ms each."""
    def profiled_ms(fn, own=None, reps=10, warmup=3):
        for _ in range(warmup + reps):
            fn()
        return 0.25 * events_per_call, events_per_call, {"ffn_bwd_rows_kernel": 0.25 * events_per_call}
    monkeypatch.setattr(smoke, "profiled_ms", profiled_ms)


def _one_launch():
    from incomplete_multimodal_fusion_tpu_torch.ops import cuda_ffn
    cuda_ffn.LAUNCHES["geglu_backward"] += 1


def test_device_only_time_is_the_profilers_when_its_count_matches(smoke, monkeypatch):
    _fake_profiler(smoke, monkeypatch, 1)
    ms, how = smoke.device_only_ms(_one_launch, ("ffn_bwd",), 1)
    assert ms == 0.25 and how == "profiler"


def test_device_only_time_is_null_when_the_profilers_count_falls_short(smoke, monkeypatch):
    """A dropped event never turns into a time taken another way (host work
    included) under the device-only name."""
    _fake_profiler(smoke, monkeypatch, 2)
    ms, how = smoke.device_only_ms(_one_launch, ("ffn_bwd", "wgrad"), 3)
    assert ms is None and how.startswith("not measured")


def test_kernel_entry_says_how_its_device_times_were_taken(smoke):
    r = {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.1, "bound_by": "bytes", "library_ms": None,
         "shape": "M=1", "device_ms": None, "device_how": "not measured: the profiler saw 2 of 3 kernels, 3 runs",
         "library_device_ms": None, "library_device_how": None}
    entry = smoke.kernel_entry("fused_ffn/geglu_backward", r, 24)
    assert entry["device_ms"] is None and entry["device_how"].startswith("not measured")
    assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "device_how", "library_device_how"} <= set(entry)


def test_without_a_card_the_smoke_fails_and_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


F32_PER_CALL = {"zorro_attention_qkv/zorro_f32": 1, "zorro_attention_qkv/zorro_f32_backward": 2,
                "zorro_attention_qkv/none_f32": 1, "zorro_attention_qkv/none_f32_backward": 2,
                "zorro_attention_packed/zorro_f32": 1, "zorro_attention_packed/zorro_f32_backward": 2,
                "zorro_sparse/f32_forward": 1, "zorro_sparse/f32_backward": 2,
                "fused_ffn/geglu_f32": 2, "fused_ffn/geglu_f32_backward": 4, "fused_ffn/mlp_f32": 2,
                "fused_ffn/mlp_f32_backward": 4, "fusion_row_attention/fusion_row_f32": 1,
                "fusion_row_attention/fusion_row_f32_backward": 1, "fused_block_attn/f32_forward": 6,
                "fused_block_attn/f32_backward": 13, "fused_ffn/mlp_tasks_f32": 2}
F32_KERNELS = {"zorro": {"zorro_attention_f32_fwd_kernel", "zorro_attention_f32_dq_kernel",
                         "zorro_attention_f32_dkdv_kernel"},
               "simt": {"simt_f32_colsum_kernel", "simt_f32_reduce_kernel", "simt_f32_ln_fwd_kernel",
                        "simt_f32_ln_bwd_kernel"},
               "tf32": {"ffn_tf32_split_kernel", "ffn_tf32_fwd_rows_kernel", "ffn_tf32_fwd_reduce_kernel",
                        "ffn_tf32_bwd_rows_kernel", "ffn_tf32_wgrad_kernel", "ffn_tf32_wide_act_kernel",
                        "ffn_tf32_wide_act_bwd_kernel", "ffn_tf32_wide_gemm_kernel", "ffn_tf32_wide_weights_kernel"}}


@pytest.mark.parametrize("entry", sorted(F32_PER_CALL))
def test_f32_entries_are_profiled_by_their_own_kernels(smoke, entry):
    """Each f32 instance's kernels-line entry: its source and TPU kernel are
    its bf16 instance's, its kernels a call as its library launches them,
    and the names phase 3 profiles it by pick out only f32 kernels of its
    source (K3's instance is the same kernel template on float)."""
    assert smoke.is_f32(entry) and entry in smoke.REPLACES
    bf16 = [k for k in smoke.REPLACES if not smoke.is_f32(k) and smoke.f32_key(k) == entry]
    assert len(bf16) == 1 and smoke.REPLACES[bf16[0]] == smoke.REPLACES[entry]
    names, per_call = smoke.entry_kernels(entry)
    assert per_call == F32_PER_CALL[entry]
    kernels = _kernels_of(ROOT / smoke.PKG / smoke.REPLACES[entry][0])
    picked = {k for k in kernels if any(n in k for n in names)}
    if entry.startswith("fusion_row_attention/"):
        assert picked == ({"fusion_row_bwd_kernel"} if entry.endswith("backward") else {"fusion_row_kernel"})
    else:
        assert picked and all("f32" in k for k in picked)
        assert picked <= F32_KERNELS["zorro"] | F32_KERNELS["simt"] | F32_KERNELS["tf32"]


# the FFMA product that the f32 instances ran before their tensor-core
# products: its kernel, its tile and its entry points
FFMA_PRODUCT = re.compile(r"\b(simt_f32_product_kernel|product_tile|product_store|weight_grad_partials|EPI_PARTIAL|"
                          r"EPI_STORE)\b|simt_f32::product\b")


CSRC = ROOT / "incomplete_multimodal_fusion_tpu_torch" / "csrc"


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")))
def test_no_source_defines_or_calls_the_ffma_product(source):
    """Every f32 product runs on the tensor cores (3xTF32 wgmma): no CUDA
    source defines or calls the CUDA-core FFMA product any more."""
    text = (CSRC / source).read_text()
    assert not FFMA_PRODUCT.search(text), FFMA_PRODUCT.search(text)


def test_k6_f32_runs_the_wide_products(smoke):
    """K6 / K6b's f32 instance is profiled by ffn_tf32_wide.cuh's products
    and weight splits, simt_f32's LayerNorms and reduction and K1 / K1b's f32
    kernels, six launches forward and thirteen backward."""
    kernels = _kernels_of(ROOT / smoke.PKG / "csrc" / "fused_block_attn.cu")
    for entry, per_call in (("fused_block_attn/f32_forward", 6), ("fused_block_attn/f32_backward", 13)):
        names, n = smoke.entry_kernels(entry)
        assert n == per_call
        picked = {k for k in kernels if any(name in k for name in names)}
        assert {"ffn_tf32_wide_gemm_kernel", "ffn_tf32_wide_weights_kernel", "simt_f32_ln_fwd_kernel",
                "simt_f32_ln_bwd_kernel", "simt_f32_reduce_kernel", "zorro_attention_f32_fwd_kernel",
                "zorro_attention_f32_dq_kernel", "zorro_attention_f32_dkdv_kernel"} <= picked


def test_the_f32_keys_of_the_bf16_entries(smoke):
    assert smoke.f32_key("zorro_attention_qkv/zorro") == "zorro_attention_qkv/zorro_f32"
    assert smoke.f32_key("zorro_attention_qkv/none_backward") == "zorro_attention_qkv/none_f32_backward"
    assert smoke.f32_key("fused_block_attn/backward") == "fused_block_attn/f32_backward"
    assert {smoke.f32_key(k) for k in smoke.REPLACES if not smoke.is_f32(k)
            and not k.startswith(("ms_deform_attn/", "point_sample/"))} == set(F32_PER_CALL)
    from incomplete_multimodal_fusion_tpu_torch import ops
    assert set(F32_PER_CALL) <= set(ops.kernel_launches())


def _extern_c(source: Path):
    """The names of a CUDA source's extern "C" functions."""
    return set(re.findall(r'extern "C" [\w\s*]*?\b(\w+)\(', source.read_text()))


def test_every_f32_entry_a_wrapper_binds_is_defined_in_csrc(monkeypatch):
    """The wrappers' f32 C entries (bound by name at first use, which no CPU
    run reaches): each binder runs against a stand-in for the library, and
    every name it asks for is an extern "C" function of the source it names."""
    import torch
    from incomplete_multimodal_fusion_tpu_torch.ops import (cuda_attn, cuda_block_attn, cuda_build, cuda_ffn,
                                                            cuda_fusion_attn)

    asked = []

    class Entry:
        argtypes = restype = None

    class Library:
        def __init__(self, source):
            self.source = source

        def __getattr__(self, name):
            asked.append((self.source, name))
            return Entry()

    monkeypatch.setattr(cuda_build, "bind", lambda source, name, argtypes: asked.append((source, name)) or Entry())
    monkeypatch.setattr(cuda_build, "load", Library)
    binders = (cuda_attn._forward_entry, cuda_attn._backward_entry, cuda_fusion_attn._fwd_fn,
               cuda_fusion_attn._bwd_fn, cuda_block_attn._fwd_f32_fn, cuda_block_attn._bwd_f32_fn,
               cuda_block_attn._f32_scratch_fn, cuda_ffn._f32_fn, cuda_ffn._f32_floats_fn)
    for binder in binders:
        binder.cache_clear()
    for binder in binders[:4]:
        binder(torch.float32)
    for binder in binders[4:7]:
        binder()
    ffn_source = (ROOT / "incomplete_multimodal_fusion_tpu_torch" / "ops" / "cuda_ffn.py").read_text()
    for name in re.findall(r'_launch_f32\(x, "(\w+)"', ffn_source):
        cuda_ffn._f32_fn(name, 1, 1)
    for name in re.findall(r'_f32_workspace\(x, "(\w+)"', ffn_source):
        cuda_ffn._f32_floats_fn(name)
    for source, name in re.findall(r'_f32_plan_fn\("(\w+\.cu)", "(\w+)"\)', ffn_source):
        cuda_ffn._f32_plan_fn(source, name)
    for binder in (*binders, cuda_ffn._f32_plan_fn):
        binder.cache_clear()
    f32 = {(source, name) for source, name in asked if "f32" in name}
    assert {name for _, name in f32} == {
        "zorro_attention_f32", "zorro_attention_bwd_f32", "fusion_row_attention_f32", "fusion_row_attention_bwd_f32",
        "fused_block_attn_fwd_f32", "fused_block_attn_bwd_f32", "fused_block_attn_f32_scratch_floats",
        "geglu_ffn_f32", "mlp_ffn_f32", "geglu_ffn_bwd_f32", "mlp_ffn_bwd_f32", "ffn_fwd_f32_workspace_floats",
        "ffn_bwd_f32_scratch_floats", "mlp_ffn_tasks_f32", "ffn_fwd_tasks_f32_workspace_floats",
        "ffn_fwd_f32_kernels", "ffn_fwd_tasks_f32_kernels", "ffn_bwd_f32_kernels"}
    csrc = ROOT / "incomplete_multimodal_fusion_tpu_torch" / "csrc"
    for source, name in sorted(f32):
        assert name in _extern_c(csrc / source), (source, name)


MAIN_PHASES = ("phase_serving", "phase_train", "phase_segment", "phase_segment_train", "phase_encoder_variants",
               "phase_f32", "phase_semantic_train", "phase_pretrain_state", "phase_cli", "phase_export",
               "phase_pretrain_variants", "phase_backbones", "phase_data", "phase_parallel", "phase_bf16_base")


@pytest.mark.parametrize("launching", ["phase_cli", "phase_serving", "phase_export", "phase_pretrain_variants",
                                       "phase_backbones", "phase_data", "phase_parallel", "phase_bf16_base"])
def test_main_adds_the_cli_phases_launches_to_the_kernels_line(smoke, monkeypatch, capsys, launching):
    """``main`` sums every main path's launches, phase 12's (cli) among
    them: with the launches of one phase alone, each kernel's entry counts
    them, and the last line is the contract's."""
    import json

    r = {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.1, "bound_by": "bytes", "library_ms": None,
         "shape": "M=1", "device_ms": 0.5, "device_how": "profiler", "library_device_ms": None,
         "library_device_how": None}
    monkeypatch.setattr(smoke, "phase_device", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(smoke, "phase_build", lambda: None)
    monkeypatch.setattr(smoke, "phase_kernels", lambda dev: {name: r for name in smoke.REPLACES})
    counts = {name: 3 for name in smoke.REPLACES}
    for phase in MAIN_PHASES:
        got = counts if phase == launching else {}
        two = phase in ("phase_train", "phase_segment_train")  # these also return a context
        monkeypatch.setattr(smoke, phase, lambda *a, got=got, two=two: (got, {}) if two else got)
    monkeypatch.setattr(smoke.torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(smoke.torch.cuda, "device_count", lambda: 1)
    assert smoke.main(["chip_smoke.py"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    kernels = json.loads(lines[-3])["kernels"]
    assert [k["name"] for k in kernels] == list(smoke.REPLACES) and all(k["launches"] == 3 for k in kernels)
    assert lines[-2] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                                                            "count": 1}}


def test_main_fails_when_no_phase_launches_a_kernel(smoke, monkeypatch):
    r = dict.fromkeys(("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
                       "device_ms", "device_how", "library_device_ms", "library_device_how"))
    monkeypatch.setattr(smoke, "phase_device", lambda: "smi")
    monkeypatch.setattr(smoke, "phase_build", lambda: None)
    monkeypatch.setattr(smoke, "phase_kernels", lambda dev: {name: r for name in smoke.REPLACES})
    for phase in MAIN_PHASES:
        two = phase in ("phase_train", "phase_segment_train")
        monkeypatch.setattr(smoke, phase, lambda *a, two=two: ({}, {}) if two else {})
    with pytest.raises(RuntimeError, match="was not launched by the main paths"):
        smoke.main(["chip_smoke.py"])


@pytest.mark.parametrize("args,chosen", [
    ([], None), (["--kernels-only"], ("kernels",)), (["--phases", "bf16-base"], ("bf16-base",)),
    (["--phases", "bf16-base,kernels"], ("kernels", "bf16-base")),
    (["--phases", "encoder-variants"], ("train", "encoder-variants")),
    (["--phases", "f32,serving"], ("serving", "segment-train", "f32"))])
def test_phases_are_chosen_from_the_command_line(smoke, args, chosen):
    """No argument: every phase; ``--phases``: the named ones in the script's
    order, with the phase whose model and batch a named one reads."""
    assert smoke.chosen_phases(args) == (smoke.PHASES if chosen is None else chosen)


@pytest.mark.parametrize("args", [["--phases", "nope"], ["--phases", ""], ["--phase", "kernels"], ["extra"]])
def test_an_unknown_phase_is_refused(smoke, args):
    with pytest.raises(SystemExit):
        smoke.chosen_phases(args)


def test_main_runs_only_the_chosen_phases_and_prints_no_result_line(smoke, monkeypatch, capsys):
    """``--phases bf16-base,encoder-variants``: phases 1 and 2, the named
    ones and the train phase encoder-variants reads, each once; no kernels
    line, no result line."""
    ran = []
    monkeypatch.setattr(smoke, "phase_device", lambda: "smi")
    monkeypatch.setattr(smoke, "phase_build", lambda: None)
    monkeypatch.setattr(smoke, "phase_kernels", lambda dev: ran.append("phase_kernels") or {})
    for phase in MAIN_PHASES:
        two = phase in ("phase_train", "phase_segment_train")
        monkeypatch.setattr(smoke, phase, lambda *a, two=two, phase=phase: ran.append(phase) or (
            ({"fused_ffn/geglu": 1}, {"model": None}) if two else {"fused_ffn/geglu": 2}))
    assert smoke.main(["chip_smoke.py", "--phases", "bf16-base,encoder-variants"]) == 0
    assert ran == ["phase_train", "phase_encoder_variants", "phase_bf16_base"]
    out = capsys.readouterr().out
    assert '"ok": true' not in out and '"kernels"' not in out and "[phases]" in out


def test_the_cli_phases_pth_converts_to_the_golden_converter_output(smoke, tmp_path):
    """Phase 12 (a)'s .pth writer takes the golden's reference weights (also
    behind DDP's prefix); cli.convert_checkpoint on it restores bit for bit
    to the converter output phase 11 (d) serves."""
    import torch
    from incomplete_multimodal_fusion_tpu_torch.cli import convert_checkpoint
    from incomplete_multimodal_fusion_tpu_torch.utils import checkpoint as ckpt_lib

    pth = str(tmp_path / "golden.pth")
    state = smoke.write_golden_pth(pth, prefix="module.")
    assert set(state) == {f"module.{k}" for k in smoke.golden_weights()}
    assert convert_checkpoint.main([pth, str(tmp_path / "out"), "--depth", "2", "--decoder_depth", "2"]) == 0
    got, want = ckpt_lib.load_model_state(str(tmp_path / "out")), smoke.golden_converted()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert smoke.payload_compare(got, want) == {}


def test_the_cli_phases_png_check_reads_a_grid(smoke, tmp_path):
    import numpy as np
    from incomplete_multimodal_fusion_tpu_torch import infer

    grid = np.random.default_rng(0).integers(0, 256, (3 * 40, 3 * 24, 3)).astype(np.uint8)
    path = str(tmp_path / "grid.png")
    infer.write_png(path, grid)
    assert smoke.png_size(path) == (72, 120)
    data = open(path, "rb").read()
    with open(path, "wb") as f:  # a header that claims more rows than the pixel data holds
        f.write(data[:20] + (121).to_bytes(4, "big") + data[24:])
    with pytest.raises(RuntimeError, match="not an 8-bit RGB image of 72 x 121"):
        smoke.png_size(path)
    with open(path, "wb") as f:
        f.write(b"GIF89a" + data[6:])
    with pytest.raises(RuntimeError, match="not a PNG"):
        smoke.png_size(path)


def test_the_cli_phases_parser_refuses_missing_lines(smoke):
    assert smoke.parsed(r"dice=(\S+)", "  eval dice=0.5 lr\n  eval dice=1.25 lr", "dice") == [0.5, 1.25]
    with pytest.raises(RuntimeError, match="nothing matches"):
        smoke.parsed(r"dice=(\S+)", "no eval line", "dice")


def test_the_task_axis_entry_is_k2s_mlp_kernels(smoke):
    """fused_ffn/mlp_tasks (and its f32 key) is K2's forward in csrc/fused_ffn.cu:
    the row kernel with its task axis, the f32 row kernel with its task axis
    (past d = 256 the f32 wide path, task by task); each C entry its wrapper
    binds is defined there."""
    source = ROOT / smoke.PKG / "csrc" / "fused_ffn.cu"
    kernels = _kernels_of(source)
    assert smoke.REPLACES["fused_ffn/mlp_tasks"] == ("csrc/fused_ffn.cu",
                                                     "incomplete_multimodal_fusion_tpu/ops/pallas_ffn.py:374")
    assert smoke.REPLACES["fused_ffn/mlp_tasks_f32"] == smoke.REPLACES["fused_ffn/mlp_tasks"]
    names, per_call = smoke.entry_kernels("fused_ffn/mlp_tasks")
    assert per_call == 1 and all(any(n in k for k in kernels) for n in names)
    names32, per_call32 = smoke.entry_kernels("fused_ffn/mlp_tasks_f32")
    assert per_call32 == 2 and {"ffn_tf32_fwd_rows_kernel", "ffn_tf32_wide_act_kernel"} <= kernels
    assert "ffn_tf32::forward_wide<ffn_tf32::MODE_MLP>" in source.read_text()
    text = source.read_text()
    for entry in ("mlp_ffn_tasks_bf16", "mlp_ffn_tasks_f32", "ffn_fwd_tasks_workspace_bytes", "ffn_fwd_tasks_kernels"):
        assert entry in _extern_c(source), entry
    assert "if constexpr (TASKS)" in text


def test_phase_export_counts_the_batched_decoders_launches(smoke):
    """Phase 13's batched forward launches K1's unmasked mode and the
    task-axis MLP once a decoder layer, the rest as PER_FORWARD."""
    assert smoke.BATCHED_PER_FORWARD == {"zorro_attention_qkv/zorro": 12, "zorro_attention_qkv/none": 2,
                                         "fused_ffn/geglu": 24, "fused_ffn/mlp_tasks": 2,
                                         "fusion_row_attention/fusion_row": 12}


def test_pretrain_variants_launch_counts(smoke):
    """Phase 14's launches a forward: K1 zorro a block; K2 GEGLU a block and
    a fusion block; K3 a fusion block (crossattn only); K1 unmasked and K2
    MLP a decoder layer and task, one more MLP a task for the full
    decoder's cross-attention; the f32 keys for an f32 run."""
    got = {name: smoke.variant_per_forward(smoke.variant_cfg(name)) for name in smoke.VARIANTS}
    base = {"zorro_attention_qkv/zorro": 12, "zorro_attention_qkv/none": 6, "fused_ffn/mlp": 6}
    assert got["zorro"] == got["lstm"] == got["crossattn_v1"] == {**base, "fused_ffn/geglu": 12}
    assert got["crossattn full decoder"] == {**base, "fused_ffn/mlp": 9, "fused_ffn/geglu": 24,
                                             "fusion_row_attention/fusion_row": 12}
    assert got["quadruplet crossattn"] == {"zorro_attention_qkv/zorro": 12, "zorro_attention_qkv/none": 8,
                                           "fused_ffn/mlp": 8, "fused_ffn/geglu": 24,
                                           "fusion_row_attention/fusion_row": 12}
    assert smoke.variant_per_forward(smoke.variant_cfg("lstm"), "_f32") == {
        "zorro_attention_qkv/zorro_f32": 12, "zorro_attention_qkv/none_f32": 6, "fused_ffn/mlp_f32": 6,
        "fused_ffn/geglu_f32": 12}
    assert all(k in smoke.REPLACES for counts in got.values() for k in counts)


def test_backbone_launch_counts(smoke):
    """Phase 15's launches: K4 twice a forward in the pixel decoder and,
    on the ViT-Adapter, once a injector and extractor (4 interaction groups
    at depth 12); K1 zorro and K2 GEGLU in a crossattn ViT, K1 unmasked and
    K2 a block in 'sup'; a step adds each backward and the criterion's K5 /
    K5b, 5 and 1 a prediction level (4 levels with the Mask2Former decoder,
    3 with the standard one)."""
    cfgs = {name: smoke.MaskFormerConfig(num_classes=1, **change) for name, change in smoke.BACKBONES.items()}
    fwd = {name: smoke.backbone_per_forward(cfg) for name, cfg in cfgs.items()}
    vit = {"zorro_attention_qkv/zorro": 12, "fused_ffn/geglu": 24}
    assert fwd["vit_adapter"] == {"ms_deform_attn/forward": 10, **vit}
    assert fwd["vit standard decoder"] == {"ms_deform_attn/forward": 2, **vit}
    assert fwd["sup"] == {"ms_deform_attn/forward": 2, "zorro_attention_qkv/none": 12, "fused_ffn/geglu": 12}
    assert fwd["resnet50"] == fwd["resnet18"] == fwd["swin"] == {"ms_deform_attn/forward": 2}
    step = smoke.backbone_per_step(cfgs["vit_adapter"])
    assert step == {"ms_deform_attn/forward": 10, "ms_deform_attn/backward": 10, **vit,
                    "zorro_attention_qkv/zorro_backward": 12, "fused_ffn/geglu_backward": 24,
                    "point_sample/forward": 20, "point_sample/backward": 4}
    assert step == {**smoke.SEG_TRAIN_PER_STEP, "ms_deform_attn/forward": 10, "ms_deform_attn/backward": 10}
    std = smoke.backbone_per_step(cfgs["vit standard decoder"])
    assert std["point_sample/forward"] == 15 and std["point_sample/backward"] == 3
    assert all(k in smoke.REPLACES for cfg in cfgs.values() for k in smoke.backbone_per_step(cfg))


def test_gathered_types_case_pads_mid_sequence(smoke):
    """Phase 3's 2E-layout types: rows that keep fewer than E tokens are
    PAD at [num_visible, E) and at [E + num_visible, 2E), the fusion half
    typed 3 before each; a dropped modality's type never appears."""
    import torch

    types = smoke.gathered_types_case(torch.device("cpu"))
    pad = smoke.cuda_attn.PAD_TYPE
    assert types.shape == (60, 768) and types.dtype == torch.int32
    for row in range(60):
        keep = (384, 300, 256, 128)[row % 4]
        first, second = types[row, :384], types[row, 384:]
        assert (first[:keep] != pad).all() and (first[keep:] == pad).all()
        assert (second[:keep] == 3).all() and (second[keep:] == pad).all()
        if keep < 384:
            assert not (first[:keep] == row % 3).any()


def test_main_hands_a_parallel_worker_its_arguments(smoke, monkeypatch):
    """``--parallel-worker`` runs one rank of phase 17 and nothing else."""
    seen = []
    monkeypatch.setattr(smoke, "parallel_worker", lambda argv: seen.append(argv) or 0)
    monkeypatch.setattr(smoke, "phase_device", lambda: pytest.fail("a worker checks no device"))
    assert smoke.main(["chip_smoke.py", "--parallel-worker", "gloo", "ref.pt", "1", "2", "29500"]) == 0
    assert seen == [["gloo", "ref.pt", "1", "2", "29500"]]


def test_parallel_launches_per_mode(smoke):
    """Phase 17's launch expectations: the one-process step's per step, the
    pipeline's trunk kernels once a microbatch (M = 2), the decoder's once."""
    per_step = smoke.PER_STEP
    assert smoke.expected_launches(per_step, "dp") == {k: 2 * n for k, n in per_step.items()}
    pp = smoke.expected_launches(per_step, "pp M=2")
    assert pp["zorro_attention_qkv/zorro"] == pp["zorro_attention_qkv/zorro_backward"] == 4 * 12
    assert pp["fused_ffn/geglu"] == 4 * 24 and pp["fusion_row_attention/fusion_row_backward"] == 4 * 12
    assert pp["zorro_attention_qkv/none"] == 2 * 6 and pp["fused_ffn/mlp_backward"] == 2 * 6


def test_parallel_weight_checks_read_the_optimizer(smoke):
    """Phase 17's optimizer checks on a one-device FlatAdamW: the first
    moment after a step is (1 - beta1) times the gradient; weights left
    unchanged read 1 against the step's change; a rank that used half the
    gradient (its rows' part, the all-reduce skipped) reads 0.5 in mu."""
    from types import SimpleNamespace

    from incomplete_multimodal_fusion_tpu_torch.train.optim import FlatAdamW

    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.nn.Parameter(torch.randn(4, 3, generator=gen)),
              "b": torch.nn.Parameter(torch.randn(3, generator=gen))}
    opt = FlatAdamW(params.items(), torch.tensor([1e-3]), torch.tensor([0.05]))
    start = {n: p.detach().clone() for n, p in params.items()}
    grads = {n: torch.randn(p.shape, generator=gen) for n, p in params.items()}
    for n, p in params.items():
        p.grad = grads[n].clone()
    opt.step()
    mu = smoke.first_moment(opt, SimpleNamespace(parallel=None))
    for n in params:
        torch.testing.assert_close(mu[n], 0.1 * grads[n])
    after = {n: p.detach().clone() for n, p in params.items()}
    assert smoke.delta_rel(after, start, after) == 0.0
    assert smoke.delta_rel(start, start, after) == 1.0
    ref = {"betas": opt.defaults["betas"], "eps": opt.defaults["eps"], "clip": None, "mu": mu, "grads": grads}
    assert smoke.skipped_allreduce(grads, ref) == (0.0, 0.0)
    skip_mu, skip_step = smoke.skipped_allreduce({n: g / 2 for n, g in grads.items()}, ref)
    assert skip_mu == pytest.approx(0.5) and skip_step < 1e-6
