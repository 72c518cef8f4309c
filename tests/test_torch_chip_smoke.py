"""The card smoke's own bookkeeping, checked on the CPU: every kernel entry
of its kernels line has the device kernels that phase 3 times apart from the
wrapper's host work, and each of their names is a kernel of the entry's
CUDA source; without a card the script fails and prints no result."""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

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
    kernels_of_source = _kernels_of(ROOT / smoke.PKG / "csrc" / "fused_ffn.cu")
    assert {"ffn_fwd_rows_kernel", "ffn_fwd_split_reduce_kernel", "ffn_fwd_wide_norm_kernel",
            "ffn_fwd_wide_hidden_kernel", "ffn_fwd_wide_out_kernel"} == kernels_of_source
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


@pytest.mark.parametrize("entry,kernels", [("fused_ffn/geglu_backward", 6), ("fused_ffn/mlp_backward", 4)])
def test_kernels_per_call_on_the_wide_path(smoke, entry, kernels):
    """Past the row pass's widths K2b launches its wide path's kernels."""
    names, per_call = smoke.entry_kernels(entry, f"M=8192 d=768 {smoke.WIDE}")
    assert per_call == kernels
    kernels_of_source = _kernels_of(ROOT / smoke.PKG / "csrc" / "fused_ffn_bwd.cu")
    assert {"ffn_bwd_wide_norm_kernel", "ffn_bwd_wide_rows_kernel", "ffn_bwd_wide_dx_kernel",
            "ffn_bwd_wide_ln_kernel"} <= kernels_of_source
    assert all(any(n in k for n in names) for k in kernels_of_source)


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
