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
    ("point_sample/backward", 1), ("zorro_attention_qkv/zorro_backward", 2), ("fused_block_attn/backward", 7)])
def test_kernels_per_call(smoke, entry, kernels):
    assert smoke.entry_kernels(entry)[1] == kernels


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
