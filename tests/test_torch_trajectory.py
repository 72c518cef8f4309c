"""Many-step trajectories on the CPU: the port against the JAX package, each
drift beside its permuted-rows controls (tools/trajectory_jax_torch.py),
and the port's own trajectory tool (tools/trajectory_torch.py).

  * 8 pretraining and 5 downstream steps at the small width, f32, the same
    weights, batches and injections: P within 1e-4 of J over the first
    three steps (the three-step tests' bound) and after them within max(10 x
    the larger control, 1e-5), the controls being J and P on the same
    batches with their rows permuted;
  * the port in f64 (D) from the same weights within 1e-5 of P and of J
    over the first three steps;
  * the port's tool on step 0's weights: C (rows permuted) equals B at
    rtol 1e-6, the order of the reductions being the only difference, and
    D (the model in f64) within 1e-5; E, a bf16 trajectory's control, is
    the plain path computing in f32;
  * tools/trajectory_torch.py runs, and loads neither JAX nor the JAX
    package, in a fresh process; on the CPU it leaves out the kernel path,
    which runs on a card only.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tools import trajectory_jax_torch as tj
from tools import trajectory_torch as tt

ROOT = Path(__file__).resolve().parents[1]
STEPS = {"pretrain": 8, "downstream": 5}


@pytest.fixture(scope="module")
def parity():
    return {"pretrain": tj.pretrain_parity(STEPS["pretrain"]), "downstream": tj.downstream_parity(STEPS["downstream"])}


@pytest.mark.parametrize("path", ["pretrain", "downstream"])
def test_port_tracks_jax_within_its_controls(parity, path):
    res = parity[path]
    drift = res["drift"]["P_vs_J"]["per_step"]
    control_j, control_p = res["drift"]["J'_vs_J"]["per_step"], res["drift"]["P'_vs_P"]["per_step"]
    assert len(drift) == STEPS[path]
    for i, d in enumerate(drift):
        bound = 1e-4 if i < 3 else max(10 * max(control_j[i], control_p[i]), 1e-5)
        assert d <= bound, (path, i, d, control_j[i], control_p[i])
    assert res["bound"]["within"] and not res["bound"]["steps_over"]
    # every term over the first three steps, as the three-step tests hold them
    for k, v in res["terms"].items():
        assert max(v["P_vs_J"]["per_step"][:3]) <= 1e-4, (path, k, v["P_vs_J"]["per_step"][:3])


@pytest.mark.parametrize("path", ["pretrain", "downstream"])
def test_trajectories_train_and_the_controls_read_the_reduction_order(parity, path):
    """The four runs trained (the loss moved, every value finite), the
    permuted runs are not bitwise their originals, and the masters stay
    within 1e-5 of JAX's after the steps."""
    res = parity[path]
    for name, run in res["runs"].items():
        assert np.isfinite(run["loss"]).all() and len(set(run["loss"])) > 1, name
    assert max(res["drift"]["J'_vs_J"]["per_step"]) > 0 or res["masters_rel_l2"]["J'_vs_J"] > 0
    assert max(res["drift"]["P'_vs_P"]["per_step"]) > 0 or res["masters_rel_l2"]["P'_vs_P"] > 0
    assert res["masters_rel_l2"]["P_vs_J"] <= 1e-5, res["masters_rel_l2"]
    for k in ("J_vs_D", "P_vs_D"):
        assert max(res["drift"][k]["per_step"][:3]) <= 1e-5, (path, k, res["drift"][k]["per_step"][:3])


def test_permutation_is_fixed_and_never_the_identity():
    for b in (2, 3, 30, 60):
        p = tt.fixed_permutation(b, 0)
        assert sorted(p.tolist()) == list(range(b)) and (p != np.arange(b)).any()
        assert (p == tt.fixed_permutation(b, 0)).all()


@pytest.mark.parametrize("path", ["pretrain", "downstream"])
def test_control_equals_plain_path_on_the_first_weights(path):
    """Step 0, before any update: C differs from B only in the order of the
    reductions, D in the precision of the model."""
    res = tt.TRAJECTORIES[path]("small", "float32", 1, "cpu", 0, runs=("B", "C", "D"))
    b, c, d = (res["runs"][n] for n in ("B", "C", "D"))
    np.testing.assert_allclose(c["loss"][0], b["loss"][0], rtol=1e-6)
    for k in b["terms"]:
        np.testing.assert_allclose(c["terms"][k][0], b["terms"][k][0], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(d["loss"][0], b["loss"][0], rtol=1e-5)
    assert res["masters_rel_l2"]["C"] <= 1e-6 and res["masters_rel_l2"]["D"] <= 1e-5


def test_torch_tool_runs_without_jax(tmp_path):
    """The tool's command line in a fresh process: one pretraining step of
    each run, its JSON written, and no module of JAX, flax or the JAX
    package loaded."""
    out = tmp_path / "traj.json"
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['trajectory_torch.py', '--path', 'pretrain', '--steps', '2', '--out', {str(out)!r}]\n"
        "runpy.run_path('tools/trajectory_torch.py', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'incomplete_multimodal_fusion_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(out.read_text())["results"][0]
    assert res["path"] == "pretrain" and res["steps"] == 2 and set(res["runs"]) == {"B", "C", "D"}
    assert set(res["drift"]) == {"C", "D"} and set(res["masters_rel_l2"]) == {"C", "D"}
    assert "at_B_weights" not in res


def test_bf16_control_is_the_plain_path_in_f32():
    """E of a bf16 pretraining trajectory is B of the f32 one, bitwise, and
    B in bf16 is not."""
    bf16 = tt.pretrain_trajectories("small", "bfloat16", 2, "cpu", 0, runs=("B", "E"))
    f32 = tt.pretrain_trajectories("small", "float32", 2, "cpu", 0, runs=("B",))
    assert bf16["runs"]["E"]["loss"] == f32["runs"]["B"]["loss"]
    assert bf16["runs"]["E"]["terms"] == f32["runs"]["B"]["terms"]
    assert min(bf16["drift"]["E"]["loss"]["per_step"]) > 0


def test_unknown_width_and_missing_card_raise():
    with pytest.raises(ValueError, match="width"):
        tt.pretrain_config(tt.tconfig, "medium", "float32")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tt.pretrain_trajectories("small", "float32", 1, "cpu", runs=("A", "B"))
    with pytest.raises(ValueError, match="bf16 trajectory only"):
        tt.downstream_trajectories("small", "float32", 1, "cpu", runs=("B", "E"))
    if not tt.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.pretrain_trajectories("small", "float32", 1, "cuda")


def test_sync_copies_the_plain_path_tensors_into_every_run():
    """``sync``: the named tensors of every run equal B's after each step,
    the others drift."""
    res = tt.downstream_trajectories("small", "float32", 2, "cpu", 0, runs=("B", "C"),
                                     sync=["backbone.mask_embedding"])
    c = res["drift"]["C"]
    j = c["tensor_names"].index("backbone.mask_embedding")
    assert res["sync"] == ["backbone.mask_embedding"] and len(c["tensors_per_step"]) == 2
    assert all(step[j] == 0 for step in c["tensors_per_step"])
    assert max(c["weights_per_step"]) > 0
