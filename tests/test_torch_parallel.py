"""The port's parallel pretraining against the JAX package's single-device
step, on the CPU over gloo ranks in subprocesses (tests/torch_parallel_worker.py,
which imports no jax), f32, a small config (dim 32, depth 2, image 64, a
global batch of 4, one row of which sees no s2 token, so the ranks' masked
sample counts differ):

  * data parallel (2 ranks), ZeRO (2), tensor parallel at tp 2 with 2 heads
    (each module cut) and with 3 heads (the attention replicated, the
    feed-forwards cut), tensor + sequence parallel (2), pipeline (2 stages,
    2 microbatches) and data x pipeline (4 ranks): two steps with the
    uncertainty balancer and a gradient clip, the JAX step's masks injected
    on both sides; each step's loss within 1e-5 relative and its gradient
    norm within 1e-4, then every parameter within 1e-4 relative L2 (the
    decoder's key bias aside: its gradient is zero in exact arithmetic, so
    Adam turns either framework's rounding noise into steps of size lr);
  * a ZeRO checkpoint written at 2 ranks restores at 1 rank and saves back
    bitwise the same;
  * the meshes (``make_mesh`` with -1, ``data_parallel_mesh``,
    ``hybrid_mesh``), ``collect_results`` and each collective of
    parallel/comm.py, forward and backward, against the sums computed from
    every rank's inputs, on 4 ranks.

Each spawn joins within 120 s or fails the test.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incomplete_multimodal_fusion_tpu import config as jconfig
from incomplete_multimodal_fusion_tpu.ops import masking as jmask
from incomplete_multimodal_fusion_tpu.train import pretrain as jpretrain
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax
from tests.test_torch_common import DOMAINS, NP_, as_jax, random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, E, STEPS = 4, 24, 2
CAPACITY = NP_ * len(DOMAINS)
JOIN_TIMEOUT = 120


def cfg_kwargs(heads=2):
    """The config as keyword dicts (the worker builds the port's from them)."""
    return dict(
        model=dict(dim_tokens=16 * heads, depth=2, dim_head=16, heads=heads, ff_mult=3, num_fusion_tokens=16),
        data=dict(input_size=64, patch_size=16, batch_size=B),
        mask=dict(num_encoded_tokens=E),
        decoder=dict(dim=32, depth=1, num_heads=2),
        optim=dict(blr=0.25, warmup_epochs=0, min_lr=1e-4, task_balancer="uncertainty", clip_grad=0.5),
        train=dict(epochs=1, compute_dtype="float32"))


def jax_cfg(kw):
    return jconfig.PretrainConfig(
        model=jconfig.ModelConfig(**kw["model"]), data=jconfig.DataConfig(**kw["data"]),
        mask=jconfig.MaskConfig(**kw["mask"]), decoder=jconfig.DecoderConfig(**kw["decoder"]),
        optim=jconfig.OptimConfig(**kw["optim"]), train=jconfig.TrainConfig(**kw["train"]))


def flat_masks(seed):
    """[B, N] masks with exactly E visible tokens; row 2 sees no s2 token."""
    rng = np.random.default_rng(seed)
    flat = np.ones((B, CAPACITY), np.int64)
    others = np.r_[0:NP_, 2 * NP_:3 * NP_]
    for i in range(B):
        flat[i, rng.permutation(others if i == 2 else CAPACITY)[:E]] = 0
    return flat


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job: dict, world: int, tmp_path, name: str) -> dict:
    """Runs the worker on ``world`` gloo ranks; returns rank 0's result."""
    path = str(tmp_path / f"{name}.job")
    torch.save(job, path)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_worker", path, str(r), str(world),
                               str(port)], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=JOIN_TIMEOUT)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    return torch.load(path + ".out", weights_only=False)


def jax_reference(heads):
    """Two JAX single-device steps on the global batch with injected masks;
    returns (the start weights in the port's names, the batch, the masks,
    the metrics, the final weights in the port's names)."""
    kw = cfg_kwargs(heads)
    jcfg = jax_cfg(kw)
    batch = synthetic_batch(np.random.default_rng(0), DOMAINS, B, 64)
    model, state, tx = jpretrain.create_train_state(jcfg, jax.random.PRNGKey(0), STEPS)
    params = random_params(model, 1, as_jax(batch), jmask.full_visible_mask_info(DOMAINS, (NP_,) * 3, B), CAPACITY)
    state = state.replace(params=params)
    flats = [flat_masks(10 + k) for k in range(STEPS)]
    held = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jpretrain.masking, "generate_random_masks",
               lambda *a, **k: jmask.mask_info_from_flat_mask(held["flat"], DOMAINS, (NP_,) * 3, E))
    raw = jpretrain.make_train_step(model, jcfg, tx)

    @jax.jit
    def step(state, batch, flat):
        held["flat"] = flat
        return raw(state, batch)

    metrics = []
    try:
        for flat in flats:
            state, m = step(state, as_jax(batch), jnp.asarray(flat))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        mp.undo()
    start = {k: v.numpy() for k, v in params_from_jax(params).items()}
    return kw, start, batch, flats, metrics, params_from_jax(state.params)


@pytest.fixture(scope="module")
def reference():
    return {heads: jax_reference(heads) for heads in (2, 3)}


def job_of(ref, layout, **extra):
    kw, start, batch, flats, _, _ = ref
    return dict(kind="pretrain", cfg=kw, params=start, batch=batch, flats=flats, total_steps=STEPS,
                layout=layout, **extra)


def check_against_jax(ref, out):
    _, _, _, _, metrics, final = ref
    for k, (got, want) in enumerate(zip(out["metrics"], metrics)):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=f"step {k} loss")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4, err_msg=f"step {k} grad_norm")
    assert set(out["params"]) == set(final)
    for name, want in final.items():
        got = out["params"][name]
        if name.endswith("attn.qkv.bias"):  # the key third's gradient is zero in exact arithmetic
            third = want.shape[0] // 3
            got, want = torch.cat([got[:third], got[2 * third:]]), torch.cat([want[:third], want[2 * third:]])
        err = float((got - want).norm())
        assert err <= 1e-4 * float(want.norm()) + 1e-7, (name, err, float(want.norm()))


MODES = {
    "dp": (2, {}, 2),
    "zero": (2, {"fsdp": True}, 2),
    "tp": (2, {"tp": 2}, 2),
    "tp_replicated_attention": (2, {"tp": 2}, 3),
    "tp_sp": (2, {"tp": 2, "sp": True}, 2),
    "pp": (2, {"pp": 2}, 2),
    "dp_pp": (4, {"pp": 2}, 2),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_parallel_steps_match_jax_single_device(reference, mode, tmp_path):
    world, layout, heads = MODES[mode]
    ref = reference[heads]
    out = spawn(job_of(ref, layout), world, tmp_path, mode)
    check_against_jax(ref, out)


def test_zero_checkpoint_resumes_bitwise_at_one_rank(reference, tmp_path):
    ref = reference[2]
    saved, again = tmp_path / "zero2", tmp_path / "one"
    spawn(job_of(ref, {"fsdp": True}, ckpt_dir=str(saved)), 2, tmp_path, "zero_save")
    spawn(dict(kind="restore", cfg=ref[0], total_steps=STEPS, ckpt_dir=str(saved), out_dir=str(again),
               layout=None), 1, tmp_path, "restore")
    a = torch.load(saved / f"checkpoint-{STEPS}", weights_only=True)
    b = torch.load(again / f"checkpoint-{STEPS}", weights_only=True)
    assert a["step"] == b["step"] == STEPS
    for part in ("model", "optimizer", "balancer_params", "balancer_optimizer"):
        assert set(a[part]) == set(b[part]), part
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert torch.equal(a["generator"], b["generator"])
    # the gathered moments cover the one-device flat vector, unpadded
    n = sum(v.numel() for v in a["model"].values())
    assert a["optimizer"]["mu"].numel() == n and float(a["optimizer"]["nu"].abs().sum()) > 0
    assert int(a["optimizer"]["count"]) == STEPS


def test_meshes_and_collectives_on_four_ranks(tmp_path):
    out = spawn(dict(kind="comm"), 4, tmp_path, "comm")
    assert all(out["flags"].values()), out["flags"]
    assert set(out["errors"]) == {"copy", "reduce", "gather", "unsplit", "scatter", "split"}
    for op, (fwd, grad) in out["errors"].items():
        assert fwd <= 1e-12 and grad <= 1e-12, (op, fwd, grad)
