"""The port against the JAX package over many training steps, on the CPU in
f32, each drift beside two controls.

From JAX-initialised weights carried into the port with
``utils.jax_params.params_from_jax``, on the same numpy batches and the same
injected inputs each step, four trajectories:

  * J: the JAX step. Pretraining runs ``train.pretrain.make_train_step``
    with ``masking.generate_random_masks`` patched, for this run only, to
    read the injected flat mask (as tests/test_torch_pretrain_state.py
    does); downstream runs a loss built from
    ``MaskFormerModel.apply(deterministic=True)`` and ``set_criterion`` with
    ``matched_override`` / ``point_coords_override``, and the optax chain of
    ``create_downstream_optimizer`` (as tests/test_torch_downstream_train.py
    does). Nothing in the JAX package is edited;
  * P: the port's plain path (``attn_impl='xla'``) from the same weights
    with the same injections;
  * J' and P': J and P on the same batches with their rows permuted (every
    per-sample input with them). The losses are means or sums normalised
    by counts, so J' equals J, and P' P, in exact arithmetic: each control
    is how far one framework drifts from itself by the order of its
    reductions alone;
  * D: P with the model in f64 (its optimizer and, downstream, its head's
    outputs and criterion stay f32, see tools/trajectory_torch.py), the f64
    control: which of J and P lies nearer it a step.

The injections: pretraining's masks (one a row) drawn on the host from the
seed by the port's ``ops.masking.generate_random_masks``; downstream each
step's modality subset and masks (one a row) from the seed, PointRend
points uniform from the seed, and the matches J's own (its exact scipy
matcher on its costs each step), injected into P and, permuted, into J' and
P'. The weights and the optimizer are tools/trajectory_torch.py's at
``--width small`` (the downstream weights JAX-initialised, with noise on the
deformable attention's zero kernels and ``mask_embed.layer2`` x 6 as there).

Reported step by step: the losses and their terms of J, P, J', P'; the
cross-framework drift |P - J| / |J| and the two controls |J' - J| / |J| and
|P' - P| / |P|, with their max, mean and final values; the masters' rel-L2
at the end (P against J, J' against J, P' against P, J and P against D);
J's and P's distance from D a step, and at how many steps P lies nearer;
whether the drift
stays within max(10 x the larger control, 1e-5) at every step after the
third and within 1e-4 (the three-step tests' bound) over the first three;
and, from the command line, a one-step check at every step: the port's
loss terms and every parameter's gradient from J's weights on that step's
inputs against JAX's, as the three-step tests compare them, and downstream
how many of the head's hard attention-mask bits differ between J's
weights and P's own. The command line writes the downstream run twice:
with each run's own head masks, and with the head masks of J's weights
(as the port computes them there) pinned into P, P' and D, as the matches
are (``downstream_head_masks_pinned``): the drift that is left once those
discrete decisions are shared.

Usage (200 pretraining and 50 downstream steps, PARITY_TRAJ.json's lengths;
a few minutes on one CPU core):
    python tools/trajectory_jax_torch.py --out PARITY_TRAJ_TORCH.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import trajectory_torch as tt  # noqa: E402
from chip_smoke import head_masks, mask_bits_differ  # noqa: E402
from incomplete_multimodal_fusion_tpu import config as jconfig  # noqa: E402
from incomplete_multimodal_fusion_tpu.losses import set_criterion as jsc  # noqa: E402
from incomplete_multimodal_fusion_tpu.models import maskformer as jmf  # noqa: E402
from incomplete_multimodal_fusion_tpu.ops import masking as jmask  # noqa: E402
from incomplete_multimodal_fusion_tpu.train import downstream as jds  # noqa: E402
from incomplete_multimodal_fusion_tpu.train import pretrain as jpretrain  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch import config as tconfig  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.data.synthetic import synthetic_batch, synthetic_instances  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.losses.set_criterion import SegTargets  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.models import maskformer as tmf  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.ops import masking as tmask  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.train import downstream as tds  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.train import pretrain as tpretrain  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.train.ema import init_ema  # noqa: E402
from incomplete_multimodal_fusion_tpu_torch.utils.jax_params import params_from_jax  # noqa: E402

RATIO, FLOOR = 10.0, 1e-5  # the drift's bound after the third step: max(RATIO x control, FLOOR)
FIRST, FIRST_BOUND = 3, 1e-4  # the first steps' bound: the three-step tests' rtol
LOSS_WEIGHTS = (("loss_ce", 2.0), ("loss_dice", 5.0), ("loss_mask", 5.0))  # downstream.py:213-221


def _record(runs: Dict[str, Dict[str, List[float]]], name: str, metrics, terms) -> None:
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"run {name}: the loss of step {len(runs[name]['loss'])} is {loss}")
    runs[name]["loss"].append(loss)
    for k in terms:
        runs[name]["terms"].setdefault(k, []).append(float(metrics[k]))


def _new_runs():
    return {n: {"loss": [], "terms": {}} for n in ("J", "P", "J'", "P'", "D")}


def verdict(drift: List[float], control_j: List[float], control_p: List[float]) -> Dict:
    """The drift against its bound a step: within FIRST_BOUND over the first
    FIRST steps, then within max(RATIO x the larger control, FLOOR)."""
    bound = [FIRST_BOUND if i < FIRST else max(RATIO * max(a, b), FLOOR)
             for i, (a, b) in enumerate(zip(control_j, control_p))]
    over = [i for i, (d, b) in enumerate(zip(drift, bound)) if d > b]
    ratio = [d / max(a, b, FLOOR / RATIO) for d, a, b in zip(drift, control_j, control_p)]
    # the same ratio on the running maxima: how far the drift ever got
    # against how far the controls ever got by that step
    envelope = np.maximum.accumulate(drift) / np.maximum(np.maximum.accumulate(np.maximum(control_j, control_p)),
                                                         FLOOR / RATIO)
    return {"bound_per_step": bound, "within": not over, "steps_over": over,
            "first_step_over": over[0] if over else None,
            "max_drift_over_larger_control": max(ratio[FIRST:], default=None),
            "max_running_max_ratio": float(envelope[FIRST:].max()) if len(drift) > FIRST else None}


def nearer_f64(d_j: List[float], d_p: List[float]) -> Dict:
    """Which f32 trajectory lies nearer the f64 one (D) a step: JAX's
    distance |J - D| / |D| against the port's |P - D| / |D|."""
    ratio = [p / max(j, FLOOR / RATIO) for j, p in zip(d_j, d_p)]
    return {"steps_port_nearer": sum(p <= j for j, p in zip(d_j, d_p)), "steps": len(d_j),
            "max_port_over_jax": max(ratio), "mean_port_over_jax": float(np.mean(ratio))}


def summarize(runs, jparams_final: Dict[str, torch.Tensor], models: Dict[str, torch.nn.Module],
              jprime_final: Dict[str, torch.Tensor], only=None) -> Dict:
    """Per-step drifts, their summaries and the bound's verdict, the f64
    control, and the masters' rel-L2 at the end."""
    pairs_of = {"P_vs_J": ("P", "J"), "J'_vs_J": ("J'", "J"), "P'_vs_P": ("P'", "P"), "J_vs_D": ("J", "D"),
                "P_vs_D": ("P", "D")}
    drift = {k: tt.rel_drift(runs[a]["loss"], runs[b]["loss"]) for k, (a, b) in pairs_of.items()}
    terms = {k: {n: tt.rel_drift(runs[a]["terms"][k], runs[b]["terms"][k]) for n, (a, b) in pairs_of.items()}
             for k in runs["J"]["terms"]}
    names = list(jparams_final)

    def pairs(d):
        return [(n, d[n]) for n in names]

    def rel_l2(named, ref_named, only):
        return tt.weights_drift(named, ref_named, only)[0]

    masters = {"P_vs_J": rel_l2(pairs(dict(models["P"].named_parameters())), pairs(jparams_final), only),
               "J'_vs_J": rel_l2(pairs(jprime_final), pairs(jparams_final), only),
               "P'_vs_P": rel_l2(pairs(dict(models["P'"].named_parameters())),
                                 pairs(dict(models["P"].named_parameters())), only),
               "J_vs_D": rel_l2(pairs(jparams_final), pairs(dict(models["D"].named_parameters())), only),
               "P_vs_D": rel_l2(pairs(dict(models["P"].named_parameters())),
                                pairs(dict(models["D"].named_parameters())), only)}
    return {"runs": runs, "drift": drift, "terms": terms, "masters_rel_l2": masters,
            "bound": verdict(drift["P_vs_J"]["per_step"], drift["J'_vs_J"]["per_step"],
                             drift["P'_vs_P"]["per_step"]),
            "f64": nearer_f64(drift["J_vs_D"]["per_step"], drift["P_vs_D"]["per_step"])}


def _host(tree) -> Dict[str, torch.Tensor]:
    return params_from_jax(jax.tree.map(np.asarray, tree))


def one_step_check(step: int, jterms, pterms, jgrads: Dict[str, torch.Tensor], model: torch.nn.Module) -> Dict:
    """The port against JAX from J's weights of ``step`` on that step's
    inputs, as the three-step tests compare them: each loss term's relative
    difference, the flat gradient's rel-L2 and each parameter's gradient
    error over its bound (rel-L2 1e-4 of its own norm plus 5e-8 of the
    global norm, tests/test_torch_downstream_train.py), the five worst."""
    total = float(torch.sqrt(sum(g.double().square().sum() for g in jgrads.values())))
    rows, diff = [], 0.0
    for name, want in jgrads.items():
        got = dict(model.named_parameters())[name].grad
        got = torch.zeros_like(want) if got is None else got.detach()
        err = float((got.double() - want.double()).norm())
        diff += err ** 2
        rows.append((err / (1e-4 * float(want.norm()) + 5e-8 * total), name, err, float(want.norm())))
    rows.sort(reverse=True)
    terms = {k: abs(float(pterms[k].detach()) - float(jterms[k])) / max(abs(float(jterms[k])), 1e-30)
             for k in jterms}
    return {"step": step, "terms": terms, "grad_rel_l2": diff ** 0.5 / total,
            "worst": [{"name": n, "err": e, "norm": w, "over_bound": r} for r, n, e, w in rows[:5]],
            "within": max(terms.values()) <= 1e-5 and rows[0][0] <= 1.0}


def pretrain_parity(steps: int = tt.STEPS["pretrain"], seed: int = 0, check_steps=()) -> Dict:
    """J, P, J', P' over ``steps`` pretraining steps at the small width; at
    each of ``check_steps`` also ``one_step_check`` from J's weights."""
    t0 = time.perf_counter()
    jcfg, cfg = tt.pretrain_config(jconfig, "small", "float32"), tt.pretrain_config(tconfig, "small", "float32")
    b, doms = cfg.data.batch_size, tuple(cfg.data.in_domains)
    nums, e = (cfg.data.num_patches,) * len(doms), cfg.mask.num_encoded_tokens
    perm = tt.fixed_permutation(b, seed)
    tperm = torch.as_tensor(perm)
    rng = np.random.default_rng(seed)
    pool = [synthetic_batch(rng, doms, b, cfg.data.input_size) for _ in range(tt.POOL)]
    model, state0, tx = jpretrain.create_train_state(jcfg, jax.random.PRNGKey(seed), steps)
    params = params_from_jax(jax.tree.map(np.asarray, state0.params))

    held = {}
    real = jpretrain.masking.generate_random_masks
    raw = jpretrain.make_train_step(model, jcfg, tx)

    @jax.jit
    def jstep(state, batch, flat):
        held["flat"] = flat
        return raw(state, batch)

    cfg64 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float64"))

    def port(c=cfg):
        m, s, o = tpretrain.create_train_state(c, seed, total_steps=steps, device="cpu")
        m.load_state_dict(params, strict=True)
        if c is cfg64:
            m.double()
        s.ema = init_ema(m.named_parameters())
        m.attn_impl = "xla"
        return m, s, tpretrain.make_train_step(m, c, o)

    (pm, ps, pstep), (qm, qs, qstep), (dm, ds, dstep) = port(), port(), port(cfg64)
    runs, terms = _new_runs(), tt.TERMS["pretrain"]
    js, js2 = state0, state0
    checks, check_steps = [], set(check_steps)
    if check_steps:
        jgrad = jax.jit(jax.value_and_grad(jpretrain.make_loss_fn(model, jcfg), argnums=(0, 1), has_aux=True))
        cm = port()[0]
        closs = tpretrain.make_loss_fn(cm, cfg)
    g = torch.Generator().manual_seed(seed)
    jpretrain.masking.generate_random_masks = (
        lambda *a, **k: jmask.mask_info_from_flat_mask(held["flat"], doms, nums, e))
    try:
        for i in range(steps):
            mi = tt.pretrain_masks(g, cfg, b)
            flat = torch.cat([mi.task_masks[d] for d in doms], dim=1).numpy()
            batch = pool[i % tt.POOL]
            pbatch = {d: v[perm] for d, v in batch.items()}
            if i in check_steps:
                jmi = jmask.mask_info_from_flat_mask(jnp.asarray(flat), doms, nums, e)
                (_, jm), (g_params, _) = jgrad(js.params, js.balancer_params, jax.tree.map(jnp.asarray, batch), jmi,
                                                jax.random.PRNGKey(0))
                cm.load_state_dict(_host(js.params))
                bal = {t: torch.tensor(float(v), requires_grad=True) for t, v in js.balancer_params.items()}
                cm.zero_grad(set_to_none=True)
                loss, pmetrics = closs(dict(cm.named_parameters()), {d: torch.from_numpy(v) for d, v in batch.items()},
                                       mi, bal)
                loss.backward()
                checks.append(one_step_check(i, {k: jm[k] for k in ("loss",) + terms[:-1]}, pmetrics, _host(g_params),
                                             cm))
            js, m = jstep(js, jax.tree.map(jnp.asarray, batch), jnp.asarray(flat))
            _record(runs, "J", m, terms)
            js2, m = jstep(js2, jax.tree.map(jnp.asarray, pbatch), jnp.asarray(flat[perm]))
            _record(runs, "J'", m, terms)
            ps, m = pstep(ps, batch, mask_info=tmask.mask_info_from_flat_mask(torch.from_numpy(flat), doms, nums, e))
            _record(runs, "P", m, terms)
            qs, m = qstep(qs, pbatch, mask_info=tt.permute_mask_info(mi, tperm))
            _record(runs, "P'", m, terms)
            ds, m = dstep(ds, batch, mask_info=mi)
            _record(runs, "D", m, terms)
    finally:
        jpretrain.masking.generate_random_masks = real
    out = summarize(runs, _host(js.params), {"P": pm, "P'": qm, "D": dm}, _host(js2.params))
    out.update(steps=steps, batch=b, seed=seed, permutation=perm.tolist(), seconds=time.perf_counter() - t0)
    if checks:
        out["one_step_checks"] = checks
    return out


def _perturb_flax(params, seed: int):
    """tools/trajectory_torch.py's two changes to the initializers on a flax
    tree: N(0, 0.02) noise (numpy, from the seed) on the deformable
    attention's sampling-offset and attention-weight kernels, and
    mask_embed.layer2 x 6."""
    rng = np.random.default_rng(seed + 1)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif k == "kernel" and path[-1] in ("sampling_offsets", "attention_weights"):
                out[k] = np.asarray(v) + 0.02 * rng.standard_normal(v.shape).astype(np.float32)
            elif path[-2:] == ("mask_embed", "layer2"):
                out[k] = np.asarray(v) * np.float32(6.0)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(params, ())


def downstream_parity(steps: int = tt.STEPS["downstream"], seed: int = 0, check_steps=(),
                      pin_head_masks: bool = False) -> Dict:
    """J, P, J', P', D over ``steps`` downstream steps at the small width; at
    each of ``check_steps`` also ``one_step_check`` from J's weights, with
    J's matches of that step. With ``pin_head_masks`` the Mask2Former head's
    hard attention masks of J's weights, as the port computes them there,
    are pinned into P, D and (permuted) P' each step, as the matches are; J
    and J' keep their own."""
    t0 = time.perf_counter()
    fields = tt.segment_config("small")
    jcfg, cfg = jmf.MaskFormerConfig(**fields), tmf.MaskFormerConfig(**fields)
    b, npts = tt.BATCH["small"]["downstream"], tt.POINTS["small"]
    perm = tt.fixed_permutation(b, seed)
    tperm = torch.as_tensor(perm)
    rng = np.random.default_rng(seed)
    pool = [synthetic_instances(rng, b, cfg.image_size, cfg.num_classes) for _ in range(tt.POOL)]
    jm = jmf.MaskFormerModel(jcfg)
    e = jcfg.max_encoded_tokens
    jparams = _perturb_flax(jax.jit(jm.init)(jax.random.PRNGKey(seed), jax.tree.map(jnp.asarray, pool[0][0]))["params"],
                            seed)
    costs = dict(cost_class=2.0, cost_mask=5.0, cost_dice=5.0)

    def loss(params, batch, targets, mi, present, matched_in, use_own, coords, key):
        out = jm.apply({"params": params}, batch, mask_info=mi, num_encoded_tokens=e, present=present,
                       deterministic=True)
        own = jnp.stack([jsc.hungarian_match(c) for c in jsc.set_criterion_costs(out, targets, key, num_points=npts,
                                                                                   **costs)])
        matched = jnp.where(use_own, own, matched_in)
        losses = jsc.set_criterion(out, targets, key, jcfg.num_classes, num_points=npts, **costs,
                                   matched_override=matched, point_coords_override=coords)
        parts = {name: w * sum(v for k, v in losses.items() if k.startswith(name)) for name, w in LOSS_WEIGHTS}
        total = 0.3 * parts["loss_ce"] + 0.3 * parts["loss_dice"] + 0.4 * parts["loss_mask"]
        return total, (parts, matched)

    tx = jds.create_downstream_optimizer(jparams, lr=tt.LR, clip_grad=tt.CLIP, frozen_stages=jcfg.frozen_stages)
    nums = (cfg.num_patches,) * len(cfg.in_domains)

    @jax.jit
    def jstep(params, opt_state, batch, targets, flat, present, matched_in, use_own, coords, key):
        """One J step: (params, opt_state, metrics, the matches it used)."""
        mi = jmask.mask_info_from_flat_mask(flat, cfg.in_domains, nums, e)
        (total, (parts, matched)), grads = jax.value_and_grad(loss, has_aux=True)(
            params, batch, targets, mi, present, matched_in, use_own, coords, key)
        upd, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, upd), opt_state,
                dict(parts, loss=total, grad_norm=optax.global_norm(grads)), matched)

    start = params_from_jax(jparams)

    def port(dtype="float32"):
        m = tmf.build_maskformer(cfg, device="cpu")
        m.load_state_dict(start, strict=True)
        if dtype == "float64":
            m.double()
        m.attn_impl = "xla"
        opt = tds.create_downstream_optimizer(m, lr=tt.LR, clip_grad=tt.CLIP, frozen_stages=cfg.frozen_stages)
        step = tds.make_downstream_train_step(m, cfg, opt, num_points=npts, compute_dtype=dtype)
        return m, step, tds.DownstreamState(m, opt, torch.Generator().manual_seed(seed))

    (pm, pstep, ps), (qm, qstep, qs), (dm, dstep, ds) = port(), port(), port("float64")
    trainable = tds.freeze_mask(pm, cfg.frozen_stages)
    checks, check_steps = [], set(check_steps)
    if check_steps:
        jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    if check_steps or pin_head_masks:
        cm, cstep, _ = port()  # the port at J's weights
    runs, terms = _new_runs(), tt.TERMS["downstream"]
    jp, jopt = jparams, tx.init(jparams)
    jp2, jopt2 = jparams, tx.init(jparams)
    g = torch.Generator().manual_seed(seed)
    levels = jcfg.dec_layers + 1
    for i in range(steps):
        present, mi, key = tt.segment_draws(g, cfg, b)
        x, t = pool[i % tt.POOL]
        gcols = t.labels.shape[1]
        coords = rng.uniform(0.0, 1.0, (levels, b * gcols, npts, 2)).astype(np.float32)
        flat = torch.cat([mi.task_masks[d] for d in cfg.in_domains], dim=1).numpy()
        xp, tp = {d: v[perm] for d, v in x.items()}, SegTargets(*(np.asarray(a)[perm] for a in t))
        cp = tt.permute_coords(torch.from_numpy(coords), tperm, b).numpy()
        jkey = jax.random.PRNGKey(key % (2 ** 31))

        def jrun(params, opt_state, batch, targets, flat_mask, matched_in, use_own, pts):
            params, opt_state, metrics, matched = jstep(
                params, opt_state, jax.tree.map(jnp.asarray, batch), jsc.SegTargets(*(jnp.asarray(a) for a in targets)),
                jnp.asarray(flat_mask), jnp.asarray(present.numpy()), jnp.asarray(matched_in), use_own,
                jnp.asarray(pts), jkey)
            return params, opt_state, metrics, np.array(matched)

        before = jp
        jp, jopt, m, matched = jrun(jp, jopt, x, t, flat, np.zeros((levels, b, gcols), np.int32), True, coords)
        _record(runs, "J", m, terms)
        args = ({d: torch.from_numpy(v) for d, v in x.items()}, tds.as_targets(t, "cpu"), mi, present, 0)
        kw = dict(matched_override=torch.from_numpy(matched), point_coords_override=torch.from_numpy(coords))
        if i in check_steps or pin_head_masks:
            cm.load_state_dict(_host(before))
        if i in check_steps:
            jmi = jmask.mask_info_from_flat_mask(jnp.asarray(flat), cfg.in_domains,
                                                 (cfg.num_patches,) * len(cfg.in_domains), e)
            (jl, (jparts, _)), jg = jgrad(before, jax.tree.map(jnp.asarray, x),
                                          jsc.SegTargets(*(jnp.asarray(a) for a in t)), jmi,
                                          jnp.asarray(present.numpy()), jnp.asarray(matched), False,
                                          jnp.asarray(coords), jkey)
            cm.zero_grad(set_to_none=True)
            closs, cmetrics = cstep.loss_fn(dict(cm.named_parameters()), *args, **kw)
            closs.backward()
            checks.append(one_step_check(i, dict(jparts, loss=jl), cmetrics, _host(jg), cm))
        jbits = None
        if i in check_steps or pin_head_masks:
            # the head's hard attention masks at J's weights, against P's own
            # (the trajectory's): the discrete decisions the weights' drift flips
            with torch.no_grad(), head_masks(cm) as jbits:
                cstep.loss_fn(dict(cm.named_parameters()), *args, **kw)
        if i in check_steps:
            with torch.no_grad(), head_masks(pm) as pbits:
                pstep.loss_fn(dict(pm.named_parameters()), *args, **kw)
            checks[-1]["head_mask_bits_P_vs_J_weights"] = list(mask_bits_differ(jbits, pbits))
        pinned = jbits if pin_head_masks else None
        jp2, jopt2, m, _ = jrun(jp2, jopt2, xp, tp, flat[perm], matched[:, perm], False, cp)
        _record(runs, "J'", m, terms)
        with head_masks(pm, pinned):
            ps, m = pstep(ps, x, t, torch.from_numpy(matched), mask_info=mi, present=present,
                          point_coords_override=torch.from_numpy(coords), deterministic=True)
        _record(runs, "P", m, terms)
        with head_masks(qm, None if pinned is None else [a[tperm] for a in pinned]):
            qs, m = qstep(qs, xp, tp, torch.from_numpy(matched[:, perm]), mask_info=tt.permute_mask_info(mi, tperm),
                          present=present, point_coords_override=torch.from_numpy(cp), deterministic=True)
        _record(runs, "P'", m, terms)
        with head_masks(dm, pinned):
            ds, m = dstep(ds, x, t, torch.from_numpy(matched), mask_info=mi, present=present,
                          point_coords_override=torch.from_numpy(coords), deterministic=True)
        _record(runs, "D", m, terms)
    out = summarize(runs, _host(jp), {"P": pm, "P'": qm, "D": dm}, _host(jp2), only=trainable)
    out.update(steps=steps, batch=b, points=npts, seed=seed, permutation=perm.tolist(),
               head_masks="J's, pinned into P, P' and D" if pin_head_masks else "each run's own",
               seconds=time.perf_counter() - t0)
    if checks:
        out["one_step_checks"] = checks
    return out


def _brief(name: str, res: Dict) -> str:
    d = res["drift"]
    parts = [f"{name}: {res['steps']} steps, {res['seconds']:.1f} s"]
    for k in ("P_vs_J", "J'_vs_J", "P'_vs_P"):
        parts.append(f"{k} max {d[k]['max']:.3g} mean {d[k]['mean']:.3g} final {d[k]['final']:.3g} "
                     f"masters {res['masters_rel_l2'][k]:.3g}")
    f = res["f64"]
    parts.append(f"f64 control D: J max {d['J_vs_D']['max']:.3g} mean {d['J_vs_D']['mean']:.3g}, P max "
                 f"{d['P_vs_D']['max']:.3g} mean {d['P_vs_D']['mean']:.3g}; the port nearer D at "
                 f"{f['steps_port_nearer']} of {f['steps']} steps")
    v = res["bound"]
    parts.append(f"within the bound: {v['within']} (steps over {v['steps_over']}; largest drift / control after "
                 f"step {FIRST}: {v['max_drift_over_larger_control']:.3g}, of their running maxima "
                 f"{v['max_running_max_ratio']:.3g})")
    checks = res.get("one_step_checks")
    if checks:
        worst = max(checks, key=lambda c: max(c["terms"].values()))
        parts.append(f"one-step checks from J's weights: {sum(c['within'] for c in checks)} of {len(checks)} within "
                     f"the three-step tests' bounds; largest term difference {max(worst['terms'].values()):.3g} "
                     f"(step {worst['step']}), largest flat gradient rel-L2 "
                     f"{max(c['grad_rel_l2'] for c in checks):.3g}")
    return "; ".join(parts)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pretrain_steps", type=int, default=tt.STEPS["pretrain"])
    ap.add_argument("--downstream_steps", type=int, default=tt.STEPS["downstream"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(1)
    result = {"what": "port (P) against JAX (J) on the CPU in f32, each beside its permuted-rows control",
              "bound": f"after step {FIRST}: max({RATIO:g} x the larger control, {FLOOR:g}); steps 0-{FIRST - 1}: "
                       f"{FIRST_BOUND:g}",
              "torch": torch.__version__, "jax": jax.__version__}
    for name, fn, steps, kw in (("pretrain", pretrain_parity, args.pretrain_steps, {}),
                                ("downstream", downstream_parity, args.downstream_steps, {}),
                                ("downstream_head_masks_pinned", downstream_parity, args.downstream_steps,
                                 {"pin_head_masks": True})):
        result[name] = fn(steps, args.seed, check_steps=range(steps), **kw)
        print(_brief(name, result[name]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
