"""The port's FoMAML budget training step (acn_tpu_torch.pipelines.
offline_stage, utils.optim, nerfs.color / losses) against acn_tpu's.

Micro shapes: K 2 experts, T 2 tasks, 64 support and 32 query rays, 2 inner
steps, 32 bins, budget 6, a 3-level hash grid (one dense, two hashed levels)
and 16³ occupancy grids at a 60 % fill, so that the budget overflows a little.
Inputs come from numpy seeds; weights from acn_tpu's init, carried across
with acn_tpu_torch.convert; the march salts of the JAX step are replayed from
its key and handed to the port. The JAX side runs on the CPU with the scan's
XLA backend, each configuration jitted once.

Tolerances, with their reasons:

* float32 step: losses and metrics rtol 1e-5 (MLP products and segment sums
  add in another order); every parameter after two Adam steps atol 1e-6 /
  rtol 1e-4 (Adam divides by √v̂: a relative error r in a gradient is an
  error ≤ lr·r in the update); moments atol 1e-7 / rtol 1e-3.
* bf16 step (``use_amp``): the two frameworks round in different places
  (XLA keeps fused elementwise chains in float32, eager PyTorch rounds after
  every op; a bf16 scatter-add depends on its order), so metrics agree to
  rtol 5e-3 only (measured: ≤ 1.5e-3). Parameters are held by their movement
  over the two steps, leaf by leaf, against the float32 step's movement of
  that leaf: ‖Δport − ΔJAX‖₂ ≤ 0.2·‖Δf32‖₂ and cosine(Δport, ΔJAX) ≥ 0.99
  (measured: ≤ 0.09 and ≥ 0.996). The bound tells a wrong cast from a right
  one: the bf16 step itself lies 0.9–1.2 ‖Δf32‖₂ from the float32 step in
  the hash tables (cosine 0.3–0.6), which the test also asserts, so a port
  that skipped a bf16 rounding would fail it.
* optimizer alone: rtol 2e-5 against optax on the same gradients (the bias
  correction 1 − 0.999^t cancels: one ulp of 0.999^t is 3e-5 of it at t = 2),
  atol 1e-9 on updates of size lr ≈ 1e-3 (a first moment that cancels to
  near zero keeps the absolute error of its terms).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acn_tpu.models import container as jcont
from acn_tpu.nerfs import color as jcolor
from acn_tpu.nerfs import losses as jlosses
from acn_tpu.pipelines.offline_stage import meta_core as jmeta
from acn_tpu.pipelines.offline_stage import train_step as jts
from acn_tpu.utils import optim as joptim
from acn_tpu_torch import convert, toy
from acn_tpu_torch.models import container as tcont
from acn_tpu_torch.models.nn import tree_leaves, tree_map
from acn_tpu_torch.nerfs import color as tcolor
from acn_tpu_torch.nerfs import losses as tlosses
from acn_tpu_torch.pipelines.offline_stage import meta_core as tmeta
from acn_tpu_torch.pipelines.offline_stage import train_step as tts
from acn_tpu_torch.utils import optim as toptim
from test_torch_models import small_scene

K, T, S, Q = 2, 2, 64, 32
MICRO_HASH = dict(levels=3, min_res=4, max_res=32, log2_hashmap_size=10,
                  features_per_level=2, layout="cell", dense_levels=True)


def make_P(**over):
    base = dict(
        algo="fomaml", inner_iter=2, inner_lr=0.015, ray_samples=16,
        color_space="linear", bg_color_default="white", optimizer="adam",
        encoding_lr=1e-2, sigma_lr=2e-3, color_lr=2e-3, bg_lr=1e-3, lr=1e-4,
        outer_steps=10, decay_factor=10.0, no_scheduler=False, grad_clip=1.0,
        occ_s_max=32, occ_s_kept=16, occ_budget_per_ray=6, use_amp=False,
        train_chunk_rays=0, fim=False, guard_nonfinite=1)
    return types.SimpleNamespace(**{**base, **over})


@functools.lru_cache(maxsize=None)
def micro_scene(use_bg_nerf=True):
    """The micro scene in both packages, without the background head when
    asked."""
    return small_scene(K=K, sigma_bias=2.0, fill=0.6, seed=1,
                       hash_kw=MICRO_HASH, use_bg_nerf=use_bg_nerf)


def fresh_model(sc):
    return convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")


def jax_salts(key):
    """The march salts acn_tpu's step draws from ``key``: the key splits of
    ``_meta_grads_gradbased`` and ``march_rays_budget``'s ``randint``."""
    keys = jax.random.split(key, K * T).reshape(K, T, -1)
    salts = np.zeros((K, T, 2), np.int64)
    for k in range(K):
        for t in range(T):
            _, k_ms, k_mq = jax.random.split(keys[k, t], 3)
            for j, kk in enumerate((k_ms, k_mq)):
                salts[k, t, j] = int(jax.random.randint(
                    kk, (), 0, jnp.iinfo(jnp.int32).max))
    return salts


def _np(t):
    return t.detach().cpu().numpy()


def _tt(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaves(tree):
    """A port tree's leaves as numpy, in the order of ``jax.tree.leaves``
    (sorted keys; the port's own order is the order of insertion)."""
    return jax.tree.leaves(tree_map(_np, tree))


# ------------------------------------------------------------ the whole step


@functools.lru_cache(maxsize=None)
def _both_steps(use_amp):
    """Two steps of both packages from one converted state. Returns, per
    step, (JAX metrics, port metrics), and the final parameters and optimizer
    states of both."""
    sc = micro_scene()
    P = make_P(use_amp=use_amp)
    labels = jcont.param_group_labels(sc.jvars, sc.jcfg)
    jopt = joptim.build_optimizer(P, labels, grad_clip=P.grad_clip)
    jstep = jax.jit(jts.make_meta_train_step(sc.jcfg, P, jopt, sc.jocc_cfg))
    jvars = jax.tree.map(jnp.asarray, sc.jvars)
    jstate = {"variables": jvars, "opt_state": jopt.init(jvars["params"]),
              "step": jnp.zeros((), jnp.int32)}

    model = fresh_model(sc)
    topt, tstate = toy.init_train_state(model, P)
    tstep = tts.make_meta_train_step(sc.tcfg, P, topt, sc.tocc_cfg, device="cpu")

    batch = toy.training_batch(K, T, S, Q, seed=3)
    metrics = []
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           sc.jocc, key)
        tstate, tm = tstep(tstate, _tt(batch), sc.tocc, salts=jax_salts(key))
        metrics.append((jax.device_get(jm), {k: _np(v) for k, v in tm.items()}))
    return types.SimpleNamespace(
        sc=sc, P=P, metrics=metrics, labels=labels,
        jparams=jax.device_get(jstate["variables"]["params"]),
        jopt_state=jax.device_get(jstate["opt_state"]), jopt=jopt,
        tstate=tstate, tparams=convert.to_jax_variables(tstate["model"])["params"])


METRICS = ("loss_out", "loss_in", "psnr_out", "psnr_in", "loss_total",
           "grad_norm", "occ_overflow")


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("name", METRICS)
def test_two_steps_fp32_metrics(name, step):
    jm, tm = _both_steps(False).metrics[step]
    assert set(tm) == set(METRICS) and tm[name].shape == np.shape(jm[name])
    np.testing.assert_allclose(tm[name], jm[name], rtol=1e-5, atol=1e-7)
    if name == "occ_overflow":
        assert 0.0 < float(tm[name]) < 1.0  # the drop path is exercised
    if name == "grad_norm":
        assert float(tm[name]) > 0.0


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_two_steps_fp32_parameters():
    r = _both_steps(False)
    want, got, start = _flat(r.jparams), _flat(r.tparams), _flat(r.sc.jvars["params"])
    assert want.keys() == got.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-6, rtol=1e-4,
                                   err_msg=name)
        assert np.any(got[name] != start[name]), f"{name} did not move"


def test_two_steps_fp32_optimizer_state():
    r = _both_steps(False)
    tl = tcont.param_group_labels(r.tstate["model"].params())
    want = convert.opt_state_from_optax(r.jopt_state, tl)
    got = r.tstate["opt_state"]
    assert int(got["count"]) == int(want["count"]) == 2
    assert r.tstate["step"] == 2
    assert int(got["total_notfinite"]) == int(want["total_notfinite"]) == 0
    for name in ("mu", "nu"):
        for g, w in zip(_leaves(got[name]), _leaves(want[name])):
            np.testing.assert_allclose(g, w, atol=1e-7, rtol=1e-3)


def test_one_step_bf16():
    r, r32 = _both_steps(True), _both_steps(False)
    for jm, tm in r.metrics:
        for name in METRICS:
            np.testing.assert_allclose(tm[name], jm[name], rtol=5e-3, atol=1e-6,
                                       err_msg=name)
    # each leaf's movement over the two steps, against the float32 step's
    start, f32 = _flat(r.sc.jvars["params"]), _flat(r32.tparams)
    want, got = _flat(r.jparams), _flat(r.tparams)
    assert want.keys() == got.keys()
    table_gap = []
    for name in want:
        assert np.isfinite(got[name]).all(), name
        dj, dt, d32 = (np.float64(a[name]) - start[name] for a in (want, got, f32))
        scale = np.linalg.norm(d32)
        assert scale > 0.0, name
        assert np.linalg.norm(dt - dj) <= 0.2 * scale, (
            name, np.linalg.norm(dt - dj) / scale)
        cos = (dt * dj).sum() / (np.linalg.norm(dt) * np.linalg.norm(dj))
        assert cos >= 0.99, (name, cos)
        if "hash_table" in name:
            table_gap.append(np.linalg.norm(dt - d32) / scale)
    # the bound above is one that a float32 table update would not meet
    assert min(table_gap) > 0.5, table_gap


# --------------------------------------------------------- the episode loss


@pytest.mark.parametrize("use_bg_nerf", [True, False])
def test_episode_loss_and_gradient(use_bg_nerf):
    """One expert's loss and gradient, with the background head and over a
    white default background, with rays that hit nothing among them."""
    sc = micro_scene(use_bg_nerf)
    P = make_P()
    k = 1
    batch = toy.training_batch(K, T, S, Q, seed=4)
    rays, rgbs = batch["support_rays"][k, 0].copy(), batch["support_rgbs"][k, 0]
    rays[::7, 6:8] = (0.0, -1.0)  # inert: no bin, the color is the background's
    key = jax.random.PRNGKey(5)
    salt = int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max))

    jloss, jprep = jts.make_episode_loss(sc.jcfg, P, sc.jocc_cfg)
    jp = jax.tree.map(lambda a: jnp.asarray(a[k]), sc.jvars["params"]["experts"])
    jbg = jax.tree.map(jnp.asarray, sc.jvars["params"].get("bg_mlp"))
    jstate = {n: v[k] for n, v in sc.jocc.items()}
    aabb = sc.jvars["buffers"]["expert_aabbs"][k]

    def jfn(p, bg):
        smp = jprep(jstate, jnp.asarray(rays), key)
        return jloss(p, bg, jnp.asarray(aabb), jstate, jnp.asarray(rays),
                     jnp.asarray(rgbs), key, samples=smp)

    argnums = (0, 1) if use_bg_nerf else (0,)
    want, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=argnums))(jp, jbg)

    model = fresh_model(sc)
    tloss, tprep = tts.make_episode_loss(sc.tcfg, P, sc.tocc_cfg)
    params = model.params()
    tp = tcont.expert_slice(params["experts"], k)
    tp = tree_map(lambda a: a.detach().clone().requires_grad_(True), tp)
    tbg = params.get("bg_mlp")
    smp = tprep({n: v[k] for n, v in sc.tocc.items()}, torch.from_numpy(rays), salt)
    got = tloss(tp, tbg, model.expert_aabbs[k], torch.from_numpy(rays),
                torch.from_numpy(rgbs), smp)
    wrt = (tp, tbg) if use_bg_nerf else (tp,)
    flat = torch.autograd.grad(got, tree_leaves(wrt))
    it = iter(flat)
    tgrads = tree_map(lambda _: next(it), wrt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    jflat, tflat = jax.tree.leaves(jgrads), _leaves(tgrads)
    assert len(jflat) == len(tflat)
    for g, w in zip(tflat, jflat):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-7, rtol=1e-4)
    assert any(np.abs(g).max() > 0 for g in tflat)


# ------------------------------------------------------------ color, losses


def _color_inputs():
    rng = np.random.default_rng(6)
    pred = rng.uniform(-0.2, 1.2, (64, 3)).astype(np.float32)
    # ties: exactly on a clip bound, and at the sRGB knee
    pred[:4] = 1.0
    pred[4:8] = 0.0
    pred[8, 0] = 0.0031308
    gt = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    gt[:2] = 0.04045
    return pred, gt


@pytest.mark.parametrize("space", ["linear", "srgb", "identity"])
def test_aligned_mse_value_and_gradient_with_ties(space):
    pred, gt = _color_inputs()
    want, wgrad = jax.value_and_grad(
        lambda p: jlosses.aligned_mse_loss(p, jnp.asarray(gt), space))(
        jnp.asarray(pred))
    tp = torch.tensor(pred, requires_grad=True)
    got = tlosses.aligned_mse_loss(tp, torch.from_numpy(gt), space)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(_np(tp.grad), np.asarray(wgrad), rtol=1e-5,
                               atol=1e-9)
    if space == "linear":  # pred == 1.0: half of d mse / d pred, not all of it
        gt_lin = float(jcolor.srgb_to_linear(jnp.asarray(gt[0, 0])))
        np.testing.assert_allclose(_np(tp.grad)[0, 0],
                                   0.5 * 2.0 * (1.0 - gt_lin) / pred.size, rtol=1e-5)


@pytest.mark.parametrize("fn", ["linear_to_srgb", "srgb_to_linear"])
def test_color_conversions(fn):
    x = np.concatenate([_color_inputs()[0].ravel(),
                        np.float32([0.0031308, 0.04045, 1e-13, 0.5])])
    np.testing.assert_allclose(
        _np(getattr(tcolor, fn)(torch.from_numpy(x))),
        np.asarray(getattr(jcolor, fn)(jnp.asarray(x))), rtol=2e-6, atol=1e-7)


def test_psnr_and_mse():
    rng = np.random.default_rng(7)
    a, b = rng.random((2, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(tlosses.psnr(torch.from_numpy(a), torch.from_numpy(b))),
        float(jlosses.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_allclose(
        _np(tlosses.psnr_from_mse(torch.tensor([0.0, 1e-13, 0.25]))),
        np.asarray(jlosses.psnr_from_mse(jnp.asarray([0.0, 1e-13, 0.25]))),
        rtol=1e-6)
    assert float(tlosses.mse(torch.from_numpy(a), torch.from_numpy(b))) == \
        pytest.approx(float(jlosses.mse(jnp.asarray(a), jnp.asarray(b))), rel=1e-6)


# ---------------------------------------------------------------- meta_core


def test_task_adapt_fast_weights_after_two_iterations():
    rng = np.random.default_rng(8)
    p = {"lin": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                 "b": rng.normal(size=3).astype(np.float32)},
         "tabs": [rng.normal(size=(7, 3)).astype(np.float32)]}
    x = rng.normal(size=(11, 5)).astype(np.float32)
    idx = rng.integers(0, 7, 11)
    y = rng.normal(size=(11, 3)).astype(np.float32)

    def jloss(q, b, key):
        return jnp.mean((b[0] @ q["lin"]["w"] + q["lin"]["b"]
                         + q["tabs"][0][idx] - b[1]) ** 2)

    def tloss(q, b):
        return torch.mean((b[0] @ q["lin"]["w"] + q["lin"]["b"]
                           + q["tabs"][0][torch.from_numpy(idx)] - b[1]) ** 2)

    want, wl = jmeta.task_adapt(jloss, jax.tree.map(jnp.asarray, p),
                                (jnp.asarray(x), jnp.asarray(y)),
                                jax.random.PRNGKey(0), 0.1, 2, first_order=True)
    tp = _tt(p)
    got, gl = tmeta.task_adapt(tloss, tp, (torch.from_numpy(x), torch.from_numpy(y)),
                               0.1, 2, first_order=True)
    np.testing.assert_allclose(_np(gl), np.asarray(wl), rtol=1e-6)
    for g, w, start in zip(_leaves(got), jax.tree.leaves(want), jax.tree.leaves(p)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)
        assert not np.array_equal(g, start)
    for g, start in zip(tree_leaves(got), tree_leaves(tp)):
        assert g.requires_grad and g.is_leaf
        assert g.data_ptr() != start.data_ptr()  # a copy moved, not the input
    for a, b in zip(_leaves(tp), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(
        float(tmeta.global_grad_norm(tp)),
        float(jmeta.global_grad_norm(jax.tree.map(jnp.asarray, p))), rtol=1e-6)


def test_sgd_tree_is_in_place():
    w = {"a": torch.ones(3), "b": [torch.full((2,), 2.0)]}
    g = {"a": torch.full((3,), 0.5), "b": [torch.ones(2)]}
    ptr = w["a"].data_ptr()
    out = tmeta.sgd_tree(w, g, 0.1)
    assert out is w and w["a"].data_ptr() == ptr
    np.testing.assert_allclose(w["a"].numpy(), 0.95)
    np.testing.assert_allclose(w["b"][0].numpy(), 1.9)


# ----------------------------------------------------------------- optimizer


def _opt_case(case):
    """(P overrides, grad_clip, per-step gradient scales, step with a NaN)."""
    return {
        "clip_on": ({}, 1.0, (50.0, 50.0, 50.0), None),
        "clip_off": ({}, 1.0, (1e-3, 1e-3, 1e-3), None),
        "clip_across_threshold": ({}, 1.0, (1e-2, 5.0, 1e-2), None),
        "no_clip": ({}, None, (3.0, 3.0, 3.0), None),
        "no_schedule": ({"no_scheduler": True}, 1.0, (1.0, 1.0, 1.0), None),
        "nonfinite_skipped": ({}, 1.0, (1.0, 1.0, 1.0), 1),
        "no_guard": ({"guard_nonfinite": 0}, 1.0, (1.0, 1.0, 1.0), None),
    }[case]


@pytest.mark.parametrize("case", ["clip_on", "clip_off", "clip_across_threshold",
                                  "no_clip", "no_schedule", "nonfinite_skipped",
                                  "no_guard"])
def test_optimizer_three_updates_match_optax(case):
    over, clip, scales, nan_step = _opt_case(case)
    sc = micro_scene()
    P = make_P(**over)
    jparams = jax.tree.map(jnp.asarray, sc.jvars["params"])
    jlabels = jcont.param_group_labels(sc.jvars, sc.jcfg)
    jopt = joptim.build_optimizer(P, jlabels, grad_clip=clip)
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)  # one compile, not one per op

    model = fresh_model(sc)
    tparams = model.params()
    tlabels = tcont.param_group_labels(tparams)
    topt = toptim.build_optimizer(P, tlabels, grad_clip=clip)
    tstate = topt.init(tparams)

    rng = np.random.default_rng(9)
    for i, scale in enumerate(scales):
        g = jax.tree.map(lambda a: (scale / np.sqrt(a.size) * rng.normal(
            size=a.shape)).astype(np.float32), sc.jvars["params"])
        if i == nan_step:
            g["experts"]["sigma_head"]["w"][0, 0, 0] = np.nan
        jupd, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        tupd, tstate = topt.update(_tt(g), tstate)
        toptim.apply_updates(tparams, tupd)
        for a, b in zip(_leaves(tupd), jax.tree.leaves(jupd)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-5, atol=1e-9)
        if i == nan_step:
            assert all(float(u.abs().max()) == 0.0 for u in tree_leaves(tupd))
    for a, b in zip(_leaves(tparams), jax.tree.leaves(jparams)):  # ulp(0.03) = 2e-9
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-5, atol=1e-8)

    # the state carries across, both ways
    want = convert.opt_state_from_optax(jax.device_get(jstate), tlabels)
    skipped = 0 if nan_step is None else 1
    assert int(tstate["count"]) == int(want["count"]) == 3 - skipped
    if P.guard_nonfinite:
        assert int(tstate["total_notfinite"]) == int(want["total_notfinite"]) == skipped
        assert bool(tstate["last_finite"]) == bool(want["last_finite"])
    for name in ("mu", "nu"):
        for a, b in zip(_leaves(tstate[name]), _leaves(want[name])):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-9)
    back = convert.opt_state_into_optax(tstate, jax.device_get(jopt.init(jparams)),
                                        tlabels)
    wl, wdef = jax.tree.flatten(jax.device_get(jstate))
    bl, bdef = jax.tree.flatten(back)
    assert wdef == bdef
    for a, b in zip(bl, wl):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5,
                                   atol=1e-9)
    # ... and optax goes on from it as it would have from its own
    jnext, _ = jupdate(jax.tree.map(jnp.asarray, g), back, jparams)
    jwant, _ = jupdate(jax.tree.map(jnp.asarray, g), jstate, jparams)
    for a, b in zip(jax.tree.leaves(jnext), jax.tree.leaves(jwant)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5,
                                   atol=1e-9)


@pytest.mark.parametrize("step", [0, 1, 7, 10, 25])
def test_schedule_and_group_lrs(step):
    P = make_P()
    want = joptim.current_group_lrs(P, step)
    got = toptim.current_group_lrs(P, step)
    assert got.keys() == want.keys()
    for g in want:
        assert got[g] == pytest.approx(want[g], rel=1e-6)
    sched = toptim.exponential_schedule(1e-2, 10, 10.0)
    assert float(sched(torch.tensor(step))) == pytest.approx(want["encoding"], rel=1e-6)
    assert toptim.exponential_schedule(1e-2, 10, 10.0, enabled=False)(step) == 1e-2


# ------------------------------------------------- what is not ported raises


@pytest.mark.parametrize("what,kwargs,P_over,item", [
    ("maml", {}, {"algo": "maml"}, "M9"),
    ("reptile", {}, {"algo": "reptile"}, "M9"),
    ("fim", {}, {"fim": True}, "M9"),
    ("stratified", {"occ_cfg": None}, {}, "M2"),
    ("strided_march", {}, {"occ_budget_per_ray": 0}, "M3"),
    ("budget_override_0", {"budget_override": 0}, {}, "M3"),
    ("chunked_loss", {}, {"train_chunk_rays": 16}, "M2"),
    ("report_budget", {"report_budget": 8}, {}, "M3"),
])
def test_unported_branches_raise_naming_the_roadmap(what, kwargs, P_over, item):
    sc = micro_scene()
    P = make_P(**P_over)
    topt = toptim.build_optimizer(P, tcont.param_group_labels(fresh_model(sc).params()))
    kw = {"occ_cfg": sc.tocc_cfg, "device": "cpu", **kwargs}
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        tts.make_meta_train_step(sc.tcfg, P, topt, **kw)


def test_unported_meta_core_entry_points_raise():
    for fn in (tmeta.maml_outer_loss, tmeta.reptile_adapt):
        with pytest.raises(NotImplementedError, match="ROADMAP.md M9"):
            fn()
    with pytest.raises(NotImplementedError, match="ROADMAP.md M9"):
        tmeta.task_adapt(None, {}, None, 0.1, 1, first_order=False)
    with pytest.raises(NotImplementedError, match="adam"):
        toptim.build_optimizer(make_P(optimizer="sgd"), {})


def test_step_needs_a_card_unless_asked_for_the_cpu():
    sc = micro_scene()
    P = make_P()
    model = fresh_model(sc)
    topt, state = toy.init_train_state(model, P)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tts.make_meta_train_step(sc.tcfg, P, topt, sc.tocc_cfg)
    step = tts.make_meta_train_step(sc.tcfg, P, topt, sc.tocc_cfg, device="cpu")
    batch = _tt(toy.training_batch(K, T, S, Q))
    with pytest.raises(ValueError, match="lie on"):
        step(state, {k: v.to("meta") for k, v in batch.items()}, sc.tocc)


def test_salts_none_is_midpoints_and_draw_salts_is_seeded():
    a = tts.draw_salts(K, T, torch.Generator().manual_seed(3))
    b = tts.draw_salts(K, T, torch.Generator().manual_seed(3))
    assert a.shape == (K, T, 2) and torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 2**31 - 1
    sc = micro_scene()
    P = make_P(inner_iter=1)
    outs = []
    for salts in (None, a, a.numpy()):
        topt, state = toy.init_train_state(fresh_model(sc), P)
        step = tts.make_meta_train_step(sc.tcfg, P, topt, sc.tocc_cfg, device="cpu")
        _, m = step(state, _tt(toy.training_batch(K, T, S, Q)), sc.tocc, salts=salts)
        outs.append(float(m["loss_total"]))
    assert outs[1] == outs[2] and outs[0] != outs[1]


def test_training_batch_is_the_bench_construction():
    b = toy.training_batch(2, 3, 8, 4, seed=0)
    assert b["support_rays"].shape == (2, 3, 8, 8)
    assert b["query_rgbs"].shape == (2, 3, 4, 3)
    r = np.concatenate([b["support_rays"], b["query_rays"]], axis=2)
    assert r.dtype == np.float32
    np.testing.assert_array_equal(r[..., 2], 2.0)
    np.testing.assert_array_equal(r[..., 6:], np.broadcast_to([1.0, 3.0], r[..., 6:].shape))
    np.testing.assert_allclose(np.linalg.norm(r[..., 3:6], axis=-1), 1.0, rtol=1e-6)
    assert (r[..., 5] < 0).all() and (np.abs(r[..., :2]) <= 0.5).all()


# -------------------------------------------------------------- on the card


def _episode_grads(device, sc, P, rays, rgbs, salt, k=0):
    model = fresh_model(sc).to(device)
    loss_fn, prep = tts.make_episode_loss(sc.tcfg, P, sc.tocc_cfg)
    params = model.params()
    tp = tree_map(lambda a: a.detach().clone().requires_grad_(True),
                  tcont.expert_slice(params["experts"], k))
    occ = {n: v[k].to(device) for n, v in sc.tocc.items()}
    r = torch.from_numpy(rays).to(device)
    smp = prep(occ, r, salt)
    loss = loss_fn(tp, params["bg_mlp"], model.expert_aabbs[k], r,
                   torch.from_numpy(rgbs).to(device), smp)
    return loss, torch.autograd.grad(loss, tree_leaves(tp))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("use_amp", [False, True])
def test_episode_gradient_on_card_matches_plain(use_amp):
    """The kernel-backed episode gradient (forward and reverse scan kernels)
    against the CPU's plain scans; float32 tight, bf16 at bf16's resolution."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    from acn_tpu_torch.ops import segscan
    sc = micro_scene()
    P = make_P(use_amp=use_amp)
    b = toy.training_batch(K, T, S, Q, seed=4)
    rays, rgbs = b["support_rays"][0, 0], b["support_rgbs"][0, 0]
    before = (segscan.seg_excl_sum_kernel.launches,
              segscan.seg_excl_rsum_kernel.launches)
    got, ggrads = _episode_grads("cuda", sc, P, rays, rgbs, 77)
    assert (segscan.seg_excl_sum_kernel.launches,
            segscan.seg_excl_rsum_kernel.launches) == (before[0] + 1, before[1] + 1)
    want, wgrads = _episode_grads("cpu", sc, P, rays, rgbs, 77)
    rtol, atol = (5e-2, 1e-4) if use_amp else (1e-4, 1e-7)
    np.testing.assert_allclose(float(got.detach()), float(want.detach()), rtol=rtol)
    for g, w in zip(ggrads, wgrads):
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol * 10, atol=atol)
