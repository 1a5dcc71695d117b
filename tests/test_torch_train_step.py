"""The port's FoMAML training step in its three regimes, and its eval step
(acn_tpu_torch.pipelines.offline_stage, utils.optim, nerfs.color / losses),
against acn_tpu's.

Micro shapes: K 2 experts, T 2 tasks, 64 support and 32 query rays, 2 inner
steps, 16 stratified samples, 32 bins, 16 kept samples, budget 6, a 3-level
hash grid (one dense, two hashed levels) and 16³ occupancy grids at a 60 %
fill, so that the budget overflows a little. Inputs come from numpy seeds;
weights from acn_tpu's init, carried across with acn_tpu_torch.convert; the
JAX step's draws (march salts, the strided march's jitter and phases, the
stratified jitter of every loss) are replayed from its key and handed to the
port through a ``draws`` function. The JAX side runs on the CPU with the scan's XLA backend, each
configuration jitted once.

The regimes: "budget" (packed march, ``occ_budget_per_ray`` 6), "strided"
(per-ray march with ``report_budget`` 6, so that ``occ_overflow`` is the
would-be drop) and "stratified" (no occupancy). Each is held at the same
tolerances.

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
from acn_tpu.models import encodings as jenc
from acn_tpu.nerfs import color as jcolor
from acn_tpu.nerfs import losses as jlosses
from acn_tpu.pipelines.offline_stage import meta_core as jmeta
from acn_tpu.pipelines.offline_stage import train_step as jts
from acn_tpu.utils import optim as joptim
from acn_tpu_torch import convert, toy
from acn_tpu_torch.models import container as tcont
from acn_tpu_torch.models import encodings as tenc
from acn_tpu_torch.models.nn import tree_leaves, tree_map
from acn_tpu_torch.nerfs import color as tcolor
from acn_tpu_torch.nerfs import losses as tlosses
from acn_tpu_torch.pipelines.offline_stage import meta_core as tmeta
from acn_tpu_torch.pipelines.offline_stage import train_step as tts
from acn_tpu_torch.pipelines.offline_stage import trainer as ttrainer
from acn_tpu_torch.utils import checkpoint as tck
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
def micro_scene(use_bg_nerf=True, sigma_bias=2.0):
    """The micro scene in both packages, without the background head when
    asked."""
    return small_scene(K=K, sigma_bias=sigma_bias, fill=0.6, seed=1,
                       hash_kw=MICRO_HASH, use_bg_nerf=use_bg_nerf)


def optax_to_port(jstate, topt):
    """An optax state of ``build_optimizer`` as the port's optimizer state
    on the CPU, through the state-dict form that the checkpoints keep
    (flax's ``to_state_dict`` of it is that form)."""
    from flax import serialization

    return tck.opt_state_from_dict(serialization.to_state_dict(jax.device_get(jstate)),
                                   topt, device="cpu")


def port_to_optax(tstate, topt, template):
    """The port's optimizer state as optax's, written into ``template`` (an
    optax state of the same optimizer) from the state-dict form."""
    from flax import serialization

    return serialization.from_state_dict(template, tck.optim_state_dict(tstate, topt))


def fresh_model(sc):
    return convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")


def jax_draws(key, mode="train", iterations=2):
    """The draws of acn_tpu's train step (``mode`` "train") or eval step
    ("eval", ``iterations`` inner steps) from ``key``, as the port's
    ``EpisodeDraws`` asks for them: the key splits of
    ``_meta_grads_gradbased`` / ``make_eval_step``, ``task_adapt`` and the
    episode loss, and the draws of ``march_rays_budget``, ``march_rays`` and
    ``stratified_t_vals``."""
    keys = jax.random.split(key, K * T).reshape(K, T, -1)

    def fn(what, k, t, j, shape):
        if mode == "train":
            kk, k_ms, k_mq = jax.random.split(keys[k, t], 3)
            k_in, k_q = jax.random.split(kk)
        else:
            k_in, k_q, k_ms, k_mq = jax.random.split(keys[k, t], 4)
        if what == "salt":
            return int(jax.random.randint((k_ms, k_mq)[j], (), 0,
                                          jnp.iinfo(jnp.int32).max))
        if what in ("u", "phase"):
            k_jit, k_phase = jax.random.split((k_ms, k_mq)[j])
            if what == "u":
                return np.array(jax.random.uniform(k_jit, shape, dtype=jnp.float32))
            return np.array(jax.random.randint(k_phase, shape, 0, 1 << 30), np.int64)
        assert what == "strat_u"
        loss_key = jax.random.split(k_in, iterations)[j] if j < iterations else k_q
        k_render = jax.random.split(loss_key)[0]
        return np.array(jax.random.uniform(k_render, shape, dtype=jnp.float32))

    return fn


def _np(t):
    return t.detach().cpu().numpy()


def _tt(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaves(tree):
    """A port tree's leaves as numpy, in the order of ``jax.tree.leaves``
    (sorted keys; the port's own order is the order of insertion)."""
    return jax.tree.leaves(tree_map(_np, tree))


# ------------------------------------------------------------ the whole step


REGIMES = ("stratified", "strided")


def regime_setup(regime, **P_over):
    """(scene, P, JAX occ_cfg, port occ_cfg, JAX occ states, port occ
    states, report_budget) of a regime.

    The stratified regime's scene has the σ-head bias at −0.5, not +2: its
    16 samples span the whole ray, and at σ ≈ e² the rays' transmittance
    falls to ≈ 5e-5, where 1 − acc (the background's weight, and its
    gradient) keeps no float32 digit that both frameworks agree on. The
    metrics agree to 1e-8 at every bias tried (−1, −0.5, 0, +0.5, +1); the
    parameters sit on the tolerances' edges at some: at 0 and +1 a table
    entry whose gradients cancel over the tasks ends 1.7e-6 / 1.8e-6 apart
    in float32 (Adam bounds the error of an update by lr·r/4), and in bf16
    at −1 and +0.5 one small leaf (a 16-entry bias, a trunk weight) has an
    entry whose near-zero gradient takes the other sign, a gap of 0.28 /
    0.25 of its float32 movement against the bound 0.2."""
    sc = micro_scene(sigma_bias=-0.5 if regime == "stratified" else 2.0)
    return (sc, *_regime_setup(sc, regime, **P_over))


def _regime_setup(sc, regime, **P_over):
    if regime == "budget":
        return make_P(**P_over), sc.jocc_cfg, sc.tocc_cfg, sc.jocc, sc.tocc, 0
    if regime == "strided":
        return (make_P(occ_budget_per_ray=0, **P_over), sc.jocc_cfg, sc.tocc_cfg,
                sc.jocc, sc.tocc, 6)
    # acn_tpu's dummy_occ_states, written out: its trainer module imports
    # flax (checkpoints), which the card tests here run without
    return (make_P(**P_over), None, None, jnp.zeros((K,), jnp.float32),
            ttrainer.dummy_occ_states(K), 0)


@functools.lru_cache(maxsize=None)
def _both_steps(use_amp, regime="budget"):
    """Two steps of both packages from one converted state. Returns, per
    step, (JAX metrics, port metrics), and the final parameters and optimizer
    states of both."""
    sc, P, jocc_cfg, tocc_cfg, jocc, tocc, report = regime_setup(regime,
                                                                 use_amp=use_amp)
    labels = jcont.param_group_labels(sc.jvars, sc.jcfg)
    jopt = joptim.build_optimizer(P, labels, grad_clip=P.grad_clip)
    jstep = jax.jit(jts.make_meta_train_step(sc.jcfg, P, jopt, jocc_cfg,
                                             report_budget=report))
    jvars = jax.tree.map(jnp.asarray, sc.jvars)
    jstate = {"variables": jvars, "opt_state": jopt.init(jvars["params"]),
              "step": jnp.zeros((), jnp.int32)}

    model = fresh_model(sc)
    topt, tstate = toy.init_train_state(model, P)
    tstep = tts.make_meta_train_step(sc.tcfg, P, topt, tocc_cfg,
                                     report_budget=report, device="cpu")

    batch = toy.training_batch(K, T, S, Q, seed=3)
    metrics = []
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jocc, key)
        tstate, tm = tstep(tstate, _tt(batch), tocc, draws=jax_draws(key))
        metrics.append((jax.device_get(jm), {k: _np(v) for k, v in tm.items()}))
    return types.SimpleNamespace(
        sc=sc, P=P, metrics=metrics, labels=labels, regime=regime,
        jparams=jax.device_get(jstate["variables"]["params"]),
        jopt_state=jax.device_get(jstate["opt_state"]), jopt=jopt,
        topt=topt, tstate=tstate, tparams=convert.to_jax_variables(tstate["model"])["params"])


METRICS = ("loss_out", "loss_in", "psnr_out", "psnr_in", "loss_total",
           "grad_norm", "occ_overflow")


def _check_metric(r, name, step):
    jm, tm = r.metrics[step]
    assert set(tm) == set(METRICS) and tm[name].shape == np.shape(jm[name])
    np.testing.assert_allclose(tm[name], jm[name], rtol=1e-5, atol=1e-7)
    if name == "occ_overflow":
        if r.regime == "stratified":
            assert float(tm[name]) == 0.0
        else:  # the (would-be) drop is exercised
            assert 0.0 < float(tm[name]) < 1.0
    if name == "grad_norm":
        assert float(tm[name]) > 0.0


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("name", METRICS)
def test_two_steps_fp32_metrics(name, step):
    _check_metric(_both_steps(False), name, step)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("regime", REGIMES)
def test_two_steps_fp32_metrics_by_regime(regime, name, step):
    _check_metric(_both_steps(False, regime), name, step)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_parameters(r):
    want, got, start = _flat(r.jparams), _flat(r.tparams), _flat(r.sc.jvars["params"])
    assert want.keys() == got.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-6, rtol=1e-4,
                                   err_msg=name)
        assert np.any(got[name] != start[name]), f"{name} did not move"


def test_two_steps_fp32_parameters():
    _check_parameters(_both_steps(False))


@pytest.mark.parametrize("regime", REGIMES)
def test_two_steps_fp32_parameters_by_regime(regime):
    _check_parameters(_both_steps(False, regime))


def _check_optimizer_state(r):
    want = optax_to_port(r.jopt_state, r.topt)
    got = r.tstate["opt_state"]
    assert int(got["count"]) == int(want["count"]) == 2
    assert r.tstate["step"] == 2
    assert int(got["total_notfinite"]) == int(want["total_notfinite"]) == 0
    for name in ("mu", "nu"):
        for g, w in zip(_leaves(got[name]), _leaves(want[name])):
            np.testing.assert_allclose(g, w, atol=1e-7, rtol=1e-3)


def test_two_steps_fp32_optimizer_state():
    _check_optimizer_state(_both_steps(False))


@pytest.mark.parametrize("regime", REGIMES)
def test_two_steps_fp32_optimizer_state_by_regime(regime):
    _check_optimizer_state(_both_steps(False, regime))


def _check_bf16(r, r32):
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


def test_one_step_bf16():
    _check_bf16(_both_steps(True), _both_steps(False))


@pytest.mark.parametrize("regime", REGIMES)
def test_one_step_bf16_by_regime(regime):
    _check_bf16(_both_steps(True, regime), _both_steps(False, regime))


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


@pytest.mark.parametrize("regime", REGIMES)
def test_episode_loss_and_gradient_by_regime(regime):
    """One expert's loss and gradient in the stratified and the strided
    regime, with JAX's own march and stratified draws from one key, float32,
    with rays that hit nothing among them."""
    sc, P, jocc_cfg, tocc_cfg, jocc, tocc, report = regime_setup(regime)
    k = 0
    batch = toy.training_batch(K, T, S, Q, seed=5)
    rays, rgbs = batch["support_rays"][k, 1].copy(), batch["support_rgbs"][k, 1]
    rays[::9, 6:8] = (0.0, -1.0)  # inert: no bin, the color is the background's
    key = jax.random.PRNGKey(6)
    jloss, jprep = jts.make_episode_loss(sc.jcfg, P, jocc_cfg, report_budget=report)
    jp = jax.tree.map(lambda a: jnp.asarray(a[k]), sc.jvars["params"]["experts"])
    jbg = jax.tree.map(jnp.asarray, sc.jvars["params"]["bg_mlp"])
    jstate = {n: v[k] for n, v in jocc.items()} if jocc_cfg else None
    aabb = jnp.asarray(sc.jvars["buffers"]["expert_aabbs"][k])

    def jfn(p, bg):
        smp = jprep(jstate, jnp.asarray(rays), key)
        return jloss(p, bg, aabb, jstate, jnp.asarray(rays), jnp.asarray(rgbs), key,
                     samples=smp)

    want, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(jp, jbg)

    n = rays.shape[0]
    k_jit, k_phase = jax.random.split(key)
    rand = None if regime == "stratified" else (
        torch.from_numpy(np.array(jax.random.uniform(k_jit, (n, P.occ_s_max)))),
        torch.from_numpy(np.array(jax.random.randint(k_phase, (n,), 0, 1 << 30),
                                  np.int64)))
    u = (torch.from_numpy(np.array(jax.random.uniform(
        jax.random.split(key)[0], (n, P.ray_samples)))) if regime == "stratified"
        else None)
    model = fresh_model(sc)
    tloss, tprep = tts.make_episode_loss(sc.tcfg, P, tocc_cfg, report_budget=report)
    params = model.params()
    tp = tree_map(lambda a: a.detach().clone().requires_grad_(True),
                  tcont.expert_slice(params["experts"], k))
    tbg = params["bg_mlp"]
    smp = tprep({n_: v[k] for n_, v in tocc.items()} if tocc_cfg else None,
                torch.from_numpy(rays), rand)
    if regime == "strided":
        assert smp["mask"].any() and not smp["mask"].all()
    got = tloss(tp, tbg, model.expert_aabbs[k], torch.from_numpy(rays),
                torch.from_numpy(rgbs), smp, u=u)
    flat = torch.autograd.grad(got, tree_leaves((tp, tbg)))
    it = iter(flat)
    tgrads = tree_map(lambda _: next(it), (tp, tbg))
    jflat, tflat = jax.tree.leaves(jgrads), _leaves(tgrads)
    assert len(jflat) == len(tflat)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in zip(tflat, jflat):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-7, rtol=1e-4)
    assert all(np.abs(g).max() > 0 for g in tflat[-4:])  # bg head and more


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

    seen = []

    def tloss(q, b, i):
        seen.append(i)  # the iteration, where JAX passes its key
        return torch.mean((b[0] @ q["lin"]["w"] + q["lin"]["b"]
                           + q["tabs"][0][torch.from_numpy(idx)] - b[1]) ** 2)

    want, wl = jmeta.task_adapt(jloss, jax.tree.map(jnp.asarray, p),
                                (jnp.asarray(x), jnp.asarray(y)),
                                jax.random.PRNGKey(0), 0.1, 2, first_order=True)
    tp = _tt(p)
    got, gl = tmeta.task_adapt(tloss, tp, (torch.from_numpy(x), torch.from_numpy(y)),
                               0.1, 2, first_order=True)
    np.testing.assert_allclose(_np(gl), np.asarray(wl), rtol=1e-6)
    assert seen == [0, 1]
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
    want = optax_to_port(jstate, topt)
    skipped = 0 if nan_step is None else 1
    assert int(tstate["count"]) == int(want["count"]) == 3 - skipped
    if P.guard_nonfinite:
        assert int(tstate["total_notfinite"]) == int(want["total_notfinite"]) == skipped
        assert bool(tstate["last_finite"]) == bool(want["last_finite"])
    for name in ("mu", "nu"):
        for a, b in zip(_leaves(tstate[name]), _leaves(want[name])):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-9)
    back = port_to_optax(tstate, topt, jax.device_get(jopt.init(jparams)))
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


@pytest.mark.parametrize("kwargs,P_over,regime", [
    ({"occ_cfg": None}, {}, "stratified"),
    ({}, {"occ_budget_per_ray": 0}, "strided"),
    ({"budget_override": 0}, {}, "strided"),
    ({"report_budget": 8}, {}, "budget"),
    ({"budget_override": 3, "report_budget": 8}, {"occ_budget_per_ray": 0}, "budget"),
    ({}, {"train_chunk_rays": 4}, "budget"),
])
def test_regimes_are_picked_as_acn_tpu_picks_them(kwargs, P_over, regime):
    sc = micro_scene()
    P = make_P(**P_over)
    kw = {"occ_cfg": sc.tocc_cfg, **kwargs}
    assert tts.regime_of(kw["occ_cfg"], P, kw.get("budget_override")) == regime
    topt = toptim.build_optimizer(P, tcont.param_group_labels(fresh_model(sc).params()))
    tts.make_meta_train_step(sc.tcfg, P, topt, device="cpu", **kw)
    tts.make_eval_step(sc.tcfg, P, kw["occ_cfg"], device="cpu")


# ------------------------------------- the errors acn_tpu raises, raised


def _error_case(what):
    """(the port's call, acn_tpu's call, the exception, its message) of an
    error that both packages raise."""
    sc = micro_scene()
    labels = tcont.param_group_labels(fresh_model(sc).params())
    jlabels = jcont.param_group_labels(sc.jvars, sc.jcfg)

    def step(**P_over):
        P = make_P(**P_over)
        return (lambda: tts.make_meta_train_step(
            sc.tcfg, P, toptim.build_optimizer(P, labels), sc.tocc_cfg, device="cpu"),
            lambda: jts.make_meta_train_step(
                sc.jcfg, P, joptim.build_optimizer(P, jlabels), sc.jocc_cfg))

    def bad_table(pkg):
        cfg = sc.tcfg.expert.hash if pkg is tenc else sc.jcfg.expert.hash
        tables = [a[0] for a in sc.jvars["params"]["experts"]["hash_table"]]
        if pkg is tenc:
            tables = [torch.from_numpy(np.array(a)) for a in tables]
        x01 = np.full((4, 3), 0.5, np.float32)
        x01 = torch.from_numpy(x01) if pkg is tenc else jnp.asarray(x01)
        return lambda: pkg.hash_encode(tables, x01,
                                       dataclasses.replace(cfg, log2_hashmap_size=11))

    P_bad = make_P(optimizer="lamb")
    return {
        "fim_with_maml": (*step(algo="maml", fim=True), ValueError, "first-order"),
        "unknown_algo": (*step(algo="sgd_maml"), ValueError, "Unsupported algo"),
        "unknown_optimizer": (lambda: toptim.build_optimizer(P_bad, labels),
                              lambda: joptim.build_optimizer(P_bad, jlabels),
                              ValueError, "Unsupported optimizer"),
        "no_outer_loss_for_reptile": (lambda: tmeta.outer_loss_fn_for("reptile"),
                                      lambda: jmeta.outer_loss_fn_for("reptile"),
                                      ValueError, "reptile has no outer loss"),
        "table_off_the_ladder": (bad_table(tenc), bad_table(jenc), ValueError,
                                 "config ladder"),
    }[what]


@pytest.mark.parametrize("what", ["fim_with_maml", "unknown_algo", "unknown_optimizer",
                                  "no_outer_loss_for_reptile", "table_off_the_ladder"])
def test_errors_that_acn_tpu_raises_too(what):
    port, ref, exc, msg = _error_case(what)
    for call in (port, ref):
        with pytest.raises(exc, match=msg):
            call()


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


@pytest.mark.parametrize("regime", ["stratified", "strided", "budget"])
def test_generator_draws_are_seeded_and_refused_elsewhere(regime):
    """A generator's draws repeat with its seed and differ from no draws
    (bin midpoints, phase 0, no jitter); a generator on another device than
    the step's, and draws of another kind, are refused."""
    sc, P, _, tocc_cfg, _, tocc, report = regime_setup(regime, inner_iter=1)
    batch = _tt(toy.training_batch(K, T, S, Q))
    outs = []
    for draws in (torch.Generator().manual_seed(4), torch.Generator().manual_seed(4),
                  None):
        topt, state = toy.init_train_state(fresh_model(sc), P)
        step = tts.make_meta_train_step(sc.tcfg, P, topt, tocc_cfg,
                                        report_budget=report, device="cpu")
        _, m = step(state, batch, tocc, draws=draws)
        outs.append(float(m["loss_total"]))
    assert outs[0] == outs[1] and outs[0] != outs[2]
    with pytest.raises(TypeError, match="Generator"):
        step(state, batch, tocc, draws=np.zeros((K, T, 2), np.int64))
    with pytest.raises(ValueError, match="generator"):
        tts.EpisodeDraws(torch.Generator(), torch.device("cuda"), regime, P)


# ----------------------------------------------------------------- eval step


@pytest.mark.parametrize("regime,tto", [("stratified", None), ("strided", None),
                                        ("budget", None), ("strided", 0)])
def test_eval_step_matches(regime, tto):
    """Adapt with ``tto`` inner steps (the config's 2 when None), then the
    query loss, against acn_tpu's eval step with its own draws replayed."""
    sc, P, jocc_cfg, tocc_cfg, jocc, tocc, _ = regime_setup(regime)
    jeval = jax.jit(jts.make_eval_step(sc.jcfg, P, jocc_cfg, tto=tto))
    batch = toy.training_batch(K, T, S, Q, seed=8)
    key = jax.random.PRNGKey(30)
    want = jax.device_get(jeval(jax.tree.map(jnp.asarray, sc.jvars),
                                {k: jnp.asarray(v) for k, v in batch.items()}, jocc, key))
    model = fresh_model(sc)
    before = _flat(convert.to_jax_variables(model)["params"])
    teval = tts.make_eval_step(sc.tcfg, P, tocc_cfg, tto=tto, device="cpu")
    iters = P.inner_iter if tto is None else tto
    got = teval(model, _tt(batch), tocc, draws=jax_draws(key, "eval", iters))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(_np(got[name]), want[name], rtol=1e-5, err_msg=name)
    after = _flat(convert.to_jax_variables(model)["params"])
    assert all(np.array_equal(before[n], after[n]) for n in before)  # untouched


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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("regime", REGIMES)
def test_episode_gradient_on_card_matches_plain_by_regime(regime):
    """The stratified and strided episode losses on the card (no scan: they
    launch no kernel of the port) against the CPU, float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step runs on the card")
    from acn_tpu_torch.ops import segscan
    sc, P, _, tocc_cfg, _, tocc, report = regime_setup(regime)
    b = toy.training_batch(K, T, S, Q, seed=4)
    rays, rgbs = b["support_rays"][0, 0], b["support_rgbs"][0, 0]
    gen = torch.Generator().manual_seed(5)
    rand = (None if regime == "stratified"
            else tgrid_draws(rays.shape[0], P.occ_s_max, gen))
    u = (torch.rand((rays.shape[0], P.ray_samples), generator=gen)
         if regime == "stratified" else None)
    before = (segscan.seg_excl_sum_kernel.launches,
              segscan.seg_excl_rsum_kernel.launches)
    out = {}
    for dev in ("cuda", "cpu"):
        model = fresh_model(sc).to(dev)
        loss_fn, prep = tts.make_episode_loss(sc.tcfg, P, tocc_cfg, report_budget=report)
        params = model.params()
        tp = tree_map(lambda a: a.detach().clone().requires_grad_(True),
                      tcont.expert_slice(params["experts"], 0))
        occ = {n: v[0].to(dev) for n, v in tocc.items()} if tocc_cfg else None
        r = torch.from_numpy(rays).to(dev)
        smp = prep(occ, r, None if rand is None else tuple(x.to(dev) for x in rand))
        loss = loss_fn(tp, params["bg_mlp"], model.expert_aabbs[0], r,
                       torch.from_numpy(rgbs).to(dev), smp,
                       u=None if u is None else u.to(dev))
        out[dev] = (loss, torch.autograd.grad(loss, tree_leaves(tp)))
    assert (segscan.seg_excl_sum_kernel.launches,
            segscan.seg_excl_rsum_kernel.launches) == before
    (got, ggrads), (want, wgrads) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(float(got.detach()), float(want.detach()), rtol=1e-4)
    for g, w in zip(ggrads, wgrads):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-3, atol=1e-7)


def tgrid_draws(n, s_max, gen):
    from acn_tpu_torch.occupancy import grid as tgrid
    return tgrid.draw_march(n, s_max, gen)
