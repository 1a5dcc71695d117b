"""The port's FoMAML training step in its three regimes, and its eval step
(acn_tpu_torch.pipelines.offline_stage, utils.optim, nerfs.color / losses),
against acn_tpu's: here two whole steps of both packages; the episode loss,
colour and losses, the optimizer, the regime rule, the errors, the draws,
the eval step and the card's episode in tests/test_torch_train_step_parts.py
(split so that the test run spreads them over its workers).

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

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.models import container as jcont
from acn_tpu.pipelines.offline_stage import train_step as jts
from acn_tpu.utils import optim as joptim
from acn_tpu_torch import convert, toy
from acn_tpu_torch.models.nn import tree_map
from acn_tpu_torch.pipelines.offline_stage import train_step as tts
from acn_tpu_torch.pipelines.offline_stage import trainer as ttrainer
from acn_tpu_torch.utils import checkpoint as tck
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
