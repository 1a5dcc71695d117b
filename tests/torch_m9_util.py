"""Shared set-up of the M9 parity tests (test_torch_maml.py,
test_torch_reptile_fim.py, test_torch_chunked_loss.py,
test_torch_vanilla_corner.py): a micro scene in both packages, the regimes,
acn_tpu's draws replayed for every algorithm's key layout, and the
meta-gradients of both packages from one converted state.

Micro shapes: K 2 experts, T 2 tasks, S 16 support and Q 8 query rays, 2
inner steps, a 2-level hash grid (resolutions 4 and 16, the first dense) and
MLPs of width 8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.models.encodings import HashGridConfig as JHash
from acn_tpu.models.ngp import NGPConfig as JNGP
from acn_tpu.pipelines.offline_stage import train_step as jts
from acn_tpu_torch import convert, toy
from acn_tpu_torch.pipelines.offline_stage import train_step as tts
from acn_tpu_torch.pipelines.offline_stage import trainer as ttrainer
from test_torch_models import small_scene
from test_torch_train_step import _flat, _np, _tt, jax_draws, make_P

K, T, S, Q = 2, 2, 16, 8
MICRO_HASH = dict(levels=2, min_res=4, max_res=16, log2_hashmap_size=8,
                  features_per_level=2, layout="cell", dense_levels=True)
EXPERT = JNGP(hidden=8, color_hidden=8, color_depth=2, hash=JHash(**MICRO_HASH))
REGIMES = ("budget", "strided", "stratified")
CPU = torch.device("cpu")


@pytest.fixture
def one_thread():
    """One torch thread for the test: micro shapes gain nothing from more,
    and in a run of several workers each small op's threads would wait on
    the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def scene(regime, expert=EXPERT, nerf_variant="instant", bg_encoding="spherical"):
    """The micro scene; the stratified regime's σ-head bias is −0.5 (the
    reason is in ``test_torch_train_step.regime_setup``), the others' +2."""
    return small_scene(K=K, sigma_bias=-0.5 if regime == "stratified" else 2.0,
                       fill=0.6, seed=1, expert=expert, nerf_variant=nerf_variant,
                       bg_encoding=bg_encoding)


def setup(regime, sc=None, **P_over):
    """(scene, P, JAX occ_cfg, port occ_cfg, JAX occ states, port occ
    states, report_budget) of a regime, as ``test_torch_train_step``'s."""
    sc = sc or scene(regime)
    if regime == "budget":
        return sc, make_P(**P_over), sc.jocc_cfg, sc.tocc_cfg, sc.jocc, sc.tocc, 0
    if regime == "strided":
        return (sc, make_P(occ_budget_per_ray=0, **P_over), sc.jocc_cfg, sc.tocc_cfg,
                sc.jocc, sc.tocc, 6)
    return (sc, make_P(**P_over), None, None, jnp.zeros((K,), jnp.float32),
            ttrainer.dummy_occ_states(K), 0)


def draws(key, layout="gradbased", chunk=0, iterations=2):
    """acn_tpu's draws from ``key`` as ``EpisodeDraws`` asks for them.
    ``layout``: "gradbased" (FoMAML, MAML, FIM: ``k, k_ms, k_mq = split(k,
    3)``, then ``k_in, k_q = split(k)``) or "reptile" (and the eval step:
    ``k_in, k_q, k_ms, k_mq = split(k, 4)``). With ``chunk``, the chunked
    loss's per-chunk draws too: chunk c of loss i takes
    ``split(k_render, n_chunks)[c]``, as the jittered stratified render or
    the strided march's (jitter, phase) keys."""
    base = jax_draws(key, "train" if layout == "gradbased" else "eval", iterations)
    keys = jax.random.split(key, K * T).reshape(K, T, -1)

    def fn(what, k, t, j, shape):
        if not what.startswith("chunk_"):
            return base(what, k, t, j, shape)
        i, c = j
        if layout == "gradbased":
            kk = jax.random.split(keys[k, t], 3)[0]
            k_in, k_q = jax.random.split(kk)
        else:
            k_in, k_q = jax.random.split(keys[k, t], 4)[:2]
        loss_key = jax.random.split(k_in, iterations)[i] if i < iterations else k_q
        n = S if i < iterations else Q
        ck = jax.random.split(jax.random.split(loss_key)[0], -(-n // chunk))[c]
        if what == "chunk_strat_u":
            return np.array(jax.random.uniform(ck, shape, dtype=jnp.float32))
        k_jit, k_phase = jax.random.split(ck)
        if what == "chunk_u":
            return np.array(jax.random.uniform(k_jit, shape, dtype=jnp.float32))
        return np.array(jax.random.randint(k_phase, shape, 0, 1 << 30), np.int64)

    return fn


def batch(seed=3):
    return toy.training_batch(K, T, S, Q, seed=seed)


def jax_meta_grads(algo, regime, sc=None, seed=3, **P_over):
    """acn_tpu's ``_meta_grads_gradbased`` alone, on ``meta_grads``'s batch
    and key: (q_losses, inner_losses, expert grads, bg grad, overflow)."""
    sc, P, jocc_cfg, _, jocc, _, report = setup(regime, sc, algo=algo, **P_over)
    fim_cfg = jts._fim_cfg_from(P)
    jl, jp = jts.make_episode_loss(sc.jcfg, P, jocc_cfg, report_budget=report)
    f = jax.jit(lambda params, bb, o, k: jts._meta_grads_gradbased(
        jl, jp, algo, params, sc.jvars["buffers"], o, bb, k, P.inner_lr, P.inner_iter,
        fim_cfg=fim_cfg))
    return jax.device_get(f(jax.tree.map(jnp.asarray, sc.jvars["params"]),
                            {k: jnp.asarray(v) for k, v in batch(seed).items()}, jocc,
                            jax.random.PRNGKey(10)))


def meta_grads(algo, regime, sc=None, seed=3, **P_over):
    """``_meta_grads_gradbased`` of both packages on one batch and key, from
    one converted state: (JAX (q_losses, inner_losses, expert grads, bg
    grad, overflow), the port's, P)."""
    sc, P, _, tocc_cfg, _, tocc, report = setup(regime, sc, algo=algo, **P_over)
    b = batch(seed)
    key = jax.random.PRNGKey(10)
    fim_cfg = jts._fim_cfg_from(P)
    jout = jax_meta_grads(algo, regime, sc, seed, **P_over)
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    tl, tp = tts.make_episode_loss(sc.tcfg, P, tocc_cfg, report_budget=report)
    rnd = tts.EpisodeDraws(draws(key, chunk=int(P.train_chunk_rays)), CPU,
                           tts.regime_of(tocc_cfg, P), P, sc.tcfg)
    tout = tts._meta_grads_gradbased(algo, tl, tp, model.params(), model.expert_aabbs,
                                     tocc, _tt(b), rnd, P.inner_lr, P.inner_iter, fim_cfg)
    return jout, tout, P


def port_meta_grads(algo, regime, sc=None, seed=3, key=10, **P_over):
    """The port's ``_meta_grads_gradbased`` alone, as ``meta_grads`` runs
    it."""
    sc, P, _, tocc_cfg, _, tocc, report = setup(regime, sc, algo=algo, **P_over)
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    tl, tp = tts.make_episode_loss(sc.tcfg, P, tocc_cfg, report_budget=report)
    rnd = tts.EpisodeDraws(draws(jax.random.PRNGKey(key), chunk=int(P.train_chunk_rays)),
                           CPU, tts.regime_of(tocc_cfg, P), P, sc.tcfg)
    return tts._meta_grads_gradbased(algo, tl, tp, model.params(), model.expert_aabbs,
                                     tocc, _tt(batch(seed)), rnd, P.inner_lr,
                                     P.inner_iter, jts._fim_cfg_from(P))


def grads_flat(g_experts, g_bg):
    tree = {"experts": g_experts}
    if g_bg is not None:
        tree["bg_mlp"] = g_bg
    return _flat(jax.tree.map(np.asarray, tree) if not _is_port(g_experts)
                 else convert._numpy(tree))


def _is_port(tree):
    return isinstance(jax.tree.leaves(tree)[0], torch.Tensor)


def check_meta_grads(jout, tout, grad_atol=2e-5, grad_rtol=1e-4):
    """Losses rtol 1e-5 / atol 1e-7 and the overflow; each gradient leaf
    within ``grad_atol`` of its own largest entry (plus ``grad_rtol``): the
    two frameworks sum MLP products and the table's scatter-add in other
    orders."""
    for a, b in ((jout[0], tout[0]), (jout[1], tout[1]), (jout[4], tout[4])):
        np.testing.assert_allclose(_np(b) if isinstance(b, torch.Tensor) else np.asarray(b),
                                   np.asarray(a), rtol=1e-5, atol=1e-7)
    want, got = grads_flat(jout[2], jout[3]), grads_flat(tout[2], tout[3])
    assert want.keys() == got.keys()
    for name in want:
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(got[name], want[name], rtol=grad_rtol,
                                   atol=grad_atol * scale + 1e-30, err_msg=name)
    assert all(np.isfinite(v).all() for v in got.values())
    return want, got
