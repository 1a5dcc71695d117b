"""Reptile and the Fisher-preconditioned inner loop (``--algo reptile``,
``--fim``) in the port against acn_tpu: acn_tpu_torch.models.fim,
``meta_core.reptile_adapt`` / ``reptile_meta_delta`` and the Reptile and
``fim`` branches of the training and eval steps.

* Reptile: a whole step of both packages from one converted micro scene in
  the packed-budget regime, with JAX's draws replayed in
  its own key layout (``k_in, k_q, k_ms, k_mq = split(k, 4)``): metrics and
  every parameter; the background head, the optimizer state and its count
  do not move, and ``grad_norm`` is 0.
* FIM: the Fisher functions on random trees, the inner loop on a
  quadratic, the FoMAML meta-gradient with the Fisher inner loop in the
  budget regime, and the eval step with ``--fim``.

The meta-gradient runs at ``fim_epsilon`` 1e-2: at acn_tpu's default 1e-6
the micro scene's first inner step is g·λ/ε ≈ 10⁵·g, and both packages
diverge to NaN alike.

Tolerances: losses and metrics rtol 1e-5; parameters after a Reptile step
rtol 1e-6 / atol 1e-9 (the step moves them by P.lr·mean(fast − θ), summed
in the same order); gradients as ``torch_m9_util.check_meta_grads``; the
Fisher functions rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.models import container as jcont
from acn_tpu.models import fim as jfim
from acn_tpu.pipelines.offline_stage import meta_core as jmeta
from acn_tpu.pipelines.offline_stage import train_step as jts
from acn_tpu.utils import optim as joptim
from acn_tpu_torch import convert, toy
from acn_tpu_torch.models import fim as tfim
from acn_tpu_torch.models.nn import tree_leaves, tree_map
from acn_tpu_torch.pipelines.offline_stage import meta_core as tmeta
from acn_tpu_torch.pipelines.offline_stage import train_step as tts
from test_torch_train_step import _flat, _leaves, _np, _tt
from torch_m9_util import (K, batch, check_meta_grads, draws, meta_grads,
                           port_meta_grads, setup)
from torch_m9_util import one_thread  # noqa: F401  (pytestmark uses it)

pytestmark = pytest.mark.usefixtures("one_thread")


def _tree(rng, scale=1.0):
    return {"a": (scale * rng.normal(size=(3, 4))).astype(np.float32),
            "b": [(scale * rng.normal(size=5)).astype(np.float32)]}


# ------------------------------------------------------------------- Reptile


@pytest.mark.parametrize("regime", ["budget"])
def test_reptile_step_matches_jax(regime):
    sc, P, jocc_cfg, tocc_cfg, jocc, tocc, _ = setup(regime, algo="reptile", lr=0.5)
    jopt = joptim.build_optimizer(P, jcont.param_group_labels(sc.jvars, sc.jcfg),
                                  grad_clip=P.grad_clip)
    jstep = jax.jit(jts.make_meta_train_step(sc.jcfg, P, jopt, jocc_cfg))
    jvars = jax.tree.map(jnp.asarray, sc.jvars)
    jstate = {"variables": jvars, "opt_state": jopt.init(jvars["params"]),
              "step": jnp.zeros((), jnp.int32)}
    b, key = batch(), jax.random.PRNGKey(10)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, jocc, key)
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    topt, tstate = toy.init_train_state(model, P)
    opt0 = tree_map(lambda t: t.clone(), tstate["opt_state"])
    tstep = tts.make_meta_train_step(sc.tcfg, P, topt, tocc_cfg, device="cpu")
    tstate, tm = tstep(tstate, _tt(b), tocc, draws=draws(key, layout="reptile"))
    jm = jax.device_get(jm)
    assert set(tm) == set(jm)
    for name in jm:
        np.testing.assert_allclose(_np(tm[name]), jm[name], rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    assert float(tm["grad_norm"]) == 0.0
    if regime == "budget":
        assert 0.0 < float(tm["occ_overflow"]) < 1.0
    start = _flat(sc.jvars["params"])
    want = _flat(jax.device_get(jstate["variables"]["params"]))
    got = _flat(convert.to_jax_variables(model)["params"])
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    experts = [n for n in got if "bg_mlp" not in n]
    assert sum(np.any(got[n] != start[n]) for n in experts) >= len(experts) - 1
    assert all(np.array_equal(got[n], start[n]) for n in got if "bg_mlp" in n)
    # the optimizer's state and count are as they were
    assert tstate["step"] == 1
    for a, c in zip(tree_leaves(tstate["opt_state"]), tree_leaves(opt0)):
        assert torch.equal(a, c)


def test_reptile_step_is_lr_times_the_mean_adaptation():
    """θ ← θ + P.lr · mean_t(fast_t − θ), recomputed from the port's own
    ``reptile_adapt`` on each task."""
    sc, P, _, tocc_cfg, _, tocc, _ = setup("budget", algo="reptile", lr=0.5)
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    start = tree_map(lambda p: p.detach().clone(), model.params()["experts"])
    b, key = _tt(batch()), jax.random.PRNGKey(3)
    tl, tp = tts.make_episode_loss(sc.tcfg, P, tocc_cfg)
    rnd = tts.EpisodeDraws(draws(key, layout="reptile"), torch.device("cpu"), "budget",
                           P, sc.tcfg)
    fasts = []
    bg = tree_map(lambda p: p.detach(), model.params()["bg_mlp"])
    for k in range(K):
        occ = {n: v[k] for n, v in tocc.items()}
        per = []
        for t in range(b["support_rays"].shape[1]):
            smp = tp(occ, b["support_rays"][k, t], rnd.march(k, t, 0, 16))
            fast, _ = tmeta.reptile_adapt(
                lambda p, bb, i: tl(p, bg, model.expert_aabbs[k], bb[0], bb[1], smp),
                tree_map(lambda a: a[k], start), (b["support_rays"][k, t],
                                                  b["support_rgbs"][k, t]),
                P.inner_lr, P.inner_iter)
            per.append(fast)
        fasts.append(tree_map(lambda *f: torch.stack([x.detach() for x in f]), *per))
    topt, tstate = toy.init_train_state(model, P)
    step = tts.make_meta_train_step(sc.tcfg, P, topt, tocc_cfg, device="cpu")
    step(tstate, b, tocc, draws=draws(key, layout="reptile"))
    for k in range(K):
        theta = tree_map(lambda a: a[k], start)
        delta = tmeta.reptile_meta_delta(theta, fasts[k])
        want = tree_map(lambda w, d: w + P.lr * d, theta, delta)
        got = tree_map(lambda a: a[k], model.params()["experts"])
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            torch.testing.assert_close(g.detach(), w, rtol=1e-6, atol=1e-9)


def test_reptile_meta_delta_matches_jax_and_zeroes_non_finite():
    rng = np.random.default_rng(0)
    theta = _tree(rng)
    fast = {"a": rng.normal(size=(3, 3, 4)).astype(np.float32),
            "b": [rng.normal(size=(3, 5)).astype(np.float32)]}
    fast["a"][1, 0, 0] = np.nan
    fast["b"][0][2, 1] = np.inf
    want = jmeta.reptile_meta_delta(jax.tree.map(jnp.asarray, theta),
                                    jax.tree.map(jnp.asarray, fast))
    got = tmeta.reptile_meta_delta(_tt(theta), _tt(fast))
    for g, w in zip(_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)
    assert got["a"][0, 0] == 0.0 and got["b"][0][1] == 0.0


# ----------------------------------------------------------------------- FIM


def test_fisher_functions_match_jax():
    rng = np.random.default_rng(1)
    f, g = _tree(rng, 0.1), _tree(rng)
    f = jax.tree.map(np.abs, f)
    jf = jfim.fisher_update(jax.tree.map(jnp.asarray, f), jax.tree.map(jnp.asarray, g), 0.9)
    tf = tfim.fisher_update(_tt(f), _tt(g), 0.9)
    for a, b in zip(_leaves(tf), jax.tree.leaves(jf)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)
    js = jfim.fisher_scaled_grads(jf, jax.tree.map(jnp.asarray, g), 0.2, 1e-3)
    ts = tfim.fisher_scaled_grads(tf, _tt(g), 0.2, 1e-3)
    for a, b in zip(_leaves(ts), jax.tree.leaves(js)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)
    zero = tfim.fisher_init(_tt(g))
    assert all(float(z.abs().max()) == 0.0 for z in tree_leaves(zero))


def test_fim_task_adapt_matches_jax_on_a_quadratic():
    rng = np.random.default_rng(2)
    p0 = _tree(rng)
    tgt = _tree(rng)
    jl = lambda p, b, k: sum(jnp.sum((x - y) ** 2) for x, y in zip(
        jax.tree.leaves(p), jax.tree.leaves(b)))
    tl = lambda p, b, i: sum(torch.sum((x - y) ** 2) for x, y in zip(
        tree_leaves(p), tree_leaves(b)))
    jp = jax.tree.map(jnp.asarray, p0)
    jfast, jF, jloss = jfim.fim_task_adapt(jl, jp, jfim.fisher_init(jp),
                                           jax.tree.map(jnp.asarray, tgt),
                                           jax.random.PRNGKey(0), 0.05, 3, 0.9, 0.1, 1e-2)
    tp = _tt(p0)
    tfast, tF, tloss = tfim.fim_task_adapt(tl, tp, tfim.fisher_init(tp), _tt(tgt), 0.05, 3,
                                           0.9, 0.1, 1e-2)
    np.testing.assert_allclose(_np(tloss), np.asarray(jloss), rtol=1e-6)
    for a, b in zip(_leaves(tfast) + _leaves(tF), jax.tree.leaves(jfast) + jax.tree.leaves(jF)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-7)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), tree_leaves(_tt(p0))))


@pytest.mark.parametrize("regime", ["budget"])
def test_fim_meta_gradient_matches_jax(regime):
    jout, tout, P = meta_grads("fomaml", regime, fim=True, fim_epsilon=1e-2)
    check_meta_grads(jout, tout)
    plain = port_meta_grads("fomaml", regime)
    # the preconditioner changes the adaptation, so the query loss
    assert not torch.allclose(tout[0], plain[0], rtol=1e-4)


def test_fim_eval_step_matches_jax():
    sc, P, jocc_cfg, tocc_cfg, jocc, tocc, _ = setup("budget", fim=True, fim_epsilon=1e-2)
    key = jax.random.PRNGKey(4)
    b = batch(seed=5)
    jev = jax.jit(jts.make_eval_step(sc.jcfg, P, jocc_cfg, tto=2))
    want = jax.device_get(jev(jax.tree.map(jnp.asarray, sc.jvars),
                              {k: jnp.asarray(v) for k, v in b.items()}, jocc, key))
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    tev = tts.make_eval_step(sc.tcfg, P, tocc_cfg, tto=2, device="cpu")
    got = tev(model, _tt(b), tocc, draws=draws(key, layout="reptile"))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(_np(got[name]), want[name], rtol=1e-5, err_msg=name)
    plain = tts.make_eval_step(sc.tcfg, type(P)(**{**vars(P), "fim": False}), tocc_cfg,
                               tto=2, device="cpu")(model, _tt(b), tocc,
                                                     draws=draws(key, layout="reptile"))
    assert not torch.allclose(plain["loss_out"], got["loss_out"], rtol=1e-4)
