"""Second-order MAML in the port (acn_tpu_torch.pipelines.offline_stage:
``meta_core.maml_outer_loss``, the ``maml`` branch of the training step)
against acn_tpu's.

* meta_core on quadratics, where the answer is known: MAML's gradient is
  (1 − 2·lr)^n times FoMAML's (``tests/test_meta_pipeline.py:131-149``),
  and FoMAML's is the query gradient at the adapted weights;
* the meta-gradient of both packages (``_meta_grads_gradbased``, algo
  ``maml``) from one converted micro scene, in the packed-budget, strided
  and stratified regimes, with JAX's draws replayed, at an inner rate of
  0.3; in the budget regime the scan's backward is differentiated
  (``SegExclRSum``); JAX's FoMAML gradient fails the same tolerance (it is
  0.12–0.33 of a leaf's largest entry from MAML's);
* a whole MAML step of both packages at an inner rate of 0.3 (SGD, so that
  the update is the gradient), metrics and parameters;
* MAML's gradient is not FoMAML's on the same episode, and the hash
  encode's x path never runs in training.

Tolerances: losses rtol 1e-5; each gradient leaf within 2e-5 of its own
largest entry (rtol 1e-4): measured ≤ 2.5e-6 of it (the frameworks sum MLP
products and the table scatter in other orders). Quadratics: rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.models import container as jcont
from acn_tpu.pipelines.offline_stage import meta_core as jmeta
from acn_tpu.pipelines.offline_stage import train_step as jts
from acn_tpu.utils import optim as joptim
from acn_tpu_torch import convert, toy
from acn_tpu_torch.models import encodings as tenc
from acn_tpu_torch.pipelines.offline_stage import meta_core as tmeta
from acn_tpu_torch.pipelines.offline_stage import train_step as tts
from test_torch_train_step import _flat, _np, _tt
from torch_m9_util import (REGIMES, K, T, batch, check_meta_grads, draws,
                           grads_flat, jax_meta_grads, meta_grads, port_meta_grads,
                           setup)
from torch_m9_util import one_thread  # noqa: F401  (pytestmark uses it)

pytestmark = pytest.mark.usefixtures("one_thread")

# The inner rate of the parity tests: at make_P's 0.015 the second-order
# terms are about 1e-4 of the gradient, inside the tolerance, so a step that
# returned FoMAML's gradient would pass; at 0.3 they are not.
INNER_LR = 0.3


# ------------------------------------------------------------- quadratics


def _quadratic(pkg):
    """(support loss, query loss) of ``tests/test_meta_pipeline.py``'s
    quadratic, for the port or JAX."""
    if pkg == "jax":
        return (lambda p, b, k: jnp.sum(p**2),
                lambda p, b, k: jnp.sum((p - 1.0) ** 2))
    return (lambda p, b, i: torch.sum(p["w"] ** 2),
            lambda p, b, i: torch.sum((p["w"] - 1.0) ** 2))


def _port_grad(outer, lr=0.1, iters=2):
    p = {"w": torch.tensor([0.5], dtype=torch.float64, requires_grad=True)}
    s, q = _quadratic("port")
    loss, inner = outer(s, q, p, None, None, lr, iters)
    (g,) = torch.autograd.grad(loss, [p["w"]])
    return g.numpy(), loss.detach().numpy(), inner.numpy()


def test_maml_is_0_64_of_fomaml_on_the_quadratic():
    """fast = (1 − 2·lr)² p0, so d fast / dp = 0.64 at lr 0.1 and 2 steps."""
    g_maml, l_maml, in_maml = _port_grad(tmeta.maml_outer_loss)
    g_fo, l_fo, in_fo = _port_grad(tmeta.fomaml_outer_loss)
    np.testing.assert_allclose(g_maml, 0.64 * g_fo, rtol=1e-12)
    np.testing.assert_allclose(l_maml, l_fo, rtol=1e-12)
    np.testing.assert_allclose(in_maml, in_fo, rtol=1e-12)
    s, q = _quadratic("jax")
    for outer, got in ((jmeta.maml_outer_loss, g_maml), (jmeta.fomaml_outer_loss, g_fo)):
        want = jax.grad(lambda p: outer(s, q, p, None, None, jax.random.PRNGKey(0),
                                        0.1, 2)[0])(jnp.array([0.5]))
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)


def test_fomaml_outer_gradient_is_the_query_gradient_at_the_fast_weights():
    s = lambda p, b, i: torch.sum((p["w"] - 2.0) ** 2)
    q = lambda p, b, i: torch.sum((p["w"] - 3.0) ** 2)
    p = {"w": torch.zeros(1, dtype=torch.float64, requires_grad=True)}
    loss, _ = tmeta.fomaml_outer_loss(s, q, p, None, None, 0.1, 3)
    (g,) = torch.autograd.grad(loss, [p["w"]])
    fast, _ = tmeta.task_adapt(s, p, None, 0.1, 3, first_order=True)
    (g_fast,) = torch.autograd.grad(q(fast, None, 3), [fast["w"]])
    np.testing.assert_allclose(g.numpy(), g_fast.numpy(), rtol=1e-12)
    assert float(fast["w"].detach()) == pytest.approx(2.0 * (1 - 0.8**3))


def test_second_order_task_adapt_starts_from_the_parameters_themselves():
    p = {"w": torch.tensor([0.5, -1.0], dtype=torch.float64, requires_grad=True)}
    s, _ = _quadratic("port")
    fast, inner = tmeta.task_adapt(s, p, None, 0.1, 2, first_order=False)
    assert fast["w"].grad_fn is not None  # a function of p, not a copy
    (d,) = torch.autograd.grad(fast["w"].sum(), [p["w"]])
    np.testing.assert_allclose(d.numpy(), 0.64, rtol=1e-12)
    assert inner.shape == (2,) and not inner.requires_grad
    assert torch.equal(p["w"].detach(), torch.tensor([0.5, -1.0], dtype=torch.float64))


# ------------------------------------------------- the meta-gradient, by regime


@pytest.mark.parametrize("regime", REGIMES)
def test_maml_meta_gradient_matches_jax(regime):
    """At an inner rate of 0.3, where the second-order terms are large, and
    with the tolerance shown to see them: JAX's own FoMAML gradient on the
    same episode fails it against JAX's MAML gradient (the losses agree, so
    a gradient fails)."""
    jout, tout, _ = meta_grads("maml", regime, inner_lr=INNER_LR)
    check_meta_grads(jout, tout)
    if regime != "stratified":
        assert 0.0 < float(tout[4]) < 1.0  # the (would-be) drop is exercised
    with pytest.raises(AssertionError, match="Not equal to tolerance"):
        check_meta_grads(jout, jax_meta_grads("fomaml", regime, inner_lr=INNER_LR))


def test_maml_gradient_is_not_fomaml_gradient():
    """The second-order terms: on the same episode and draws, MAML's
    meta-gradient differs from FoMAML's in every group (the background
    head's too: MAML's support loss differentiates it). An inner rate of
    0.3 makes the terms large against float32 rounding (at 0.015 they are
    1e-4 of the gradient)."""
    out = {algo: grads_flat(*port_meta_grads(algo, "budget", inner_lr=INNER_LR)[2:4])
           for algo in ("maml", "fomaml")}
    for group in ("hash_table", "sigma_trunk", "color_mlp", "bg_mlp"):
        names = [n for n in out["maml"] if group in n]
        a = np.concatenate([out["maml"][n].ravel() for n in names])
        b = np.concatenate([out["fomaml"][n].ravel() for n in names])
        assert np.linalg.norm(a - b) > 1e-3 * np.linalg.norm(b), group


# -------------------------------------------------------------- the whole step


def test_maml_step_matches_jax():
    """One budget-regime MAML step of both packages under SGD (no clip),
    whose update is −lr·g: the seven metrics and every parameter."""
    sc, P, jocc_cfg, tocc_cfg, jocc, tocc, _ = setup("budget", algo="maml",
                                                      inner_lr=INNER_LR,
                                                      optimizer="sgd", grad_clip=None)
    jopt = joptim.build_optimizer(P, jcont.param_group_labels(sc.jvars, sc.jcfg),
                                  grad_clip=None)
    jstep = jax.jit(jts.make_meta_train_step(sc.jcfg, P, jopt, jocc_cfg))
    jvars = jax.tree.map(jnp.asarray, sc.jvars)
    jstate = {"variables": jvars, "opt_state": jopt.init(jvars["params"]),
              "step": jnp.zeros((), jnp.int32)}
    b = batch()
    key = jax.random.PRNGKey(10)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, jocc, key)
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    topt, tstate = toy.init_train_state(model, P)
    tstep = tts.make_meta_train_step(sc.tcfg, P, topt, tocc_cfg, device="cpu")
    tstate, tm = tstep(tstate, _tt(b), tocc, draws=draws(key))
    jm = jax.device_get(jm)
    assert set(tm) == set(jm)
    for name in jm:
        np.testing.assert_allclose(_np(tm[name]), jm[name], rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    assert int(tstate["opt_state"]["count"]) == 1 and tstate["step"] == 1
    start = _flat(sc.jvars["params"])
    want = _flat(jax.device_get(jstate["variables"]["params"]))
    got = _flat(convert.to_jax_variables(model)["params"])
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    assert sum(np.any(got[n] != start[n]) for n in got) >= len(got) - 1


def test_the_hash_encodes_x_path_never_runs_in_training(monkeypatch):
    """The table cotangent is all that training asks of the cell encode's
    backward, first and second order: x01 never needs a gradient."""
    seen = []
    backward = tenc._HashEncodeCellSaved.backward

    def spy(ctx, g):
        seen.append((ctx.needs_input_grad[0], torch.is_grad_enabled()))
        return backward(ctx, g)

    monkeypatch.setattr(tenc._HashEncodeCellSaved, "backward", staticmethod(spy))
    sc, P, _, tocc_cfg, _, tocc, _ = setup("budget", algo="maml")
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    topt, tstate = toy.init_train_state(model, P)
    tstep = tts.make_meta_train_step(sc.tcfg, P, topt, tocc_cfg, device="cpu")
    tstep(tstate, _tt(batch()), tocc, draws=draws(jax.random.PRNGKey(1)))
    assert seen and not any(need_x for need_x, _ in seen)
    assert any(graph for _, graph in seen)  # the inner backwards build a graph
    # per episode: each inner step's backward (building a graph), and the
    # outer backward through the query and each inner step's forward
    assert len(seen) == K * T * (2 * P.inner_iter + 1)
