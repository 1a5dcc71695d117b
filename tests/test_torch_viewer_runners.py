"""The viewer's training runners (acn_tpu_torch.viewer.engine.runners)
against acn_tpu's, on the micro run of ``test_torch_viewer_util``.

* ``RuntimeAdaptRunner``: 3 steps of each package on the same continual
  batch, JAX's render draws replayed (its key split once per step), each
  step from the same state (after a step the port takes JAX's weights and
  Adam state: over several steps Adam turns a near-zero gradient's rounding
  into most of its update, 1.7e-5 apart after 3 steps): the rays are the
  same (numpy's ``default_rng(P.seed)`` in both); losses rtol 1e-5; each
  step's gradient, from the first moments, entry by entry atol 1e-8 / rtol
  1e-4; the parameters atol 1e-6 / rtol 1e-4 where that gradient is at least
  1e-6 (entries of all four parameter groups among them), as
  ``test_torch_eval.py::test_tto_step_matches_jax`` holds one TTO step.
  Then a change of learning rate drops the optimizer in both, so the next
  step starts Adam's count and moments afresh (the rates stay P's).
* The continual batches are found oldest first, the same list in both.
* ``MetaTrainRunner``: 2 float32 steps of each package from one train
  context, JAX's draws replayed (its key split once per step; the step is
  built without the occupancy config in both, so it is stratified), held as
  the runtime-adapt steps (losses and PSNR rtol 1e-5); without a
  ``train_sampler`` both raise ``ValueError``.
* The published snapshot is not what the optimizer writes: a snapshot
  leased before a step is unchanged after it, and the next lease gives the
  stepped weights.
"""


import jax
import numpy as np
import pytest
import torch

from acn_tpu.viewer.engine.runners.meta_train import MetaTrainRunner as JMeta
from acn_tpu.viewer.engine.runners.runtime_adapt import RuntimeAdaptRunner as JAdapt
from acn_tpu_torch import convert
from acn_tpu_torch.models import container as tcont
from acn_tpu_torch.models.nn import tree_map
from acn_tpu_torch.viewer.engine.runners.meta_train import MetaTrainRunner as TMeta
from acn_tpu_torch.viewer.engine.runners.runtime_adapt import RuntimeAdaptRunner as TAdapt
from test_torch_train_step import optax_to_port
from test_torch_viewer_util import (  # noqa: F401 (fixtures)
    assert_state_equal,
    contexts,
    isolated,
    jax_params,
    runner_draws,
    state_clone,
    viewer_run,
)

STEPS = 3


def _step_both(jr, tr, jopt, topt, opt):
    """One step of each runner from the same state, held as
    ``test_tto_step_matches_jax`` holds one TTO step: the step's gradient
    g = (mu − 0.9·mu_before) / 0.1 entry by entry atol 1e-8 / rtol 1e-4, and
    the parameters atol 1e-6 / rtol 1e-4 where JAX's |g| ≥ 1e-6 (entries of
    every parameter group among them). Then the port's runner takes JAX's
    weights and optimizer state, so that the next step starts from the same
    state again. Returns both steps' metrics."""
    mu0 = optax_to_port(jopt(jr), opt(tr))["mu"] if jopt(jr) is not None else None
    want, got = jr.step(), tr.step()
    jstate = optax_to_port(jopt(jr), opt(tr))
    assert int(topt(tr)["count"]) == int(jstate["count"])
    held = []

    def check(p, jp, mu, jmu, before, group):
        g = (mu - (0.0 if before is None else 0.9 * before)).numpy() / 0.1
        jg = (jmu - (0.0 if before is None else 0.9 * before)).numpy() / 0.1
        np.testing.assert_allclose(g, jg, atol=1e-8, rtol=1e-4)
        big = np.abs(jg) >= 1e-6
        np.testing.assert_allclose(p.detach().numpy()[big], np.asarray(jp)[big],
                                   atol=1e-6, rtol=1e-4)
        held.append((group, int(big.sum())))

    params = tr.model.params()
    before = mu0 if mu0 is not None else tree_map(lambda _: None, params)
    tree_map(check, params, jax_params(jr), topt(tr)["mu"], jstate["mu"], before,
             tcont.param_group_labels(params))
    assert {g for g, n in held if n} == {"encoding", "sigma", "color", "background"}
    tr.model.load_state_dict(convert.from_jax_variables(
        jax.device_get(jr.variables), tr.cfg, "cpu").state_dict())
    return want, got, jstate


def test_runtime_adapt_steps_match_jax(viewer_run):
    jctx, tctx = contexts(viewer_run)
    assert tctx["occ_states"] is not None and int(tctx["P"].occ_budget_per_ray) > 0
    jr = JAdapt(jctx)
    tr = TAdapt(tctx, draws=runner_draws(tctx["P"]))
    assert [p.name for p in tr.batch_dirs] == [p.name for p in jr.batch_dirs] == ["b000"]
    for _ in range(STEPS):
        want, got, jstate = _step_both(jr, tr, lambda r: r._opt_state,
                                       lambda r: r._opt_state, lambda r: r._opt)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-5)
        assert got["step"] == want["step"]
        tr._opt_state = jstate
    assert int(tr._opt_state["count"]) == STEPS
    assert len(tr.support) == len(jr.support) > 0
    np.testing.assert_array_equal(tr.support.rays, jr.support.rays)
    # a change of learning rate drops the optimizer in both: the next step
    # is a fresh Adam's first (count 1), with its rates still from P
    for r in (jr, tr):
        r.update_lr("sigma", 0.5)
        assert r._tto is None and r.lrs["sigma"] == 0.5
    want, got = jr.step(), tr.step()
    assert int(optax_to_port(jr._opt_state, tr._opt)["count"]) == int(
        tr._opt_state["count"]) == 1
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert tr._opt.schedules["sigma"](0) == pytest.approx(float(tctx["P"].sigma_lr))
    # the context's model is the checkpoint's: the runner trained a copy
    assert not torch.equal(tr.model.params()["experts"]["sigma_head"]["b"],
                           tctx["model"].params()["experts"]["sigma_head"]["b"])


def test_batches_are_found_oldest_first(viewer_run, tmp_path):
    jctx, tctx = contexts(viewer_run)
    data = tmp_path / "ds"
    for name in ("b002", "b000", "b010", "b001"):
        (data / "continual" / name).mkdir(parents=True)
    (data / "continual" / "notes.txt").write_text("not a batch")
    for ctx in (jctx, tctx):
        ctx["data_path"] = data
    want = JAdapt(jctx).batch_dirs
    got = TAdapt(tctx).batch_dirs
    assert [p.name for p in got] == [p.name for p in want] == ["b000", "b001", "b002", "b010"]
    assert TAdapt(tctx, batch_dir=data / "x").batch_dirs == JAdapt(jctx, data / "x").batch_dirs
    tctx["data_path"] = tmp_path / "none"
    assert TAdapt(tctx).step() == {"status": 0.0}


def _meta_draws(P, K, T, iterations):
    """acn_tpu's meta-train step draws for step i of the runner's life: its
    ``PRNGKey(P.seed)`` split once per step; the stratified episode's
    jitter as ``test_torch_train_step.jax_draws`` derives it."""
    import jax.numpy as jnp

    def step_draws(i):
        key = jax.random.PRNGKey(int(P.seed))
        for _ in range(i + 1):
            key, k = jax.random.split(key)
        keys = jax.random.split(k, K * T).reshape(K, T, -1)

        def fn(what, kk_, t, j, shape):
            assert what == "strat_u", what
            kk, _, _ = jax.random.split(keys[kk_, t], 3)
            k_in, k_q = jax.random.split(kk)
            loss_key = jax.random.split(k_in, iterations)[j] if j < iterations else k_q
            return np.array(jax.random.uniform(jax.random.split(loss_key)[0], shape,
                                               dtype=jnp.float32))

        return fn

    return step_draws


def test_meta_train_steps_match_jax(viewer_run):
    jctx, tctx = contexts(viewer_run, op="train")
    for ctx in (jctx, tctx):  # float32: bf16 cell decisions are not held tight
        ctx["P"].use_amp = False
    P = tctx["P"]
    jr = JMeta(jctx)
    tr = TMeta(tctx, draws=_meta_draws(P, int(P.num_submodules), int(P.batch_size),
                                       int(P.inner_iter)))
    for _ in range(2):
        want, got, jstate = _step_both(jr, tr, lambda r: r._state["opt_state"],
                                       lambda r: r._state["opt_state"], lambda r: r.optimizer)
        for k in ("loss", "psnr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
        tr._state["opt_state"] = jstate
    assert tr.steps == jr.steps == 2 and int(tr._state["opt_state"]["count"]) == 2


def test_meta_train_needs_a_sampler_in_both(viewer_run):
    jctx, tctx = contexts(viewer_run)  # the view context builds none
    for cls, ctx in ((JMeta, jctx), (TMeta, tctx)):
        with pytest.raises(ValueError, match="train_sampler"):
            cls(ctx)


def test_a_leased_snapshot_is_not_what_the_step_writes(viewer_run):
    _, tctx = contexts(viewer_run)
    r = TAdapt(tctx)
    with r.get_render_params() as (model, occ):
        before = state_clone(model)
        assert occ is tctx["occ_states"]
        ours = {v.data_ptr() for v in model.state_dict().values()}
        assert not ours & {v.data_ptr() for v in r.model.state_dict().values()}
        r.step()
        assert r.steps == 1
        assert_state_equal(model, before)  # the step wrote neither it nor its copy
    with r.get_render_params() as (model2, _):
        assert model2 is not model
        assert_state_equal(model2, state_clone(r.model))
        assert any(not torch.equal(model2.state_dict()[k], v) for k, v in before.items())
