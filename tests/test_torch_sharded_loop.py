"""The training loop over a mesh (``meta_trainer(mesh=...)``) on two CPU
gloo ranks (2 experts × 1 data rank) against the single-rank loop of the
same seed, on ``test_torch_trainer``'s micro scene (K 2, T 2, 64 support
and 32 query rays, grids rebuilt every 2 steps after a 2-step warm-up).

The schedule: 7 steps, every one logged, stratified for 2 steps, then
strided with the would-be overflow measured until ``AutoRegime`` (patience
2, any reading under its threshold of 1) switches to the packed-budget
step; eval every 3 steps on one test task; a full save every 4. The loop
draws from ``LoopDraws``' one generator, which the step and the occupancy
update key by expert (and task), so each rank draws what the single rank
draws for its experts.

* Both loops run the same regimes and switch at the same step; the logged
  metrics and eval PSNRs within rtol 1e-5, and the ``last`` parameters
  within atol 1e-6 / rtol 1e-4 (the single-rank loop's tolerances against
  ``acn_tpu``); the grids' densities likewise.
* The sharded run writes the single-rank run's tags with the same keys and
  shapes, rank 0 alone; ``acn_tpu``'s loaders restore its ``last``
  (parameters, grids and optimizer state) to the port's values.
* Two ranks resume from the single-rank run's ``step4`` and reach the
  single-rank resume's ``last``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.models import container as jcont
from acn_tpu.utils import optim as joptim
from acn_tpu_torch import convert, toy
from acn_tpu_torch.data import tasks as ttasks
from acn_tpu_torch.parallel import dryrun, launch
from acn_tpu_torch.pipelines.offline_stage import trainer as ttrainer
from acn_tpu_torch.utils import checkpoint as tck
from acn_tpu_torch.utils import logging as tlogging
from test_torch_trainer import loop_P, samplers, scene

SCALAR_RTOL = 1e-5
PARAM = dict(atol=1e-6, rtol=1e-4)


def _P():
    return loop_P(occ_auto_thresh=1.0, outer_steps=7)


def _single(logs_root, start=None):
    """The single-rank loop, or its resume from (run, tag)."""
    sc = scene()
    P = _P()
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    opt, state = toy.init_train_state(model, P)
    kw = {}
    if start is not None:
        payload = tck.load_checkpoint(*start)
        model, occ = tck.restore_model(payload, sc.tcfg, "cpu")
        opt, state = toy.init_train_state(model, P)
        state["opt_state"] = tck.load_opt_state(*start, state["opt_state"], opt)
        state["step"] = payload["step"]
        kw = dict(occ_states=occ, start_step=payload["step"], best=payload["best"])
    _, ts = samplers(0)
    _, tt = samplers(1000)
    logger = tlogging.Logger("run", logs_root=logs_root)
    out = ttrainer.meta_trainer(P, sc.tcfg, state, opt, None, ttasks.MultiTaskSampler(tt),
                                logger, occ_cfg=sc.tocc_cfg,
                                device_pools=ttasks.build_device_pools(ts, max_pool=512,
                                                                       seed=0),
                                draws=ttrainer.LoopDraws(int(P.seed), "cpu"), device="cpu",
                                **kw)
    logger.close()
    return out["loop"], str(logger.logdir)


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_loop")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = _single(str(root / "single"))
        resumed = _single(str(root / "single_resume"), start=(single[1], "step4"))
        sc = scene()
        _, ts = samplers(0)
        _, tt = samplers(1000)
        common = dict(model=convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu"), P=_P(),
                      occ_cfg=sc.tocc_cfg, test_sampler=ttasks.MultiTaskSampler(tt),
                      pools=ttasks.build_device_pools(ts, max_pool=512, seed=0), mesh=(2, 1))
        ranks = launch.spawn("acn_tpu_torch.parallel.dryrun:cases_rank", 2, {"cases": [
            ("loop_rank", {**common, "logs_root": str(root / "sharded")}),
            ("loop_rank", {**common, "logs_root": str(root / "sharded_resume"),
                           "start": (single[1], "step4")})]}, root / "ranks", timeout_s=240)
    finally:
        torch.set_num_threads(n)
    return single, resumed, [r[0] for r in ranks], [r[1] for r in ranks]


def _scalars(metrics):
    return {k: np.asarray(v) for k, v in metrics.items()}


def test_sharded_loop_runs_the_single_ranks_schedule(loops):
    (single, _), _, sharded, _ = loops
    assert single["switched_at"] is not None
    for r in sharded:
        got = r["loop"]
        assert got["switched_at"] == single["switched_at"]
        assert [(s["step"], s["regime"]) for s in got["steps"]] == \
            [(s["step"], s["regime"]) for s in single["steps"]]
        assert {s["regime"] for s in got["steps"]} == {"stratified", "strided", "budget"}
        for a, b in zip(got["steps"], single["steps"]):
            for key, v in _scalars(b["metrics"]).items():
                np.testing.assert_allclose(a["metrics"][key], v, rtol=SCALAR_RTOL, atol=1e-7,
                                           err_msg=f"step {b['step']} {key}")
        np.testing.assert_allclose([p for _, p in got["eval_psnr"]],
                                   [p for _, p in single["eval_psnr"]], rtol=SCALAR_RTOL)
        assert r["count"] == 7
    assert sharded[0]["stats"]["host_collectives"] >= 7  # the stop flag, once a step


def _last(run, tag="last"):
    return tck.load_checkpoint(run, tag)


def _flat(tree):
    return dryrun._flat(tree)


def test_sharded_loop_writes_the_single_ranks_checkpoints(loops):
    (_, run1), _, sharded, _ = loops
    run2 = sharded[0]["logdir"]
    assert sharded[1]["logdir"] == run2
    tags = lambda d: sorted(p.name for p in Path(d).iterdir() if not p.name.startswith("events"))
    assert tags(run2) == tags(run1)
    log = (Path(run2) / "log.txt").read_text()
    assert log.count("step 7/7") == 1  # rank 0 alone logs
    a, b = _last(run2), _last(run1)
    assert a["step"] == b["step"] == 7
    fa, fb = _flat(a["variables"]), _flat(b["variables"])
    assert {k: v.shape for k, v in fa.items()} == {k: v.shape for k, v in fb.items()}
    for k in fb:
        np.testing.assert_allclose(fa[k], fb[k], err_msg=k, **PARAM)
    oa, ob = a["occ_states"], b["occ_states"]
    np.testing.assert_allclose(oa["occs"], ob["occs"], **PARAM)
    assert np.mean(oa["binaries"] != ob["binaries"]) < 0.01
    pa = tck._read(Path(run2) / "last.optim")
    pb = tck._read(Path(run1) / "last.optim")
    assert {k: v.shape for k, v in _flat(pa).items()} == \
        {k: v.shape for k, v in _flat(pb).items()}


def test_acn_tpu_restores_the_sharded_runs_last(loops):
    from acn_tpu.utils import checkpoint as jck

    _, _, sharded, _ = loops
    run = sharded[0]["logdir"]
    sc = scene()
    loaded = jck.load_checkpoint(run, "last")
    got = jck.restore_variables_like(sc.jvars, loaded["variables"])
    model, occ = tck.restore_model(tck.load_checkpoint(run, "last"), sc.tcfg, "cpu")
    want = convert.to_jax_variables(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    for k, v in loaded["occ_states"].items():
        np.testing.assert_array_equal(v, occ[k].numpy())
    P = _P()
    jopt = joptim.build_optimizer(P, jcont.param_group_labels(sc.jvars, sc.jcfg),
                                  grad_clip=P.grad_clip)
    template = jopt.init(jax.tree.map(jnp.asarray, sc.jvars["params"]))
    jstate = jax.device_get(jck.load_opt_state(run, "last", template))
    assert jax.tree.structure(jstate) == jax.tree.structure(template)
    topt, tstate = toy.init_train_state(model, P)
    tstate = tck.load_opt_state(run, "last", tstate["opt_state"], topt)
    assert int(tstate["count"]) == 7


def test_two_ranks_resume_a_single_rank_checkpoint(loops):
    _, (resumed, run1), _, sharded = loops
    for r in sharded:
        assert [s["step"] for s in r["loop"]["steps"]] == [5, 6, 7]
        assert [s["regime"] for s in r["loop"]["steps"]] == \
            [s["regime"] for s in resumed["steps"]]
    a, b = _last(sharded[0]["logdir"]), _last(run1)
    fa, fb = _flat(a["variables"]), _flat(b["variables"])
    for k in fb:
        np.testing.assert_allclose(fa[k], fb[k], err_msg=k, **PARAM)
