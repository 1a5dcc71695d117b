"""The sharded meta-train step (``make_meta_train_step(mesh=...)``) on CPU
gloo ranks, against acn_tpu's step jitted under its mesh and against the
port's own single-rank step.

A micro scene of K = 4 experts (3 hash levels, 16-wide MLPs) in both
packages from one JAX init; T = 3 tasks of 32 support and 16 query rays,
2 inner steps, the packed-budget regime over the scene's grids.

* ``acn_tpu``'s ``make_meta_train_step`` jitted with its state, grids and
  batch placed on ``make_mesh(4, 2, 2)`` over 4 of conftest's virtual CPU
  devices (the batch on the expert axis alone: JAX cannot split T = 3 over
  2), as ``__graft_entry__.py``'s dryrun does, against the port's FoMAML
  step over 4 gloo ranks (E 2 × D 2, so one data rank runs 1 task of each
  expert and the other 2), from converted weights, JAX's keys replayed
  through ``EpisodeDraws``' function form (recorded in this process and
  sent to the ranks): loss rtol 1e-5, parameters rtol 2e-5 / atol 2e-6
  (dryrun's tolerances), and the same against the single-rank port.
* Second-order MAML and Reptile over the same 4 ranks against the
  single-rank port, draws from a seeded generator (keyed by the global
  expert and task, so a rank draws what one rank draws for its episodes).
* A planted fault (the data group's all-reduce of the expert gradients
  skipped) fails the parameter tolerance.
* One rank of a gloo mesh (its all-reduces are copies) equals the plain
  step bit for bit, FoMAML with the clip and the guard, and Reptile.

The ranks are one ``launch.spawn`` group (``dryrun.cases_rank``); they
import neither JAX nor ``acn_tpu``.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as PS

from acn_tpu.models import container as jcont
from acn_tpu.parallel import mesh as jmesh
from acn_tpu.pipelines.offline_stage import train_step as jts
from acn_tpu.utils import optim as joptim
from acn_tpu_torch import convert, toy
from acn_tpu_torch.parallel import dryrun, launch
from acn_tpu_torch.parallel import mesh as tmesh
from test_torch_models import small_scene
from test_torch_train_step import MICRO_HASH, make_P

K, T, S, Q = 4, 3, 32, 16
E, D = 2, 2
LOSS_RTOL = dryrun.LOSS_RTOL
PARAM = dict(rtol=dryrun.PARAM_RTOL, atol=dryrun.PARAM_ATOL)


@functools.lru_cache(maxsize=None)
def scene():
    return small_scene(K=K, sigma_bias=2.0, fill=0.6, seed=1, hash_kw=MICRO_HASH)


def step_P(**over):
    return make_P(**{**dict(inner_iter=2, occ_budget_per_ray=6), **over})


def batch():
    return {k: torch.from_numpy(v) for k, v in toy.training_batch(K, T, S, Q, seed=3).items()}


def jax_draws(key, iterations=2):
    """acn_tpu's draws of a gradient-based step from ``key`` (the key
    layout of ``test_torch_train_step.jax_draws``, at K × T)."""
    keys = jax.random.split(key, K * T).reshape(K, T, -1)

    def fn(what, k, t, j, shape):
        kk, k_ms, k_mq = jax.random.split(keys[k, t], 3)
        k_in, k_q = jax.random.split(kk)
        if what == "salt":
            return int(jax.random.randint((k_ms, k_mq)[j], (), 0, jnp.iinfo(jnp.int32).max))
        if what in ("u", "phase"):
            k_jit, k_phase = jax.random.split((k_ms, k_mq)[j])
            if what == "u":
                return np.array(jax.random.uniform(k_jit, shape, dtype=jnp.float32))
            return np.array(jax.random.randint(k_phase, shape, 0, 1 << 30), np.int64)
        loss_key = jax.random.split(k_in, iterations)[j] if j < iterations else k_q
        return np.array(jax.random.uniform(jax.random.split(loss_key)[0], shape,
                                           dtype=jnp.float32))

    return fn


def jax_mesh_step(P, key):
    """acn_tpu's step under ``make_mesh(4, 2, 2)``: (metrics, parameters)."""
    sc = scene()
    mesh = jmesh.make_mesh(K, E, D, devices=jax.devices()[:E * D])
    assert mesh.devices.shape == (E, D)
    jopt = joptim.build_optimizer(P, jcont.param_group_labels(sc.jvars, sc.jcfg),
                                  grad_clip=P.grad_clip)
    step = jax.jit(jts.make_meta_train_step(sc.jcfg, P, jopt, sc.jocc_cfg))
    jv = jax.tree.map(jnp.asarray, sc.jvars)
    state = jmesh.shard_by_expert_axis(
        {"variables": jv, "opt_state": jopt.init(jv["params"]),
         "step": jnp.zeros((), jnp.int32)}, mesh, K)
    occ = jmesh.shard_by_expert_axis(sc.jocc, mesh, K)
    b = {k: jax.device_put(v.numpy(), NamedSharding(mesh, PS("expert")))
         for k, v in batch().items()}
    state, m = step(state, b, occ, key)
    return jax.device_get(m), jax.device_get(state["variables"]["params"])


def port_model():
    return convert.from_jax_variables(scene().jvars, scene().tcfg, "cpu")


def _flat(tree, prefix=""):
    return dryrun._flat(tree, prefix)


def _params_close(got, want, **tol):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


CASES = {  # name → (P overrides, draws: "jax" (recorded) or a generator seed)
    "fomaml": ({}, "jax"),
    "maml": ({"algo": "maml"}, 5),
    "reptile": ({"algo": "reptile", "lr": 1.0}, 6),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-rank port's step of each case (and JAX's draws recorded
    on the way), then every case over the 4 ranks in one group."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sc = scene()
        single, args = {}, []
        for name, (over, draws) in CASES.items():
            P = step_P(**over)
            if draws == "jax":
                rec = dryrun.RecordDraws(jax_draws(jax.random.PRNGKey(10)))
                m, p = dryrun.single_rank_step(sc.tcfg, port_model(), P, batch(), [rec],
                                               occ_cfg=sc.tocc_cfg, occ_states=sc.tocc)
                draws = rec.table
            else:
                m, p = dryrun.single_rank_step(sc.tcfg, port_model(), P, batch(), [draws],
                                               occ_cfg=sc.tocc_cfg, occ_states=sc.tocc)
            single[name] = (m, p, P)
            args.append(("step_rank", dict(model=port_model(), P=P, occ_cfg=sc.tocc_cfg,
                                           occ_states=sc.tocc, batch=batch(),
                                           draws=[draws], mesh=(E, D))))
        args.append(("step_rank", {**args[0][1], "fault": "skip_data_reduce"}))
        ranks = launch.spawn("acn_tpu_torch.parallel.dryrun:cases_rank", E * D,
                             {"cases": args}, tmp_path_factory.mktemp("sharded_step"),
                             timeout_s=240)
    finally:
        torch.set_num_threads(n)
    sharded = {name: [r[i] for r in ranks] for i, name in enumerate([*CASES, "fault"])}
    return single, sharded


def test_fomaml_over_the_mesh_matches_acn_tpus_mesh_step(runs):
    single, sharded = runs
    jm, jp = jax_mesh_step(single["fomaml"][2], jax.random.PRNGKey(10))
    got = sharded["fomaml"][0]
    assert [r["tasks"] for r in sharded["fomaml"]] == [(0, 1), (1, 3), (0, 1), (1, 3)]
    assert [r["k"] for r in sharded["fomaml"]] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    for name in ("loss_total", "loss_out", "loss_in", "psnr_out", "grad_norm",
                 "occ_overflow"):
        np.testing.assert_allclose(got["metrics"][0][name], jm[name], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=name)
    _params_close(got["params"], jp, **PARAM)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_the_single_rank_step(runs, name):
    single, sharded = runs
    m1, p1, _ = single[name]
    ranks = sharded[name]
    for r in ranks:  # every rank reads the whole mesh's metrics
        for key, v in r["metrics"][0].items():
            np.testing.assert_array_equal(v, ranks[0]["metrics"][0][key], err_msg=key)
    for key in ("loss_total", "loss_out", "loss_in", "psnr_in", "grad_norm", "occ_overflow"):
        np.testing.assert_allclose(ranks[0]["metrics"][0][key], m1[0][key], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=key)
    _params_close(ranks[0]["params"], p1, **PARAM)
    moved = _flat(p1)
    start = _flat(convert._numpy(port_model().params()))
    changed = [np.any(moved[k] != start[k]) for k in moved if "experts" in k]
    assert all(changed) if name != "reptile" else sum(changed) > len(changed) // 2
    if name != "reptile":
        assert all(r["count"] == 1 for r in ranks)
        assert ranks[0]["stats"]["collectives"] >= 4  # grads ×2, episodes, norms


def test_a_rank_that_skips_its_all_reduce_fails_the_tolerance(runs):
    single, sharded = runs
    with pytest.raises(AssertionError):
        _params_close(sharded["fault"][0]["params"], single["fomaml"][1], **PARAM)


def test_one_rank_mesh_step_equals_the_plain_step_bit_for_bit():
    sc = scene()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmesh.init_one_rank("cpu")
    try:
        for over, draws in (({"guard_nonfinite": 1}, 7), ({"algo": "reptile"}, 8)):
            P = step_P(**over)
            m1, p1 = dryrun.single_rank_step(sc.tcfg, port_model(), P, batch(), [draws],
                                             occ_cfg=sc.tocc_cfg, occ_states=sc.tocc)
            got = dryrun.step_rank(0, 1, dict(model=port_model(), P=P, occ_cfg=sc.tocc_cfg,
                                              occ_states=copy.deepcopy(sc.tocc),
                                              batch=batch(), draws=[draws], mesh=(1, 1)))
            for key, v in m1[0].items():
                np.testing.assert_array_equal(got["metrics"][0][key], v, err_msg=key)
            want, have = _flat(p1), _flat(got["params"])
            assert want.keys() == have.keys()
            for key in want:
                np.testing.assert_array_equal(have[key], want[key], err_msg=key)
            assert got["stats"]["collectives"] > 0  # the collectives ran, as copies
    finally:
        tmesh.shutdown()
        torch.set_num_threads(n)
