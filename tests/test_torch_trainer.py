"""The port's training loop (acn_tpu_torch.pipelines.offline_stage.trainer.
meta_trainer) against acn_tpu's, its stop and resume, and the port's
benchmark script (acn_tpu_torch.scripts.bench_train).

The loop runs at micro widths in float32 (K 2 experts, T 2 tasks of 64
support and 32 query rays, 2 inner steps, a 3-level hash grid, 16³ grids,
budget 6) through a whole regime schedule: stratified warm-up (steps 1–2),
the occupancy update every 2 steps, a strided step with the would-be
overflow read (3), the auto switch after the second reading, budget steps
(4–7), eval every 3 steps with a best save, a step save at 4, and the last
save. The first reading is the warm-up's last step, which ``acn_tpu`` reads
once its grids are ready (its overflow is 0: a stratified step marches
nothing); the port reads it too. With the switch off, the readings of steps
2–7 are 0, 0.2320, 0, 0.2432, 0, 0.2421 (both packages): the threshold,
0.237, lies between those of steps 3 and 5, so the switch fires at step 3
only because the port's own step-3 reading is under it. Episodes are sampled on the device from pools built by both packages'
samplers; the eval's batches come from host samplers. The port replays
acn_tpu's keys through its ``LoopDraws`` seam in the loop's own order (per
step the sampler's and the step's draws, per update the jitter of each
expert, per eval each task's draws).

Tolerances, those of tests/test_torch_train_step.py for two steps, held
here over seven: every logged scalar (losses, PSNRs, gradient norm,
would-be overflow, eval PSNR) rtol 1e-5; the parameters atol 1e-6 / rtol
1e-4. The occupancy grids: occs within rtol
1e-6 (found: 4.5e-7 after the three updates; the density MLP sums in
another order), binaries exactly. A grid is thresholded at min(occ_thre,
mean occ), and a cell nearer its threshold than the occs' tolerance could
fall either way, so the test asserts that no cell lies within 1e-6
(relative) of it. The scene's hash features are scaled ×1,000 so that σ
varies over the grid; the nearest cells found sit 4.1e-6 and 2.1e-6 from
their experts' thresholds (at ×500 they sat 2.2e-6 / 1.7e-6 with occs
3.0e-7 apart, at ×5,000 1.3e-5 / 5.4e-5 with occs 4.5e-6 apart).
"""

import dataclasses
import functools
import json
import os
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.data import tasks as jtasks
from acn_tpu.data.ram_rays import RamRaysDataset as JRamRays
from acn_tpu.models import container as jcont
from acn_tpu.utils import optim as joptim
from acn_tpu_torch import convert, toy
from acn_tpu_torch.data import tasks as ttasks
from acn_tpu_torch.data.ram_rays import RamRaysDataset
from acn_tpu_torch.models.nn import tree_leaves, tree_map
from acn_tpu_torch.pipelines.offline_stage import trainer as ttrainer
from acn_tpu_torch.utils import checkpoint as tck
from acn_tpu_torch.utils import logging as tlogging
from acn_tpu_torch.utils.config import load_checkpoint_cfg
from test_torch_train_step import K, T, S, Q, jax_draws, make_P, micro_scene

BAND = 1e-6
# between the would-be overflow of step 3 (0.2320) and that of step 5 (0.2432)
AUTO_THRESH = 0.237
HASH_SCALE = 1000.0
REGION = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
CKPT_FILES = (".model", ".optim", ".P.json", ".configs.json")


def loop_P(**over):
    return make_P(**{**dict(
        seed=0, batch_size=T, support_rays=S, query_rays=Q, occ_budget_per_ray=6,
        occ_regime="auto", occ_auto_thresh=AUTO_THRESH, occ_auto_patience=2, print_step=1,
        eval_step=3, save_step=4, outer_steps=7, max_test_tasks=1, test_batch_size=T,
        eval_render="dispatch", watchdog_timeout=0, save_optimizer=1), **over})


@functools.lru_cache(maxsize=None)
def scene():
    """The micro scene with its hash features scaled (module docstring)."""
    sc = micro_scene(sigma_bias=-0.5)
    sc = types.SimpleNamespace(**vars(sc))
    jvars = jax.tree.map(np.array, sc.jvars)
    experts = jvars["params"]["experts"]
    experts["hash_table"] = [t * HASH_SCALE for t in experts["hash_table"]]
    sc.jvars = jvars
    sc.jocc_cfg = dataclasses.replace(sc.jocc_cfg, warmup_steps=2, update_interval=2)
    sc.tocc_cfg = convert.occ_config_from_dict(dataclasses.asdict(sc.jocc_cfg))
    return sc


def ray_store(seed, n=2400, n_images=10):
    """Rays from x = −2 through the box (near 1, far 3) with a small tilt,
    random colors, ``n_images`` image ids."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([np.full((n, 1), -2.0), rng.uniform(-0.95, 0.95, (n, 2))], 1)
    d = np.concatenate([np.ones((n, 1)), rng.uniform(-0.1, 0.1, (n, 2))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o, d, np.tile([1.0, 3.0], (n, 1))], 1).astype(np.float32)
    rgbs = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return rays, rgbs, rng.integers(0, n_images, n).astype(np.int32)


def samplers(seed):
    """(JAX samplers, port samplers), one per expert, same seeds."""
    js, ts = [], []
    for k in range(K):
        rays, rgbs, img = ray_store(seed + k)
        jds = JRamRays.__new__(JRamRays)
        jds.rays, jds.rgbs, jds.img_indices = rays, rgbs, img
        jds.num_images = len(np.unique(img))
        js.append(jtasks.TaskSampler(jds, REGION, 2, S, Q, seed=seed + k))
        ts.append(ttasks.TaskSampler(RamRaysDataset.from_arrays(rays, rgbs, img), REGION, 2,
                                     S, Q, seed=seed + k, route_cache=None))
    return js, ts


class JaxLoopDraws(ttrainer.LoopDraws):
    """acn_tpu's loop keys replayed in its order, as the port asks for them."""

    def __init__(self, P, pools, occ_cfg):
        self.key = jax.random.PRNGKey(P.seed)
        self.P, self.pools, self.occ_cfg = P, pools, occ_cfg
        self.steps = 0

    def step(self):
        from test_torch_tasks import jax_episode_draws

        self.steps += 1
        self.key, k_step = jax.random.split(self.key)
        k_s, k_t = jax.random.split(k_step)
        return jax_episode_draws(k_s, self.pools, K, T), jax_draws(k_t)

    def _jitter(self, key):
        R, L = self.occ_cfg.resolution, self.occ_cfg.levels
        return {"jitter": torch.from_numpy(np.stack([
            np.asarray(jax.random.uniform(kk, (L, R ** 3, 3), minval=-0.5, maxval=0.5))
            for kk in jax.random.split(key, K)]))}

    def occ_update(self):
        self.key, k_occ = jax.random.split(self.key)
        return self._jitter(k_occ)

    def occ_refresh(self):
        return self._jitter(jax.random.PRNGKey(self.P.seed + 77))

    def eval(self, n):
        self.key, k_eval = jax.random.split(self.key)
        out = []
        for _ in range(n):
            k_eval, k_one = jax.random.split(k_eval)
            out.append(jax_draws(k_one, mode="eval", iterations=int(self.P.inner_iter)))
        return out


def _recording(cls):
    class Recording(cls):
        """A logger that also keeps every scalar it is given."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.scalars_seen = []

        def scalar(self, name, value, step):
            self.scalars_seen.append((name, int(step), float(np.asarray(value))))
            super().scalar(name, value, step)

    return Recording


@functools.lru_cache(maxsize=None)
def both_loops(tmp_root):
    """Both packages' loops over the same schedule; returns what each did."""
    from acn_tpu.pipelines.offline_stage import trainer as jtrainer
    from acn_tpu.utils.logging import Logger as JLogger

    sc = scene()
    js, ts = samplers(0)
    jtest, ttest = samplers(1000)
    pools = ttasks.build_device_pools(ts, max_pool=512, seed=0)
    jpools = jtasks.build_device_pools(js, max_pool=512, seed=0)
    assert all(np.array_equal(pools[k], jpools[k]) for k in pools)

    Pj = loop_P()
    jopt = joptim.build_optimizer(Pj, jcont.param_group_labels(sc.jvars, sc.jcfg),
                                  grad_clip=Pj.grad_clip)
    jv = jax.tree.map(jnp.asarray, sc.jvars)
    jlog = _recording(JLogger)("jax", logs_root=tmp_root)
    jstate = jtrainer.meta_trainer(
        Pj, sc.jcfg, {"variables": jv, "opt_state": jopt.init(jv["params"]),
                      "step": jnp.zeros((), jnp.int32)},
        jopt, None, jtasks.MultiTaskSampler(jtest), jlog, occ_cfg=sc.jocc_cfg,
        device_pools=jpools)
    jlog.close()

    Pt = loop_P()
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    topt, tstate = toy.init_train_state(model, Pt)
    tlog = _recording(tlogging.Logger)("port", logs_root=tmp_root)
    draws = JaxLoopDraws(Pt, pools, sc.jocc_cfg)
    tstate = ttrainer.meta_trainer(
        Pt, sc.tcfg, tstate, topt, None, ttasks.MultiTaskSampler(ttest), tlog,
        occ_cfg=sc.tocc_cfg, device_pools=pools, draws=draws, device="cpu")
    tlog.close()
    return types.SimpleNamespace(
        jlog=jlog, tlog=tlog, Pj=Pj, Pt=Pt, draws=draws,
        jparams=jax.device_get(jstate["variables"]["params"]),
        jocc=jax.device_get(jstate["occ_states"]),
        tstate=tstate)


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    return both_loops(str(tmp_path_factory.mktemp("logs")))


def test_loop_logs_the_same_scalars(loops):
    want, got = loops.jlog.scalars_seen, loops.tlog.scalars_seen
    assert [(n, s) for n, s, _ in got] == [(n, s) for n, s, _ in want]
    for (name, step, g), (_, _, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=f"{name} at {step}")
    names = {n for n, _, _ in want}
    assert {"train/loss", "train/grad_norm", "train/occ_would_overflow", "eval/psnr"} <= names
    # every step logged; the would-be overflow read at steps 2 and 3 only
    assert [s for n, s, _ in want if n == "train/loss"] == list(range(1, 8))
    assert [s for n, s, _ in want if n == "train/occ_would_overflow"] == [2, 3]
    readings = [w for n, s, w in want if n == "train/occ_would_overflow"]
    assert readings[0] == 0.0 and 0.2 < readings[1] <= AUTO_THRESH
    assert [s for n, s, _ in want if n == "eval/psnr"] == [3, 6]


def test_loop_switches_regime_at_the_same_step(loops):
    rec = loops.tstate["loop"]
    assert rec["switched_at"] == 3
    assert loops.Pj.occ_regime == loops.Pt.occ_regime == "budget"
    regimes = [s["regime"] for s in rec["steps"]]
    assert regimes == ["stratified"] * 2 + ["strided"] + ["budget"] * 4
    lines = (loops.jlog.logdir / "log.txt").read_text().splitlines()
    switch = next(i for i, l in enumerate(lines) if "auto-regime" in l)
    assert "step 3/7" in [l for l in lines[:switch] if "] step " in l][-1]
    assert loops.draws.steps == 7


def test_loop_parameters_match(loops):
    want = {jax.tree_util.keystr(p): np.asarray(l) for p, l in
            jax.tree_util.tree_flatten_with_path(loops.jparams)[0]}
    got_tree = convert.to_jax_variables(loops.tstate["model"])["params"]
    got = {jax.tree_util.keystr(p): np.asarray(l) for p, l in
           jax.tree_util.tree_flatten_with_path(got_tree)[0]}
    start = {jax.tree_util.keystr(p): np.asarray(l) for p, l in
             jax.tree_util.tree_flatten_with_path(scene().jvars["params"])[0]}
    assert want.keys() == got.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-6, rtol=1e-4, err_msg=name)
        assert np.any(got[name] != start[name]), f"{name} did not move"
    assert int(loops.tstate["opt_state"]["count"]) == 7 and loops.tstate["step"] == 7


def test_loop_occupancy_grids_match(loops):
    want, got = loops.jocc, {k: v.numpy() for k, v in loops.tstate["occ_states"].items()}
    np.testing.assert_array_equal(got["binaries"], np.asarray(want["binaries"]))
    np.testing.assert_array_equal(got["aabbs"], np.asarray(want["aabbs"]))
    occs = np.asarray(want["occs"])
    np.testing.assert_allclose(got["occs"], occs, rtol=BAND, atol=0)
    for k in range(K):
        thre = max(min(scene().jocc_cfg.occ_thre, float(occs[k][occs[k] >= 0].mean())), 1e-6)
        nearest = float(np.min(np.abs(occs[k] - thre)) / thre)
        assert nearest > BAND, (k, nearest)  # no cell in the band where it could flip
    share = np.asarray(want["binaries"]).mean()
    assert 0.05 < share < 0.95


def test_loop_writes_the_same_tags(loops):
    def tags(logdir):
        return sorted(p.name for p in logdir.iterdir() if p.name.endswith(CKPT_FILES))

    want, got = tags(loops.jlog.logdir), tags(loops.tlog.logdir)
    assert got == want
    assert {n.split(".")[0] for n in want} == {"best", "step4", "last"}
    assert "best.optim" not in want and "step4.optim" in want
    for name in ("step4.configs.json", "last.configs.json", "best.configs.json"):
        assert json.loads((loops.tlog.logdir / name).read_text()) == \
            json.loads((loops.jlog.logdir / name).read_text())
    # the switch persists: step 4's config was written after it fired
    assert load_checkpoint_cfg(str(loops.tlog.logdir / "step4.P.json"))["occ_regime"] == "budget"
    # the last save holds what the loop ended with
    got_model, occ = tck.restore_model(tck.load_checkpoint(loops.tlog.logdir, "last"),
                                       scene().tcfg, "cpu")
    for a, b in zip(tree_leaves(got_model.params()),
                    tree_leaves(loops.tstate["model"].params())):
        assert torch.equal(a, b)
    assert torch.equal(occ["binaries"], loops.tstate["occ_states"]["binaries"])


# ------------------------------------------------------------ stop and resume


class SignalAtStep(ttrainer.LoopDraws):
    """Generator draws that send SIGTERM to the process while the loop sets
    up step ``at``."""

    def __init__(self, seed, at):
        super().__init__(seed, "cpu")
        self.at, self.calls = at, 0

    def step(self):
        self.calls += 1
        if self.calls == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return super().step()


def _assert_equal(a, b, what):
    assert a.dtype == b.dtype and torch.equal(a, b), what


def _port_run(logs_root, P, start=None):
    sc = scene()
    _, ts = samplers(0)
    pools = ttasks.build_device_pools(ts, max_pool=512, seed=0)
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    opt, state = toy.init_train_state(model, P)
    kw = {}
    if start is not None:
        payload, tag = start
        model, occ = tck.restore_model(payload, sc.tcfg, "cpu")
        opt, state = toy.init_train_state(model, P)
        state["opt_state"] = tck.load_opt_state(tag[0], tag[1], state["opt_state"], opt)
        state["step"] = payload["step"]
        kw = dict(occ_states=occ, start_step=payload["step"], best=payload["best"])
    logger = tlogging.Logger("run", logs_root=logs_root)
    return state, opt, logger, pools, kw


def test_sigterm_stops_after_the_step_and_resume_restores_it(tmp_path):
    # any reading switches: the generator's draws are not the parity run's
    P = loop_P(outer_steps=6, eval_step=2, save_step=100, occ_auto_thresh=1.0)
    state, opt, logger, pools, _ = _port_run(str(tmp_path), P)
    handler = signal.getsignal(signal.SIGTERM)
    out = ttrainer.meta_trainer(P, scene().tcfg, state, opt, None, None, logger,
                                occ_cfg=scene().tocc_cfg, device_pools=pools,
                                draws=SignalAtStep(0, at=3), device="cpu")
    logger.close()
    assert signal.getsignal(signal.SIGTERM) is handler  # restored
    assert out["loop"]["last_step"] == 3 and out["step"] == 3
    run = logger.logdir
    assert sorted(p.name for p in run.glob("*.model")) == ["last.model"]
    payload = tck.load_checkpoint(run, "last")
    assert payload["step"] == 3
    # the switch fired after step 3 (readings at 2 and 3), before the save
    assert load_checkpoint_cfg(str(run / "last.P.json"))["occ_regime"] == "budget"

    # the resume restores the saved state exactly, then runs on to the end
    P2 = types.SimpleNamespace(**load_checkpoint_cfg(str(run / "last.P.json")))
    P2.outer_steps = 5
    state2, opt2, logger2, pools, kw = _port_run(str(tmp_path), P2,
                                                 start=(payload, (run, "last")))
    for a, b in zip(tree_leaves(state2["model"].params()), tree_leaves(out["model"].params())):
        assert torch.equal(a, b)
    assert state2["opt_state"].keys() == out["opt_state"].keys()
    for name in out["opt_state"]:  # paired by key: the two trees' orders differ
        tree_map(lambda a, b: _assert_equal(a, b, name), state2["opt_state"][name],
                 out["opt_state"][name])
    for name in out["occ_states"]:
        assert torch.equal(kw["occ_states"][name], out["occ_states"][name])
    assert kw["start_step"] == 3 and int(state2["opt_state"]["count"]) == 3
    out2 = ttrainer.meta_trainer(P2, scene().tcfg, state2, opt2, None, None, logger2,
                                 occ_cfg=scene().tocc_cfg, device_pools=pools,
                                 draws=ttrainer.LoopDraws(1, "cpu"), device="cpu", **kw)
    logger2.close()
    assert out2["loop"]["last_step"] == 5 and int(out2["opt_state"]["count"]) == 5
    assert [s["step"] for s in out2["loop"]["steps"]] == [4, 5]
    assert tck.load_checkpoint(logger2.logdir, "last")["step"] == 5


def test_loop_refuses_a_mesh_and_a_missing_card(tmp_path):
    P = loop_P()
    state, opt, logger, pools, _ = _port_run(str(tmp_path), P)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ttrainer.meta_trainer(P, scene().tcfg, state, opt, None, None, logger,
                              mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="none is available"):
            ttrainer.meta_trainer(P, scene().tcfg, state, opt, None, None, logger)
    logger.close()
    # without a process group the sum over processes leaves the meters as they are
    ml = tlogging.MetricLogger()
    ml.update(loss=2.0)
    ml.synchronize_between_processes()
    assert (ml.loss.count, ml.loss.total) == (1, 2.0)


def test_logger_versions_its_run_directory(tmp_path):
    first = tlogging.Logger("r", logs_root=str(tmp_path))
    first.log("hello")
    first.close()
    second = tlogging.Logger("r", logs_root=str(tmp_path))
    second.close()
    assert first.logdir.name == "r" and second.logdir.name == "r_v1"
    assert "hello" in (first.logdir / "log.txt").read_text()


# ---------------------------------------------------------------- the bench


def test_bench_train_prints_one_line_with_bench_keys(capsys):
    from acn_tpu_torch.scripts import bench_train

    assert bench_train.main(["--scale", "2,1,64,32,1,1", "--device", "cpu"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert rec["metric"] == "meta_train_ray_renders_per_sec_occ" and rec["unit"] == "rays/s"
    for key in ("value", "vs_baseline", "stratified_rays_per_sec", "occ_per_ray_rays_per_sec",
                "occ_budget_rays_per_sec", "occ_auto_premeasure_rays_per_sec",
                "occ_step_s", "occ_budget_step_s", "occ_auto_premeasure_step_s",
                "stratified_step_s"):
        assert rec[key] > 0, f"{key} not measured: {rec}"
    assert bench_train.main(["--scale", "2,1,64,32,1,1", "--device", "cpu",
                             "--regimes", "budget"]) == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["occ_budget_rays_per_sec"] > 0 and rec["stratified_rays_per_sec"] is None
    with pytest.raises(ValueError, match="unknown regimes"):
        bench_train.run((2, 1, 64, 32, 1, 1), ("fast",), device="cpu")


def test_profile_step_counts_what_the_step_dispatches(capsys):
    """One JSON line of profiled ATen ops per step by regime (no launches or
    card time on the CPU); a step with one more inner iteration dispatches
    more."""
    from acn_tpu_torch.scripts import profile_step

    assert profile_step.main(["--scale", "2,1,16,8,1", "--device", "cpu",
                              "--regimes", "stratified,occ"]) == 0
    rec = json.loads(capsys.readouterr().out.strip())
    ops = rec["aten_events"]
    assert set(ops) == {"stratified", "occ"} and rec["device"] == "cpu"
    assert all(n > 1000 for n in ops.values()), ops
    assert rec["kernel_launches"] == {"stratified": None, "occ": None}
    assert profile_step.run((2, 1, 16, 8, 2), ("occ",), "cpu")["aten_events"][
        "occ"] > ops["occ"]
    with pytest.raises(ValueError, match="unknown regimes"):
        profile_step.run((2, 1, 16, 8, 1), ("fast",), "cpu")
