"""The outer training loop: its steps, eval, checkpoints and
occupancy updates, and the auto-regime switch.

Port of ``acn_tpu/pipelines/offline_stage/trainer.py``: ``AutoRegime``,
``make_occ_update_fn``, ``init_occ_states``, ``dummy_occ_states`` and
``meta_trainer``. A run of ``configs/train_occ.json`` trains stratified for
``occ_cfg.warmup_steps`` steps, then strided with ``report_budget`` until
``AutoRegime`` switches it to the packed-budget step; the grids are rebuilt
every ``occ_cfg.update_interval`` steps.

Randomness: the loop draws from one ``torch.Generator`` on its device,
seeded from ``P.seed``, through ``LoopDraws``; a test passes a ``LoopDraws``
of its own that replays ``acn_tpu``'s keys in the loop's order. The step
and the occupancy update key their draws by expert (and task), so a rank of
a mesh draws what one device draws for its experts.

Over a mesh (``meta_trainer(mesh=...)``): each rank keeps its experts'
parameters, optimizer moments, grids and pools (``shard_by_expert_axis``),
trains and updates them, and reads the same metrics (the step gathers
them), so ``AutoRegime`` switches every rank at the same step. Rank 0 alone
logs and writes checkpoints, each gathered from the shards into the single
device's layout. A SIGTERM on any rank stops every rank after the same
step.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from acn_tpu_torch.models.container import Container, ContainerConfig
from acn_tpu_torch.occupancy import grid as occ_grid
from acn_tpu_torch.occupancy.grid import OccConfig
from acn_tpu_torch.parallel.mesh import check_mesh, gather_tree, shard_by_expert_axis
from acn_tpu_torch.pipelines.offline_stage.train_step import (
    make_device_batch_fn,
    make_eval_step,
    make_meta_train_step,
    pools_to_device,
    regime_of,
)
from acn_tpu_torch.pipelines.renderer import resolve_device
from acn_tpu_torch.utils import startup
from acn_tpu_torch.utils.checkpoint import AsyncCheckpointer, save_checkpoint
from acn_tpu_torch.utils.logging import Logger, MetricLogger, PhaseTimer
from acn_tpu_torch.utils.seeding import keyed_generator, step_seed


class AutoRegime:
    """Marching-regime controller: strided until the budget path is safe.

    The packed-budget march drops valid samples batch-tail-first while the
    grids are still dense, which corrupts training. The controller keeps the
    unbiased strided step while the measured would-be overflow
    (``march_rays(report_budget=...)``) stays above ``thresh``, and fires
    after ``patience`` consecutive readings at or under it. One-way."""

    def __init__(self, thresh: float = 0.02, patience: int = 3):
        self.thresh = float(thresh)
        self.patience = int(patience)
        self.streak = 0
        self.switched = False

    def observe(self, would_overflow: float) -> bool:
        """Feed one reading; True exactly once: when the switch fires."""
        if self.switched:
            return False
        if would_overflow <= self.thresh:
            self.streak += 1
        else:
            self.streak = 0
        if self.streak >= self.patience:
            self.switched = True
            return True
        return False


def make_occ_update_fn(cfg: ContainerConfig, occ_cfg: OccConfig, mesh=None):
    """The all-expert occupancy EMA update:
    ``update_all(model, occ_states, jitter=None, generator=None)`` → new
    stacked states, one per expert of the model (over a ``mesh``, this
    rank's).

    The experts are updated one after another (the all-cells density sweep
    is the largest computation of a run), each in float32 on its own
    parameters over its own grid, with step size diag(expert AABB)/1000.
    ``jitter`` (K, L, R³, 3) in [−0.5, 0.5), every expert's, is injected
    (JAX draws one per expert from a split key), or drawn from a generator
    of expert k's own, keyed by k and seeded from ``generator``'s state; one
    of the two is required."""
    k0 = 0 if mesh is None else mesh.k0

    def update_all(model: Container, occ_states: Dict[str, torch.Tensor],
                   jitter: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        seed = step_seed(generator) if generator is not None else None
        states = []
        for k in range(model.expert_aabbs.shape[0]):
            params, aabb = model.expert(k), model.expert_aabbs[k]
            states.append(occ_grid.update_occ_grid(
                {name: v[k] for name, v in occ_states.items()},
                lambda x: cfg.expert_density(params, cfg.expert, aabb, x)[..., 0],
                occ_cfg, occ_cfg.step_size_for_traced(aabb),
                jitter=None if jitter is None else jitter[k0 + k],
                generator=None if seed is None else keyed_generator(
                    seed, k0 + k, device=generator.device)))
        return {name: torch.stack([s[name] for s in states]) for name in states[0]}

    return update_all


def init_occ_states(expert_aabbs: torch.Tensor, occ_cfg: OccConfig) -> Dict[str, torch.Tensor]:
    """Stacked (K, ...) empty occupancy states, each over its expert's AABB,
    on the AABBs' device."""
    states = [occ_grid.init_occ_state(ab, occ_cfg) for ab in expert_aabbs]
    return {name: torch.stack([s[name] for s in states]) for name in states[0]}


def dummy_occ_states(num_experts: int, device=None) -> torch.Tensor:
    """The stratified regime's placeholder for the occupancy states."""
    return torch.zeros((num_experts,), dtype=torch.float32, device=device)


class LoopDraws:
    """The loop's random draws, asked for in the loop's order:

    * ``step()`` once per step, before its batch: (the sampler's draws, the
      step's draws), each as ``make_device_batch_fn`` / ``EpisodeDraws``
      take them (the first is unused when the host samples);
    * ``occ_update()`` per occupancy update, and ``occ_refresh()`` once when
      a resumed run starts past the warm-up: keyword arguments of the
      update (``jitter=`` or ``generator=``);
    * ``eval(n)`` per eval: the draws of each of its n test tasks.

    This one hands out one ``torch.Generator`` on ``device`` seeded from
    ``seed``. ``acn_tpu`` splits one key in the same order (per step
    ``key, k_step = split(key)``, the sampler and the step then splitting
    ``k_step``; per update ``key, k_occ = split(key)``; per eval ``key,
    k_eval = split(key)``, then one split per task; the resumed run's
    refresh from ``PRNGKey(seed + 77)``)."""

    def __init__(self, seed: int, device):
        self.generator = torch.Generator(device=device).manual_seed(int(seed))

    def step(self):
        return self.generator, self.generator

    def occ_update(self) -> Dict[str, Any]:
        return {"generator": self.generator}

    def occ_refresh(self) -> Dict[str, Any]:
        return {"generator": self.generator}

    def eval(self, n: int) -> list:
        return [self.generator] * n


def _host(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in metrics.items()}


def _start_watchdog(timeout_s: float, progress: dict, done: threading.Event) -> None:
    """Exit the process with code 42 when the loop makes no progress for
    ``timeout_s`` seconds (a supervisor resumes from the last checkpoint);
    stops when ``done`` is set."""

    def watch():
        while not done.wait(min(30.0, timeout_s)):
            if time.monotonic() - progress["t"] > timeout_s:
                print(f"[watchdog] no progress past step {progress['step']} for "
                      f"{timeout_s:.0f}s — exiting 42 for resume", flush=True)
                import os

                os._exit(42)

    threading.Thread(target=watch, daemon=True, name="loop-watchdog").start()


def meta_trainer(
    P,
    cfg: ContainerConfig,
    state: Dict[str, Any],
    optimizer,
    train_sampler,
    test_sampler,
    logger: Logger,
    occ_cfg: Optional[OccConfig] = None,
    occ_states=None,
    mesh=None,
    start_step: int = 0,
    best: float = float("-inf"),
    device_pools=None,
    draws: Optional[LoopDraws] = None,
    device=None,
) -> Dict[str, Any]:
    """Meta-train from ``start_step`` to ``P.outer_steps``; returns the
    final state with its ``occ_states`` and a record of the run (``loop``).

    ``state`` = {"model", "opt_state", "step"} as ``make_meta_train_step``
    takes it; ``optimizer`` its ``utils.optim.Optimizer``. With
    ``device_pools`` (``data.tasks.build_device_pools``'s arrays, or them
    on the device) the batch is sampled on the card and nothing crosses
    from the host per step; else ``train_sampler.sample_batch`` gives it.
    ``test_sampler`` (or None) gives the eval's batches on the host.

    Per step: the step of the current regime (stratified until the warm-up
    ends, then strided, with ``report_budget`` under ``occ_regime`` auto,
    then the budget step once ``AutoRegime`` fires, which sets
    ``P.occ_regime = "budget"`` for the checkpoints); every
    ``update_interval`` steps the occupancy update; every ``print_step``
    steps (and at step 1) the metrics are read back to the host, logged and
    fed to ``AutoRegime``, and no other step waits for the card; every
    ``eval_step`` steps the query PSNR of ``max_test_tasks`` test batches,
    and a params-only ``best`` save when it improves; every ``save_step``
    steps a full ``step{N}`` save (optimizer and grids; saves run off the
    loop); at the end a ``last`` save. SIGTERM or SIGINT finishes the
    current step and saves ``last``. ``P.watchdog_timeout`` > 0 exits with
    code 42 after that long without a step. ``P.profile_at`` = N traces
    steps N … N + ``profile_steps`` − 1 with ``torch.profiler`` into
    ``<logdir>/profile``. ``device=None`` is the card.

    ``mesh`` (``parallel.mesh.make_mesh``'s): the whole model, optimizer
    state, grids and pools are given on every rank; each keeps its experts'
    shard, and the returned state holds this rank's shard of the model
    (``loop`` and ``occ_states`` likewise); the checkpoints hold the whole
    state, written by rank 0."""
    check_mesh(mesh)
    device = resolve_device(device)
    K = cfg.num_submodules
    main_rank = mesh is None or mesh.rank == 0
    if mesh is not None:
        state = {**state, **shard_by_expert_axis(
            {"model": state["model"], "opt_state": state["opt_state"]}, mesh, K)}
        occ_states, device_pools = (shard_by_expert_axis(
            {"occ_states": occ_states, "device_pools": device_pools}, mesh, K)[key]
            for key in ("occ_states", "device_pools"))
    model = state["model"]
    use_occ = occ_cfg is not None
    occ_ready = use_occ and start_step >= occ_cfg.warmup_steps
    if occ_states is None:
        occ_states = (init_occ_states(model.expert_aabbs, occ_cfg) if use_occ
                      else dummy_occ_states(model.expert_aabbs.shape[0], device))
    draws = draws if draws is not None else LoopDraws(int(P.seed), device)

    def whole(**tree):
        """The state's pieces gathered from the shards (every rank takes
        part; rank 0 writes them)."""
        return gather_tree(tree, mesh, K)

    def host_batch(sampler, n):
        b = sampler.sample_batch(n)
        b = {k: torch.from_numpy(b[k]).to(device) for k in
             ("support_rays", "support_rgbs", "query_rays", "query_rgbs")}
        return shard_by_expert_axis({"batch": b}, mesh, K)["batch"]

    sample_fn = None
    if device_pools is not None:
        device_pools = pools_to_device(device_pools, device)
        sample_fn = make_device_batch_fn(int(P.batch_size), int(P.support_rays),
                                         int(P.query_rays), mesh=mesh)

    # the marching regime (AutoRegime): with a budget, occ_regime "auto"
    # trains strided and measures the would-be overflow until the switch;
    # "budget" / "strided" force one; the switch persists as P.occ_regime
    budget_cfg = int(getattr(P, "occ_budget_per_ray", 0) or 0)
    regime_flag = str(getattr(P, "occ_regime", "auto") or "auto")
    budget_active = budget_cfg > 0 and regime_flag == "budget"
    auto = budget_cfg > 0 and regime_flag == "auto"
    regime_ctl = (AutoRegime(float(getattr(P, "occ_auto_thresh", 0.02) or 0.02),
                             int(getattr(P, "occ_auto_patience", 3) or 3))
                  if auto else None)

    def build_train_step(with_occ_render: bool, with_budget: bool):
        oc = occ_cfg if with_occ_render else None
        step_fn = make_meta_train_step(
            cfg, P, optimizer, oc, budget_override=budget_cfg if with_budget else 0,
            report_budget=budget_cfg if (auto and not with_budget) else 0, device=device,
            mesh=mesh)
        return step_fn, regime_of(oc, P, budget_cfg if with_budget else 0)

    def build_eval_step(with_occ_render: bool):
        # "dispatch": the train renderer past the warm-up; "stratified" pins
        # one instrument across the switch
        oc = occ_cfg if with_occ_render else None
        eval_oc = oc if getattr(P, "eval_render", "dispatch") == "dispatch" else None
        return make_eval_step(cfg, P, eval_oc, device=device, mesh=mesh)

    train_step, regime = build_train_step(occ_ready, budget_active)
    eval_step = build_eval_step(occ_ready)
    occ_update = make_occ_update_fn(cfg, occ_cfg, mesh) if use_occ else None
    if occ_ready:
        # a resumed run past the warm-up refreshes its grids from the
        # restored densities before the first step
        occ_states = occ_update(model, occ_states, **draws.occ_refresh())

    metric_log = MetricLogger()
    logger.add_region_layout(K)
    timer = PhaseTimer()
    ckpt = AsyncCheckpointer()
    record: Dict[str, Any] = {"steps": [], "switched_at": None, "save_ms": [],
                              "eval_psnr": []}

    profile_at = int(getattr(P, "profile_at", 0) or 0)
    profile_steps = int(getattr(P, "profile_steps", 3) or 3)
    profiler = None

    progress = {"t": time.monotonic(), "step": start_step}
    loop_done = threading.Event()
    watchdog_timeout = float(getattr(P, "watchdog_timeout", 900) or 0)
    if watchdog_timeout > 0:
        _start_watchdog(watchdog_timeout, progress, loop_done)
    startup.mark_ready()  # the loop's watchdog takes over from the startup's

    stop = {"flag": False}

    def request_stop(signum, frame):
        stop["flag"] = True
        logger.log(f"[trainer] signal {signum} → finishing step and saving")

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, request_stop)
        except ValueError:  # not the main thread
            pass

    step = start_step
    t_loop = time.perf_counter()
    rays_per_step = K * int(P.batch_size) * (
        int(P.support_rays) * int(P.inner_iter) + int(P.query_rays))
    try:
        while step < int(P.outer_steps) and not stop["flag"]:
            sample_draws, step_draws = draws.step()
            timer.tic("data")
            if sample_fn is not None:
                batch = sample_fn(device_pools, sample_draws)
            else:
                batch = host_batch(train_sampler, int(P.batch_size))
            timer.toc("data")

            if profile_at and step + 1 == profile_at:
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else [])])
                profiler.start()

            timer.tic("step")
            state, metrics = train_step(state, batch, occ_states, step_draws)
            step += 1
            if mesh is not None and mesh.any_host(stop["flag"]):
                stop["flag"] = True  # a signal on any rank stops every rank here
            progress["t"], progress["step"] = time.monotonic(), step
            # the host reads the metrics on log steps only: a read waits for
            # the whole step
            will_log = step % int(P.print_step) == 0 or step == 1
            if will_log:
                metrics = _host(metrics)
            timer.toc("step")
            record["steps"].append({"step": step, "regime": regime, "logged": will_log})

            if profiler is not None and step >= profile_at + profile_steps - 1:
                profiler.stop()
                (logger.logdir / "profile").mkdir(parents=True, exist_ok=True)
                profiler.export_chrome_trace(str(logger.logdir / "profile" / "trace.json"))
                profiler = None
                logger.log(f"[profiler] trace saved to {logger.logdir}/profile")

            if use_occ:
                if step % occ_cfg.update_interval == 0:
                    occ_states = occ_update(model, occ_states, **draws.occ_update())
                if not occ_ready and step >= occ_cfg.warmup_steps:
                    occ_ready = True
                    logger.log("[OCC] warmup concluded → occupancy renderer")
                    train_step, regime = build_train_step(True, budget_active)
                    eval_step = build_eval_step(True)

            if will_log:
                metric_log.update(loss=float(metrics["loss_total"]),
                                  psnr_in=float(np.mean(metrics["psnr_in"])),
                                  psnr_out=float(np.mean(metrics["psnr_out"])))
                record["steps"][-1]["metrics"] = metrics
                phases = timer.reset()
                dt = time.perf_counter() - t_loop
                t_loop = time.perf_counter()
                per_it = dt / max(int(P.print_step), 1)
                logger.log(
                    f"step {step}/{P.outer_steps} {metric_log} | {per_it:.3f}s/it "
                    f"({rays_per_step / max(per_it, 1e-9):,.0f} rays/s) | data "
                    f"{phases.get('data', 0):.2f}s step {phases.get('step', 0):.2f}s")
                logger.scalar("train/loss", metrics["loss_total"], step)
                for r in range(K):
                    logger.scalar(f"train/psnr_out/region_{r}", metrics["psnr_out"][r], step)
                    logger.scalar(f"train/loss_out/region_{r}", metrics["loss_out"][r], step)
                logger.scalar("train/grad_norm", metrics["grad_norm"], step)
                ovf = float(metrics.get("occ_overflow", 0.0))
                if auto and occ_ready and not budget_active:
                    # strided and measuring: the WOULD-BE drop at the budget
                    logger.scalar("train/occ_would_overflow", ovf, step)
                    if regime_ctl.observe(ovf):
                        budget_active = True
                        P.occ_regime = "budget"  # persists through checkpoints
                        record["switched_at"] = step
                        logger.log(
                            f"[occ] auto-regime: would-drop {ovf:.1%} ≤ "
                            f"{regime_ctl.thresh:.0%} for {regime_ctl.patience} readings "
                            f"— switching to the global-budget marcher (budget "
                            f"{budget_cfg}/ray)")
                        train_step, regime = build_train_step(True, True)
                elif ovf > 0:
                    logger.scalar("train/occ_budget_overflow", ovf, step)
                    if ovf > 0.05:
                        logger.log(f"[occ] budget overflow {ovf:.1%} — valid samples "
                                   "are being dropped; raise --occ_budget_per_ray")

            if test_sampler is not None and step % int(P.eval_step) == 0:
                n_tasks = int(P.max_test_tasks)
                psnrs = []
                for task_draws in draws.eval(n_tasks):
                    tb = host_batch(test_sampler, int(P.test_batch_size))
                    psnrs.append(float(eval_step(model, tb, occ_states, task_draws)["psnr"]))
                psnr = float(np.mean(psnrs))
                record["eval_psnr"].append((step, psnr))
                logger.scalar("eval/psnr", psnr, step)
                logger.log(f"[eval] step {step} query PSNR {psnr:.3f} (best {best:.3f})")
                if psnr > best:
                    best = psnr
                    # params only: best checkpoints serve eval and serving;
                    # a resume takes the step saves, which carry the rest
                    t0 = time.perf_counter()
                    w = whole(model=model)
                    if main_rank:
                        ckpt.save(logger.logdir, "best", w["model"], P=P, step=step,
                                  best=best, is_best=True)
                    record["save_ms"].append(1e3 * (time.perf_counter() - t0))
                    logger.log(f"[ckpt] new best ({best:.3f}) save queued")

            if step % int(P.save_step) == 0:
                # the full resume state: optimizer and grids ride along; the
                # "step" key keeps at most one such snapshot pending
                save_opt = bool(getattr(P, "save_optimizer", True))
                t0 = time.perf_counter()
                w = whole(model=model, opt_state=state["opt_state"] if save_opt else None,
                          occ_states=occ_states if use_occ else None)
                if main_rank:
                    ckpt.save(logger.logdir, f"step{step}", w["model"],
                              opt_state=w["opt_state"], occ_states=w["occ_states"],
                              P=P, step=step, best=best, coalesce_key="step",
                              optimizer=optimizer)
                record["save_ms"].append(1e3 * (time.perf_counter() - t0))

        ckpt.wait()  # the queued saves land before the final one
        w = whole(model=model, opt_state=state["opt_state"],
                  occ_states=occ_states if use_occ else None)
        if main_rank:
            save_checkpoint(logger.logdir, "last", w["model"], opt_state=w["opt_state"],
                            occ_states=w["occ_states"], P=P, step=step, best=best,
                            optimizer=optimizer)
    finally:
        loop_done.set()
        if profiler is not None:
            profiler.stop()
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
    if ckpt.errors:
        raise RuntimeError(f"checkpoint saves failed: {ckpt.errors}")
    logger.log(f"training complete at step {step}; best eval PSNR {best:.3f}")
    state["occ_states"] = occ_states
    state["loop"] = {**record, "best": best, "last_step": step}
    return state
