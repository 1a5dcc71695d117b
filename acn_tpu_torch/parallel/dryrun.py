"""The sharded paths against one rank's, on CPU gloo ranks.

    python -m acn_tpu_torch.parallel.dryrun [N]

``dryrun_multichip(n)`` is the counterpart of ``__graft_entry__.py``'s: it
spawns n ranks (``launch.spawn``, gloo on the CPU), runs one FoMAML
meta-train step at micro shapes on a mesh of E × D = n (D = 2 when n is
even and above 2, the rest experts; K = E experts, T = 2·D tasks) and holds
it against the same step on one rank (loss rtol 1e-5, parameters rtol 2e-5 /
atol 2e-6); then a dense frame and a baked frame by row blocks over the n
ranks against one rank's (atol 1.5/255).

The rank functions (``step_rank``, ``loop_rank``, ``frames_rank``,
``collectives_rank``, ``runner_rank``, and ``cases_rank`` for several in one
group) are what the tests spawn too: each builds its mesh, takes its shard
of what the parent sent, runs, and returns numpy.
"""

from __future__ import annotations

import sys
import tempfile
import types
from typing import Any, Dict

import numpy as np
import torch

from acn_tpu_torch import toy
from acn_tpu_torch.models.nn import tree_map
from acn_tpu_torch.parallel import launch
from acn_tpu_torch.parallel.mesh import (
    Mesh,
    gather_tree,
    make_render_mesh,
    rank_device,
    shard_by_expert_axis,
)

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-6
FRAME_ATOL = 1.5 / 255


class RecordDraws:
    """A step's draws function that keeps what it returns, by (what, k, t,
    j): a table that ``ReplayDraws`` replays on ranks that cannot compute
    the draws themselves."""

    def __init__(self, fn):
        self.fn, self.table = fn, {}

    def __call__(self, what, k, t, j, shape):
        x = self.fn(what, k, t, j, shape)
        self.table[(what, k, t, j)] = x
        return x


class ReplayDraws:
    """``EpisodeDraws``' function form over a recorded table."""

    def __init__(self, table: Dict):
        self.table = table

    def __call__(self, what, k, t, j, shape):
        return self.table[(what, k, t, j)]


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                    else t, tree)


def _draws(d, device):
    """A step's draws from what the parent sent: a table (replayed), an int
    (a generator seeded with it) or None."""
    if isinstance(d, dict):
        return ReplayDraws(d)
    if isinstance(d, int):
        return torch.Generator(device=device).manual_seed(d)
    return d


def scan_counts():
    from acn_tpu_torch.ops import segscan

    return (segscan.seg_excl_sum_kernel.launches, segscan.seg_excl_rsum_kernel.launches)


def step_rank(rank: int, n: int, a: Dict[str, Any]) -> Dict[str, Any]:
    """``make_meta_train_step`` over a mesh of ``a["mesh"]`` = (E, D):
    ``a["model"]`` (whole), ``a["P"]``, ``a["occ_cfg"]``, ``a["occ_states"]``
    (whole, or None), ``a["batch"]`` (whole), one step per entry of
    ``a["draws"]``. Returns each step's metrics, and on rank 0 the gathered
    parameters and optimizer count."""
    from acn_tpu_torch.pipelines.offline_stage import train_step as ts
    from acn_tpu_torch.pipelines.offline_stage.trainer import dummy_occ_states

    dev = rank_device(a.get("device", "cpu"))
    K = a["model"].cfg.num_submodules
    mesh = Mesh.build(K, *a["mesh"])
    if a.get("fault") == "skip_data_reduce":  # a planted fault: the checks must see it
        reduce = mesh.all_reduce
        mesh.all_reduce = lambda ts, group, op=None: (
            None if group is mesh.data_group else reduce(ts, group, op))
    model = a["model"].to(dev)
    opt, state = toy.init_train_state(model, a["P"])
    state = {**state, **shard_by_expert_axis(
        {"model": model, "opt_state": state["opt_state"]}, mesh, K)}
    occ = a.get("occ_states")
    occ = (dummy_occ_states(mesh.k1 - mesh.k0, dev) if occ is None else
           shard_by_expert_axis({"occ_states": tree_map(lambda t: t.to(dev), occ)},
                                mesh, K)["occ_states"])
    batch = shard_by_expert_axis({"batch": {k: v.to(dev) for k, v in a["batch"].items()}},
                                 mesh, K)["batch"]
    step = ts.make_meta_train_step(a["model"].cfg, a["P"], opt, a.get("occ_cfg"),
                                   report_budget=int(a.get("report_budget", 0)),
                                   device=dev, mesh=mesh)
    metrics, launches = [], []
    for d in a["draws"]:
        c0 = scan_counts()
        state, m = step(state, batch, occ, _draws(d, dev))
        metrics.append(_numpy(m))
        launches.append(tuple(b - c for b, c in zip(scan_counts(), c0)))
    w = gather_tree({"model": state["model"], "opt_state": state["opt_state"]}, mesh, K)
    return {"metrics": metrics, "launches": launches, "stats": dict(mesh.stats),
            "params": _numpy(w["model"]["params"]) if rank == 0 else None,
            "count": int(state["opt_state"]["count"]), "k": (mesh.k0, mesh.k1),
            "tasks": mesh.task_range(int(a["batch"]["support_rays"].shape[1]))}


def loop_rank(rank: int, n: int, a: Dict[str, Any]) -> Dict[str, Any]:
    """``meta_trainer`` over a mesh of ``a["mesh"]``: ``a["model"]``,
    ``a["P"]``, ``a["occ_cfg"]``, ``a["pools"]`` (the card sampler's, whole),
    ``a["test_sampler"]``, logs under ``a["logs_root"]``; ``a["start"]`` =
    (run directory, tag) resumes from a checkpoint. Returns the loop's
    record and the run directory."""
    from acn_tpu_torch.pipelines.offline_stage.trainer import LoopDraws, meta_trainer
    from acn_tpu_torch.utils import checkpoint as tck
    from acn_tpu_torch.utils.logging import Logger

    P, cfg = types.SimpleNamespace(**vars(a["P"])), a["model"].cfg  # the loop sets P's regime
    mesh = Mesh.build(cfg.num_submodules, *a["mesh"])
    model, kw = a["model"], {}
    opt, state = toy.init_train_state(model, P)
    if a.get("start"):
        run, tag = a["start"]
        payload = tck.load_checkpoint(run, tag)
        model, occ = tck.restore_model(payload, cfg, "cpu")
        opt, state = toy.init_train_state(model, P)
        state["opt_state"] = tck.load_opt_state(run, tag, state["opt_state"], opt)
        state["step"] = payload["step"]
        kw = dict(occ_states=occ, start_step=payload["step"], best=payload["best"])
    # file-only: TensorBoard's import of TensorFlow loads JAX where both are installed
    logger = Logger(a.get("fname", "run"), logs_root=a["logs_root"], rank=rank,
                    tensorboard=False)
    out = meta_trainer(P, cfg, state, opt, None, a.get("test_sampler"), logger,
                       occ_cfg=a.get("occ_cfg"), mesh=mesh, device_pools=a["pools"],
                       draws=LoopDraws(int(P.seed), "cpu"), device="cpu", **kw)
    logger.close()
    return {"loop": out["loop"], "logdir": str(logger.logdir), "stats": dict(mesh.stats),
            "count": int(out["opt_state"]["count"])}


def frames_rank(rank: int, n: int, a: Dict[str, Any]) -> Dict[str, Any]:
    """Frames by row blocks over every rank (``make_render_mesh``): for each
    entry of ``a["frames"]`` = (kind, kwargs), kind "dense" or "routed"
    (``Renderer(a["cfg"], P, a["occ_cfg"])`` over ``a["model"]`` and
    ``a["occ_states"]``, P the entry's "P" or ``a["P"]``) or "baked"
    (``BakedRenderer(a["baked"], **kw["renderer"])``).
    A function-form ``draws`` is a table by (what, (dispatch, slot))."""
    from acn_tpu_torch.pipelines.baking import BakedRenderer
    from acn_tpu_torch.pipelines.renderer import Renderer

    mesh = make_render_mesh()
    out = []
    for kind, kw in a["frames"]:
        kw = dict(kw)
        if isinstance(kw.get("draws"), dict):
            table = kw["draws"]
            kw["draws"] = lambda what, c, shape, table=table: table[(what, c)]
        if kind == "baked":
            rkw = kw.pop("renderer")
            frame = BakedRenderer(a["baked"], **rkw).render_image(mesh=mesh, **kw)
        else:
            r = Renderer(a["cfg"], kw.pop("P", a["P"]), a.get("occ_cfg"), device="cpu",
                         **kw.pop("renderer", {}))
            fn = r.render_image if kind == "dense" else r.render_image_routed
            frame = fn(a["model"], a.get("occ_states"), mesh=mesh, **kw)
        out.append(frame)
    return {"frames": out, "stats": dict(mesh.stats) if mesh is not None else {}}


def collectives_rank(rank: int, n: int, a: Dict[str, Any]) -> Dict[str, Any]:
    """The mesh's own collectives on a mesh of ``a["mesh"]``: the expert
    gather, the any-rank flag, the mesh-wide norm and finite flag of a
    gradient tree whose expert leaves are (rank + 1)·ones and whose
    background leaf is ones, and ``MetricLogger.synchronize_between_
    processes`` of a meter updated with rank + 1 (rank + 1 times)."""
    import math

    from acn_tpu_torch.parallel import mesh as pmesh
    from acn_tpu_torch.utils.logging import MetricLogger

    K = a["K"]
    mesh = Mesh.build(K, *a["mesh"])
    E = mesh.shape[0]
    local = torch.full((K // E, 3), float(mesh.expert_index + 1))
    grads = {"experts": {"w": torch.ones(K // E, 2) * (mesh.expert_index + 1)},
             "bg_mlp": [torch.ones(4)]}
    bad = {"experts": {"w": torch.full((K // E, 2), math.nan if rank == n - 1 else 1.0)},
           "bg_mlp": [torch.ones(4)]}
    ml = MetricLogger()
    for _ in range(rank + 1):
        ml.update(loss=rank + 1.0)
    ml.synchronize_between_processes()
    render = pmesh.make_render_mesh()
    return {"gathered": mesh.gather_experts(local).numpy(),
            "any": (mesh.any_host(rank == n - 1), mesh.any_host(False)),
            "sq_norm": float(pmesh.tree_sq_norm(grads, mesh)),
            "finite": (bool(pmesh.all_finite(grads, mesh)), bool(pmesh.all_finite(bad, mesh))),
            "meter": (ml.loss.count, ml.loss.total), "backend": pmesh.backend(),
            "render_mesh": (render.shape, render.rank), "k": (mesh.k0, mesh.k1),
            "stats": dict(mesh.stats)}


def runner_rank(rank: int, n: int, a: Dict[str, Any]) -> Dict[str, Any]:
    """``runner.main(a["argv"], device="cpu")`` as process ``rank`` of n,
    from the directory ``a["cwd"]`` (its logs, file-only, and the ray and
    route caches under it). The rank first leaves the launcher's process
    group, so that ``main`` starts its own from the flags
    (``--coordinator_address file://...``), as a process launched by hand
    does. Returns the op's result (None above rank 0) and whether the rank
    is still in a group."""
    import os
    from pathlib import Path

    import torch.distributed as dist

    from acn_tpu_torch import runner
    from acn_tpu_torch.data import dataset, tasks
    from acn_tpu_torch.parallel import mesh as pmesh

    pmesh.host_barrier()  # every rank has joined before one leaves
    pmesh.shutdown()
    # file-only logs: TensorBoard's import of TensorFlow loads JAX where both
    # are installed
    sys.modules["torch.utils.tensorboard"] = None
    cwd = Path(a["cwd"])
    os.chdir(cwd)
    dataset.RAY_CACHE, tasks.ROUTE_CACHE = cwd / "port_rays", cwd / "routes"
    out = runner.main([*a["argv"], "--num_processes", str(n), "--process_id", str(rank),
                       "--coordinator_address", f"file://{cwd / 'runner_rendezvous'}"],
                      device="cpu")
    return {"out": out, "in_group": dist.is_initialized()}


def sleep_rank(rank: int, n: int, seconds: float) -> None:
    """A rank that does not finish within ``seconds``: what ``launch.spawn``
    must cut at its deadline."""
    import time

    time.sleep(seconds)


def cases_rank(rank: int, n: int, a: Dict[str, Any]) -> list:
    """Several rank functions in one group, in order: ``a["cases"]`` =
    [(name in this module, its arguments), ...] (one process start for
    all)."""
    return [globals()[name](rank, n, args) for name, args in a["cases"]]


# ---------------------------------------------------------------- dryrun


def micro_problem(K: int, seed: int = 0):
    """A micro model (2 hash levels, 16-wide MLPs) of K experts over the
    [-1, 1]³ box, and the dryrun's batch: T = 2·D tasks of rays down −z
    onto the box, colors 0.5 (``__graft_entry__``'s)."""
    from acn_tpu_torch.models.container import ContainerConfig, init_container
    from acn_tpu_torch.models.encodings import HashGridConfig
    from acn_tpu_torch.models.ngp import NGPConfig

    cfg = ContainerConfig(num_submodules=K, boundary_margin=1.1, use_bg_nerf=True,
                          bg_hidden=16, expert=NGPConfig(
                              hidden=16, color_hidden=16, hash=HashGridConfig(
                                  levels=2, min_res=4, max_res=16, log2_hashmap_size=8,
                                  features_per_level=2, layout="cell",
                                  dense_levels=True)))
    cents = np.stack([np.linspace(-0.5, 0.5, K), np.zeros(K), np.zeros(K)], 1)
    boxes = np.stack([toy.SCENE_AABB] * K)
    model = init_container(cfg, torch.from_numpy(cents.astype(np.float32)),
                           torch.from_numpy(boxes), torch.from_numpy(toy.SCENE_AABB),
                           generator=torch.Generator().manual_seed(seed))
    return cfg, model


def dryrun_batch(K: int, T: int, S: int = 32, Q: int = 16) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(0)
    o = np.concatenate([rng.uniform(-0.5, 0.5, (K, T, S + Q, 2)),
                        np.full((K, T, S + Q, 1), 2.0)], -1)
    d = np.tile(np.array([0, 0, -1.0]), (K, T, S + Q, 1))
    nf = np.concatenate([np.full((K, T, S + Q, 1), 1.0), np.full((K, T, S + Q, 1), 3.0)], -1)
    rays = np.concatenate([o, d, nf], -1).astype(np.float32)
    rgbs = np.full((K, T, S + Q, 3), 0.5, np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return {"support_rays": t(rays[:, :, :S]), "support_rgbs": t(rgbs[:, :, :S]),
            "query_rays": t(rays[:, :, S:]), "query_rgbs": t(rgbs[:, :, S:])}


def dryrun_P(**over) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{**dict(
        algo="fomaml", inner_iter=2, inner_lr=0.01, ray_samples=8, color_space="linear",
        bg_color_default="white", optimizer="adam", encoding_lr=1e-2, sigma_lr=2e-3,
        color_lr=2e-3, bg_lr=1e-3, lr=1e-4, outer_steps=10, decay_factor=10.0,
        no_scheduler=False, grad_clip=1.0, occ_s_max=16, occ_s_kept=8, use_amp=False,
        train_chunk_rays=0, fim=False, guard_nonfinite=0, chunk_points=4096,
        occ_budget_per_ray=0), **over})


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def single_rank_step(cfg, model, P, batch, draws, occ_cfg=None, occ_states=None,
                     report_budget=0):
    """The plain step (no mesh) on the CPU: (metrics, parameters), numpy."""
    from acn_tpu_torch.pipelines.offline_stage import train_step as ts
    from acn_tpu_torch.pipelines.offline_stage.trainer import dummy_occ_states

    K = cfg.num_submodules
    opt, state = toy.init_train_state(model, P)
    step = ts.make_meta_train_step(cfg, P, opt, occ_cfg, report_budget=report_budget,
                                   device="cpu")
    occ = dummy_occ_states(K) if occ_states is None else occ_states
    metrics = []
    for d in draws:
        state, m = step(state, batch, occ, _draws(d, torch.device("cpu")))
        metrics.append(_numpy(m))
    return metrics, _numpy(state["model"].params())


def dryrun_multichip(n_devices: int) -> None:
    import copy

    from acn_tpu_torch.pipelines.baking import BakedRenderer, bake_field
    from acn_tpu_torch.pipelines.renderer import Renderer

    D = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    E = n_devices // D
    K, T = E, 2 * D
    cfg, model = micro_problem(K)
    P = dryrun_P()
    batch = dryrun_batch(K, T)
    ref_m, ref_p = single_rank_step(cfg, copy.deepcopy(model), P, batch, [0])
    H = W = 16
    cam = {"intrinsics": np.array([0.7 * H, 0.7 * H, W / 2, H / 2], np.float32),
           "c2w": np.array([[0.0, 0.0, -1.0, -2.0], [0.0, 1.0, 0.0, 0.0],
                            [1.0, 0.0, 0.0, 0.0]], np.float32)}
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    view = dict(H=H, W=W, aabb=aabb, use_occ=False, **cam)
    rkw = {"chunk_rays": 64}  # 4 rows a chunk: several dispatches over the ranks
    dense_1 = Renderer(cfg, P, device="cpu", **rkw).render_image(model, None, **view)

    def toy_field(xd):
        x = xd[:, :3]
        sig = torch.where(torch.linalg.norm(x, dim=-1) < 0.6, 6.0, 0.0)
        return sig, torch.clamp(0.5 + 0.3 * x, 0.0, 1.0)

    baked = bake_field(toy_field, aabb, 17, bake_dirs=1, chunk=2048, occ_resolution=8,
                       occ_thre=1e-4, device="cpu")
    bkw = dict(s_max=32, budget_per_ray=16, chunk_points=2048)
    baked_1 = BakedRenderer(baked, **bkw).render_image(H=H, W=W, **cam)

    with tempfile.TemporaryDirectory() as tmp:
        steps = launch.spawn("acn_tpu_torch.parallel.dryrun:step_rank", n_devices, dict(
            model=model, P=P, batch=batch, draws=[0], mesh=(E, D)), f"{tmp}/step")
        frames = launch.spawn("acn_tpu_torch.parallel.dryrun:frames_rank", n_devices, dict(
            cfg=cfg, P=P, model=model, baked=baked, frames=[
                ("dense", dict(renderer=rkw, **view)),
                ("baked", dict(renderer=bkw, H=H, W=W, **cam))]), f"{tmp}/frames")
    loss, ref_loss = (float(m["loss_total"]) for m in (steps[0]["metrics"][0], ref_m[0]))
    assert abs(loss - ref_loss) <= LOSS_RTOL * max(1.0, abs(ref_loss)), (
        f"sharded loss {loss} != single-rank loss {ref_loss}")
    assert all(float(s["metrics"][0]["loss_total"]) == loss for s in steps), \
        "the ranks disagree on the loss"
    got, want = _flat(steps[0]["params"]), _flat(ref_p)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)
    dense_m, baked_m = frames[0]["frames"]
    np.testing.assert_allclose(dense_m[0], dense_1[0], atol=FRAME_ATOL)
    np.testing.assert_allclose(baked_m[0], baked_1[0], atol=FRAME_ATOL)
    print(f"dryrun_multichip OK: mesh=({E} experts × {D} data), K={K}, T={T}, "
          f"loss={loss:.5f}, sharded≡single-rank (Δloss={abs(loss - ref_loss):.2e}); "
          f"render row-blocks over {n_devices} ranks ≡ single-rank (max|Δrgb|="
          f"{float(np.abs(dense_m[0] - dense_1[0]).max()):.4f}); baked ≡ single-rank "
          f"(max|Δrgb|={float(np.abs(baked_m[0] - baked_1[0]).max()):.4f})")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
