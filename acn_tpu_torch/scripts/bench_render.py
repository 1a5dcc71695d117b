"""Frame rendering time of the port's serving paths, the counterpart of
``acn_tpu/scripts/bench_render.py``.

    python -m acn_tpu_torch.scripts.bench_render [--hw 1080 1920] [--frames 5]
        [--skip occ,stratified] [--baked RES [--baked_coarse 32]]
        [--checkpoint_path RUN --prefix last] [--device cuda] [--mesh N]

The scene is ``toy``'s (``configs/train_occ.json``'s model with random
weights over the 4 quadrant experts, 10 % random 128³ grids, the overhead
camera), or a trained run restored as ``--op eval`` restores it
(``runner.build_context(op="bench")``: no dataset is read). The regimes,
serving paths first:

* ``preview_b4_half_res``, ``preview_b4``, ``preview_half_res``,
  ``preview``: routed frames (``render_image_routed``) at a budget of 4 or
  8 samples per ray over 32 or 64 bins, at half and full resolution;
* ``routed_budget``: routed, ``--occ_budget_per_ray`` over 128 bins;
* ``occ_budget``: the dense soft-MoE budget frame (``render_image``);
* ``occ``: the dense strided frame (budget 0); ``stratified``: no grids;
* with ``--baked RES``: the field baked at RES³ (timed) and served by
  ``BakedRenderer``: ``baked``, ``baked_half_res`` and, with
  ``--baked_coarse``, ``baked_coarse`` (the range pre-pass, a quarter of
  the bins).

Each regime renders one warm frame, ``--frames`` frames left on the device
(the card synchronized after each), and one frame downloaded; it prints
one JSON line: ms per frame, FPS, ms with the download, the segmented
scan's forward launches per frame, and the card's ``nvidia-smi`` name and
power limit. The JAX script's segscan backend A/B (``--segscan_ab``) has
no counterpart: the port has one scan per device (the CUDA kernel on the
card, the plain scan on the CPU).

``--mesh N`` renders every frame by row blocks over N ranks
(``render_image(mesh=...)``): start N processes with ``--num_processes N
--process_id i --coordinator_address host:port`` (or the
``COORDINATOR_ADDRESS`` / ``PROCESS_ID`` / ``NUM_PROCESSES`` environment);
rank 0 prints. ``--mesh 1`` in one process runs a one-rank mesh (its
gather a copy), which measures the fan-out's own cost against the plain
path. Two ranks that share one card check the fan-out; their times are not
a scaling number.
"""

from __future__ import annotations

import argparse
import json
import time
import types

import numpy as np
import torch

from acn_tpu_torch import toy
from acn_tpu_torch.ops import segscan
from acn_tpu_torch.parallel import mesh as pmesh
from acn_tpu_torch.pipelines.renderer import Renderer, resolve_device
from acn_tpu_torch.scripts.bench_train import _card


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_frames(render, frames: int, device, mesh=None) -> dict:
    """One warm frame, ``frames`` timed frames on the device, one with the
    download: {ms_per_frame, fps, ms_e2e, scan_launches_per_frame}. Over a
    mesh a frame ends when every rank has rendered its blocks."""
    done = (lambda: pmesh.host_barrier()) if mesh is not None else (lambda: None)
    render(download=False)
    _sync(device)
    done()
    launches = segscan.seg_excl_sum_kernel.launches
    t0 = time.perf_counter()
    for _ in range(frames):
        render(download=False)
        done()
    dt = (time.perf_counter() - t0) / frames
    launches = (segscan.seg_excl_sum_kernel.launches - launches) / frames
    t0 = time.perf_counter()
    render()
    e2e = time.perf_counter() - t0
    return {"ms_per_frame": 1e3 * dt, "fps": 1.0 / dt, "ms_e2e": 1e3 * e2e,
            "scan_launches_per_frame": launches}


def _scene(args, device):
    """(cfg, model, occ_states, occ_cfg, scene box)."""
    if args.checkpoint_path:
        from acn_tpu_torch.occupancy.grid import OccConfig
        from acn_tpu_torch.pipelines.offline_stage.trainer import init_occ_states
        from acn_tpu_torch.runner import build_context
        from acn_tpu_torch.utils.config import parse_args

        ctx = build_context(parse_args(["--op", "eval", "--checkpoint_path",
                                        args.checkpoint_path, "--prefix", args.prefix]),
                            "bench", device=device)
        occ_cfg = ctx["occ_cfg"] or OccConfig(resolution=128, levels=1)
        occ = ctx["occ_states"]
        if occ is None:  # params only: every cell occupied
            occ = init_occ_states(ctx["model"].expert_aabbs, occ_cfg)
            occ["binaries"] = torch.ones_like(occ["binaries"])
        return ctx["cfg"], ctx["model"], occ, occ_cfg, np.asarray(ctx["global_aabb"])
    cfg, _, occ_cfg = toy.train_occ_config()
    model = toy.serving_model(cfg, seed=0, device=device)
    boxes, _ = toy.quadrant_layout(cfg.num_submodules)
    occ = toy.random_occ_states(boxes, occ_cfg, fill=args.occupancy_frac, seed=0,
                                device=device)
    return cfg, model, occ, occ_cfg, toy.SCENE_AABB


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", type=int, nargs=2, default=(1080, 1920))
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--ray_samples", type=int, default=96)
    ap.add_argument("--occ_s_max", type=int, default=256)
    ap.add_argument("--occ_s_kept", type=int, default=64)
    ap.add_argument("--chunk_points", type=int, default=4_000_000)
    ap.add_argument("--checkpoint_path", type=str, default=None)
    ap.add_argument("--prefix", type=str, default="best")
    ap.add_argument("--occupancy_frac", type=float, default=0.10)
    ap.add_argument("--occ_budget_per_ray", type=int, default=24)
    ap.add_argument("--skip", type=str, default="", help="comma-separated regimes to skip")
    ap.add_argument("--baked", type=int, default=0, metavar="RES")
    ap.add_argument("--baked_budget", type=int, default=24)
    ap.add_argument("--baked_coarse", type=int, default=0)
    ap.add_argument("--baked_sh", type=int, default=0, choices=[0, 1])
    ap.add_argument("--baked_smax", type=int, default=128)
    ap.add_argument("--save_baked", type=str, default="")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--mesh", type=int, default=-1, metavar="N",
                    help="row blocks over N ranks (1: a one-rank mesh, in one process)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--coordinator_address", type=str, default=None)
    args = ap.parse_args(argv)
    mesh, started = None, False
    if args.mesh >= 0:
        started = pmesh.maybe_init_distributed(args, args.device)
        if not started:
            pmesh.init_one_rank(torch.device(args.device or "cuda").type)
        world, rank = pmesh.world_rank()
        if args.mesh not in (0, world):
            raise ValueError(f"--mesh {args.mesh}: this run has {world} processes")
        mesh = pmesh.make_render_mesh() or pmesh.Mesh(
            num_experts=0, shape=(1,), rank=0, axis_names=("px",))
        args.device = str(pmesh.rank_device(args.device))
    try:
        return _bench(args, mesh)
    finally:
        if mesh is not None:
            pmesh.shutdown()


def _bench(args, mesh) -> dict:
    device = resolve_device(args.device)
    card = _card(device)
    H, W = args.hw
    pH, pW = H // 2, W // 2
    cfg, model, occ, occ_cfg, aabb = _scene(args, device)
    cam = toy.overhead_camera(H, W)
    cam["aabb"] = np.asarray(aabb, np.float32)
    skip = {s for s in args.skip.split(",") if s}
    out = {"H": H, "W": W, "device": card}
    main_rank = mesh is None or mesh.rank == 0
    if mesh is not None:
        out.update(mesh_ranks=mesh.size, backend=pmesh.backend())

    def emit(name, res):
        out[name] = res
        if main_rank:
            print(json.dumps({"regime": name, **res, "device": card,
                              **({"mesh_ranks": mesh.size} if mesh is not None else {})}),
                  flush=True)

    # (name, use_occ, budget per ray, (h, w), routed, render-time bins)
    regimes = [
        ("preview_b4_half_res", True, 4, (pH, pW), True, 32),
        ("preview_b4", True, 4, (H, W), True, 32),
        ("preview_half_res", True, 8, (pH, pW), True, 64),
        ("preview", True, 8, (H, W), True, 64),
        ("routed_budget", True, args.occ_budget_per_ray, (H, W), True, 128),
        ("occ_budget", True, args.occ_budget_per_ray, (H, W), False, 128),
        ("occ", True, 0, (H, W), False, 0),
        ("stratified", False, 0, (H, W), False, 0),
    ]
    for name, use_occ, budget, (h, w), routed, rsm in regimes:
        if name in skip:
            continue
        P = types.SimpleNamespace(
            ray_samples=args.ray_samples, chunk_points=args.chunk_points,
            bg_color_default="white", occ_s_max=args.occ_s_max, occ_s_kept=args.occ_s_kept,
            occ_budget_per_ray=budget, occ_render_s_max=rsm)
        r = Renderer(cfg, P, occ_cfg, device=device)
        fn = r.render_image_routed if routed else r.render_image
        view = dict(H=h, W=w, intrinsics=cam["intrinsics"] * (h / H), c2w=cam["c2w"],
                    aabb=cam["aabb"], use_occ=use_occ)
        emit(name, time_frames(lambda **kw: fn(model, occ, mesh=mesh, **view, **kw),
                               args.frames, device, mesh))

    if args.baked > 0:
        from acn_tpu_torch.pipelines.baking import BakedRenderer, bake_container, save_baked

        _sync(device)
        t0 = time.perf_counter()
        baked = bake_container(model, aabb=cam["aabb"], resolution=args.baked,
                               sh_degree=args.baked_sh,
                               occ_thre=1e-4)  # the random field is dim: keep its content
        bake_s = time.perf_counter() - t0
        emit("bake", {"bake_s": bake_s, "baked_res": args.baked,
                      "baked_mb": baked["table"].numel() * 4 / 2**20,
                      "occupied": float(baked["occ_state"]["binaries"].float().mean())})
        if args.save_baked:
            save_baked(args.save_baked, baked)
        br = BakedRenderer(baked, s_max=args.baked_smax, budget_per_ray=args.baked_budget,
                           chunk_points=args.chunk_points)
        variants = [("baked", br, (H, W)), ("baked_half_res", br, (pH, pW))]
        if args.baked_coarse > 0:
            variants.append(("baked_coarse", BakedRenderer(
                baked, s_max=max(args.baked_smax // 4, 32), budget_per_ray=args.baked_budget,
                chunk_points=args.chunk_points, s_coarse=args.baked_coarse), (H, W)))
        for name, rb, (h, w) in variants:
            if name in skip:
                continue
            view = dict(H=h, W=w, intrinsics=cam["intrinsics"] * (h / H), c2w=cam["c2w"])
            emit(name, time_frames(
                lambda rb=rb, view=view, **kw: rb.render_image(mesh=mesh, **view, **kw),
                args.frames, device, mesh))
    if main_rank:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
