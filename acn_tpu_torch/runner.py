"""The entry point's machinery: the model and occupancy configs from the
flags, the per-op context, and the ops.

Port of ``acn_tpu/runner.py``. ``build_context(P, op)`` loads the
clustering metadata and scene boxes of the prepared dataset, normalizes
near and far, builds the expert container on the device (restoring it, and
its occupancy grids when it has them, from ``--checkpoint_path``), and per
op: for ``train`` the per-expert ray stores, episodic samplers, the pools of
the sampler on the card, the optimizer and the camera-premarked grids; for
``eval`` and ``video`` the validation metadata (cut by ``--cap_images``);
``view``, ``bake`` and ``bench`` only the model. ``main`` parses the flags
and runs the op: ``train`` (``meta_trainer``), ``eval`` (TTO and scoring,
or with ``--baked_asset`` the baked table's frames, strided by default),
``video`` (``render_video`` along ``--camera_path``, live or baked),
``bake`` (``baked_<R>.npz`` in the run's log directory) and ``view``
(``viewer.launch_viewer``: the viser GUI over the live-adaptation engine;
without viser it raises ``acn_tpu``'s ImportError).

Several processes (``--num_processes N --process_id i --coordinator_address
host:port``, or the ``COORDINATOR_ADDRESS`` / ``PROCESS_ID`` /
``NUM_PROCESSES`` environment): ``main`` starts the process group before
any use of the card (``parallel.mesh.maybe_init_distributed``: NCCL when
each rank has a card, gloo when they share one or run on the CPU), puts
rank i on ``cuda:{local rank}`` and sets ``P.rank``. ``--op train`` builds
the (expert, data) mesh of ``make_mesh(K, --mesh_experts, --mesh_data)``
and trains sharded; rank 0 alone logs and writes. For the other ops every
rank leaves the process group at once, and rank 0 goes on alone. In one
process the mesh flags are ignored, as in ``acn_tpu`` (a sharded run's
checkpoint, whose flags name its mesh, resumes there); over several, a
mesh that does not cover every process is refused.

Entry points run on the card; ``build_context(..., device="cpu")`` and
``main(argv, device="cpu")`` run on the CPU, as the tests do.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from acn_tpu_torch.data.dataset import (
    cap_metadata,
    get_dataset,
    get_image_metadata,
    load_clustering_meta,
    load_coordinates,
    load_scene_boxes,
)
from acn_tpu_torch.data import tasks
from acn_tpu_torch.data.tasks import MultiTaskSampler, TaskSampler, build_device_pools
from acn_tpu_torch.models import container as cont
from acn_tpu_torch.models.container import ContainerConfig
from acn_tpu_torch.models.encodings import HashGridConfig
from acn_tpu_torch.models.ngp import NGPConfig
from acn_tpu_torch.models.vanilla import VanillaConfig
from acn_tpu_torch.occupancy import grid as occ_grid
from acn_tpu_torch.occupancy.grid import OccConfig
from acn_tpu_torch.parallel import mesh as pmesh
from acn_tpu_torch.pipelines.offline_stage.trainer import init_occ_states
from acn_tpu_torch.pipelines.renderer import resolve_device
from acn_tpu_torch.utils import startup
from acn_tpu_torch.utils.checkpoint import (
    load_checkpoint_with_fallback,
    load_opt_state,
    resolve_checkpoint_dir,
    restore_model,
)
from acn_tpu_torch.utils.config import parse_args
from acn_tpu_torch.utils.logging import Logger
from acn_tpu_torch.utils.optim import build_optimizer

def build_model_configs(P, clustering_params) -> ContainerConfig:
    """The flags → the container's config. ``--log2_hashmap_size`` is log2
    of the parameter slots per level; the cell layout packs 8 corner
    features per row, so its row count is 2^(log2 − 3)."""
    layout = getattr(P, "hash_layout", "cell")
    log2 = int(P.log2_hashmap_size) - (3 if layout == "cell" else 0)
    hash_cfg = HashGridConfig(
        levels=int(getattr(P, "hash_levels", 16)),
        min_res=16,
        max_res=int(P.max_res),
        log2_hashmap_size=max(log2, 4),
        features_per_level=int(getattr(P, "hash_features", 2)),
        interpolation="Linear",
        layout=layout,
        dense_levels=bool(getattr(P, "hash_dense_levels", False)),
    )
    if P.nerf_variant == "instant":
        expert_cfg = NGPConfig(
            hidden=P.dim_hidden,
            sigma_depth=P.sigma_depth,
            color_hidden=P.color_hidden,
            color_depth=P.color_depth,
            dir_encoding=P.dir_encoding,
            hash=hash_cfg,
        )
    else:
        expert_cfg = VanillaConfig(
            hidden=P.dim_hidden if P.dim_hidden > 64 else 256,
            sigma_depth=max(P.sigma_depth, 8),
            color_hidden=P.color_hidden,
            color_depth=max(P.color_depth, 2),
            dir_encoding=P.dir_encoding,
        )
    boundary_margin = min(max(1.0, P.bm), float(clustering_params["boundary_margin"]))
    return ContainerConfig(
        num_submodules=P.num_submodules,
        nerf_variant=P.nerf_variant,
        boundary_margin=boundary_margin,
        cluster_2d=bool(clustering_params["cluster_2d"]),
        use_bg_nerf=not P.no_bg_nerf,
        bg_hidden=P.bg_hidden,
        bg_encoding=P.bg_encoding,
        expert=expert_cfg,
    )


def build_occ_config(P, pose_scale_factor: float) -> Optional[OccConfig]:
    """The occupancy grid's config, or None without ``--use_occ``."""
    if not P.use_occ:
        return None
    return OccConfig(
        resolution=128,
        levels=int(getattr(P, "occ_levels", 1)),
        render_step_size=None,
        occ_thre=1e-2,
        alpha_thre=1e-2,
        alpha_thre_start=0.0,
        cosine_anneal=True,
        warmup_steps=int(getattr(P, "occ_warmup", 256)),
        update_interval=16,
        ema_decay=0.95,
        cone_angle=0.004,
        near_plane=(P.near if P.near is not None else 0.05 / pose_scale_factor),
        far_plane=(P.far if P.far is not None else 1e3 / pose_scale_factor),
    )


def _check_restored(model, template) -> None:
    """A restored model must have the built model's structure and shapes
    (the flags pin the architecture from the checkpoint)."""
    want = {k: tuple(v.shape) for k, v in template.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if got != want:
        diff = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
        raise ValueError(f"the checkpoint's model does not match the configured one: {diff}")


def build_context(P, op: str, device=None) -> Dict[str, Any]:
    """The context of ``op`` on ``device`` (``None``: the card)."""
    if op not in ("train", "eval", "video", "view", "bake", "bench"):
        raise ValueError(f"Unsupported op {op!r}")
    device = resolve_device(device)
    ctx: Dict[str, Any] = {"P": P, "op": op, "device": device}

    if getattr(P, "checkpoint_path", None):
        P.checkpoint_path = resolve_checkpoint_dir(P.checkpoint_path, logs_root="logs")

    data_path = Path(P.data_path) / "out" / P.data_dirname
    mask_dir = data_path / "masks" / P.mask_dirname
    clustering_params = load_clustering_meta(mask_dir)
    coordinate_info = load_coordinates(data_path)
    global_aabb, expert_aabbs = load_scene_boxes(mask_dir)

    # meters → normalized units, per field: a value restored from a
    # checkpoint's P.json is normalized already
    psf = coordinate_info["pose_scale_factor"]
    if not getattr(P, "near_normalized", 0):
        P.near = P.near / psf if P.near is not None else None
        P.near_normalized = 1
    if not getattr(P, "far_normalized", 0):
        P.far = P.far / psf if P.far is not None else None
        P.far_normalized = 1
    P.near_far_normalized = 1

    cfg = build_model_configs(P, clustering_params)
    occ_cfg = build_occ_config(P, psf)

    # the weights from a CPU generator, then moved: every device gets the
    # same bits
    model = cont.init_container(
        cfg, torch.from_numpy(np.asarray(clustering_params["centroids"], np.float32)),
        torch.from_numpy(expert_aabbs), torch.from_numpy(global_aabb),
        generator=torch.Generator().manual_seed(int(P.seed))).to(device)

    ctx.update(cfg=cfg, occ_cfg=occ_cfg, model=model,
               clustering_params=clustering_params, coordinate_info=coordinate_info,
               global_aabb=global_aabb, expert_aabbs=expert_aabbs, data_path=data_path,
               step=0, best=float("-inf"), occ_states=None)

    # an unreadable checkpoint falls back to the next-older tag
    if getattr(P, "checkpoint_path", None):
        loaded, tag_used = load_checkpoint_with_fallback(P.checkpoint_path, P.prefix)
        if tag_used != P.prefix:
            print(f"[ckpt] '{P.prefix}' unreadable — resumed from '{tag_used}'")
            P.prefix = tag_used  # the optimizer restore reads the same tag
        restored, occ = restore_model(loaded, cfg, device)
        _check_restored(restored, model)
        ctx["model"] = restored
        ctx["step"] = loaded["step"]
        ctx["best"] = loaded["best"]
        if occ is not None and occ_cfg is not None:
            template = init_occ_states(restored.expert_aabbs, occ_cfg)
            if {k: v.shape for k, v in occ.items()} != {k: v.shape for k, v in template.items()}:
                raise ValueError("the checkpoint's occupancy grids do not match the "
                                 "configured grid")
            ctx["occ_states"] = occ
    del model

    logger = Logger(P.fname, rank=int(getattr(P, "rank", 0) or 0))
    ctx["logger"] = logger

    if op == "train":
        world, rank = pmesh.world_rank()
        if world > 1 and rank > 0:  # rank 0 fills the ray and route caches first
            pmesh.host_barrier()
        t0 = time.perf_counter()
        train_sets, val_sets = get_dataset(P, expert_aabbs=expert_aabbs,
                                           global_aabb=global_aabb,
                                           near_far_override=(P.near, P.far))
        t1 = time.perf_counter()
        if len(train_sets) != P.num_submodules:
            raise ValueError(f"expected {P.num_submodules} per-expert train sets, "
                             f"got {len(train_sets)}")
        train_samplers = [
            TaskSampler(ds, expert_aabbs[i], P.cell_dim, P.support_rays, P.query_rays,
                        seed=P.seed + i, route_cache=tasks.ROUTE_CACHE)
            for i, ds in enumerate(train_sets)]
        test_samplers = [
            TaskSampler(ds, expert_aabbs[i], P.cell_dim, P.support_rays, P.query_rays,
                        seed=P.seed + 1000 + i, route_cache=tasks.ROUTE_CACHE)
            for i, ds in enumerate(val_sets)]
        t2 = time.perf_counter()
        ctx["setup_s"] = {"rays": t1 - t0, "route": t2 - t1,
                          "train_rays": [len(ds) for ds in train_sets]}
        logger.log(f"[data] ray stores in {t1 - t0:.1f}s, routed to micro-cells in "
                   f"{t2 - t1:.1f}s")
        if world > 1 and rank == 0:
            pmesh.host_barrier()
        ctx["train_sampler"] = MultiTaskSampler(train_samplers)
        ctx["test_sampler"] = MultiTaskSampler(test_samplers) if test_samplers else None
        ctx["device_pools"] = (None if getattr(P, "no_device_sampling", False)
                               else build_device_pools(train_samplers, seed=P.seed))

        labels = cont.param_group_labels(ctx["model"].params())
        ctx["optimizer"] = build_optimizer(P, labels, grad_clip=P.grad_clip)

        if P.use_occ and ctx["occ_states"] is None:
            # every expert's grid starts with the cells no camera sees
            # marked invisible
            train_md, val_md = get_image_metadata(data_path, P.downscale)
            mds = [m for m in (train_md + val_md) if m is not None]
            ctx["occ_states"] = premark_occ_states(
                occ_cfg, expert_aabbs, [m.intrinsics[:4] for m in mds],
                [m.c2w for m in mds], mds[0].W if mds else 0, mds[0].H if mds else 0,
                near_plane=P.near if P.near is not None else 1e-3, device=device)
            logger.log("[OCC] premarked invisible cells for all experts")
        ctx["mesh"] = pmesh.make_mesh(P.num_submodules, P.mesh_experts, P.mesh_data)

    elif op in ("eval", "video"):
        if not getattr(P, "checkpoint_path", None):
            raise ValueError(f"--checkpoint_path is required when --op {op}")
        _, test_meta = get_image_metadata(data_path, P.downscale)
        if P.cap_images is not None:
            test_meta = cap_metadata(test_meta, P.cap_images)
        ctx["test_metadata"] = test_meta

    elif not getattr(P, "checkpoint_path", None):  # view, bake, bench: the model only
        raise ValueError(f"--checkpoint_path is required when --op {op}")

    return ctx


def premark_occ_states(occ_cfg: OccConfig, expert_aabbs, intrinsics, c2w,
                       width: int, height: int, near_plane: float,
                       device=None) -> Dict[str, torch.Tensor]:
    """Stacked (K, ...) fresh occupancy states, each over its expert's AABB,
    with the cells outside every camera's frustum marked invisible.

    ``intrinsics`` (C, 4) = (fx, fy, cx, cy) and ``c2w`` (C, 3, 4) RUB
    camera-to-world matrices of all the run's cameras (train and val), all
    ``width`` × ``height`` pixels; C = 0 gives the fresh states. The RUB
    poses are turned into RDF ones (the y and z columns negated) as
    ``acn_tpu`` does, on the host in float32. ``device=None`` is the card."""
    device = resolve_device(device)
    aabbs = torch.as_tensor(np.asarray(expert_aabbs, np.float32), device=device)
    intr = np.asarray(intrinsics, np.float32).reshape(-1, 4)
    if len(intr) == 0:
        return init_occ_states(aabbs, occ_cfg)
    fx, fy, cx, cy = (intr[:, i] for i in range(4))
    zero, one = np.zeros_like(fx), np.ones_like(fx)
    K_mats = np.stack([np.stack([fx, zero, cx], -1), np.stack([zero, fy, cy], -1),
                       np.stack([zero, zero, one], -1)], 1)
    C3 = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    c2w = np.asarray(c2w, np.float32)
    c2w_rdf = np.concatenate([c2w[:, :, :3] @ C3, c2w[:, :, 3:]], axis=2)
    K_t = torch.from_numpy(K_mats).to(device)
    c2w_t = torch.from_numpy(c2w_rdf).to(device)
    states = [occ_grid.mark_invisible_cells(occ_grid.init_occ_state(ab, occ_cfg), K_t, c2w_t,
                                            int(width), int(height), float(near_plane),
                                            occ_cfg)
              for ab in aabbs]
    return {name: torch.stack([s[name] for s in states]) for name in states[0]}


# ----------------------------------------------------------------- ops


def op_train(ctx) -> Dict[str, Any]:
    """Meta-train from the context's step; returns ``meta_trainer``'s final
    state, with the set-up's seconds (``setup_s``: ray stores, routing, and
    each expert's train rays)."""
    from acn_tpu_torch.pipelines.offline_stage.trainer import meta_trainer

    P = ctx["P"]
    logger = ctx["logger"]
    logger.log(str(vars(P)))

    optimizer = ctx["optimizer"]
    opt_state = optimizer.init(ctx["model"].params())
    if getattr(P, "checkpoint_path", None):
        opt_state = load_opt_state(P.checkpoint_path, P.prefix, opt_state, optimizer)

    state = {"model": ctx["model"], "opt_state": opt_state, "step": ctx["step"]}
    out = meta_trainer(
        P, ctx["cfg"], state, optimizer, ctx["train_sampler"], ctx["test_sampler"], logger,
        occ_cfg=ctx["occ_cfg"], occ_states=ctx["occ_states"], mesh=ctx["mesh"],
        start_step=ctx["step"], best=ctx["best"], device_pools=ctx.get("device_pools"),
        device=ctx["device"])
    logger.close()
    out["setup_s"] = ctx.get("setup_s")
    return out


def op_eval(ctx) -> list:
    """The TTO sweep: ``runtime_evaluate`` at each ``--tto`` setting (a
    comma list), each from the checkpoint's weights, then the summary
    table; returns each setting's result."""
    from acn_tpu_torch.pipelines.online_stage.runtime_adapt import runtime_evaluate

    P = ctx["P"]
    if getattr(P, "baked_asset", None):
        # the baked table scored under the eval protocol; budget 0 (the
        # default) is the unbiased strided march, > 0 the packed one
        from acn_tpu_torch.pipelines.baking import BakedRenderer, load_baked

        ctx["baked_renderer"] = BakedRenderer(
            load_baked(P.baked_asset, device=ctx["device"]),
            budget_per_ray=int(getattr(P, "occ_budget_per_ray", 0) or 0),
            s_max=int(getattr(P, "occ_render_s_max", 0) or 128),
            chunk_points=int(P.chunk_points), bg_color=P.bg_color_default,
            s_coarse=int(getattr(P, "occ_render_s_coarse", 0) or 0))
    model = ctx["model"]
    # TTO updates the model in place: every setting starts from a copy of
    # the checkpoint's weights
    base = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tto_list = [int(t) for t in str(P.tto).split(",")]
    results = []
    for tto in tto_list:
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(base[k])
        res = runtime_evaluate(ctx, tto=tto)
        results.append({"tto": tto, **res})
        scalars = {k: v for k, v in res.items() if k not in ("views", "tto_losses")}
        ctx["logger"].log(f"[eval tto={tto}] {scalars}")
    hdr = f"{'tto':>6} {'psnr':>8} {'ssim':>8} {'lpips':>8} {'duration':>9}"
    ctx["logger"].log(hdr)
    for r in results:
        ctx["logger"].log(
            f"{r['tto']:>6} {r['psnr']:>8.3f} {r['ssim']:>8.4f} {r['lpips']:>8.4f} "
            f"{r['duration']:>9.2f}")
    try:  # pandas may be absent
        import pandas as pd

        df = pd.DataFrame([{k: r[k] for k in ("tto", "psnr", "ssim", "lpips", "duration",
                                              "n_views")} for r in results]).set_index("tto")
        ctx["logger"].log("\n" + df.to_latex(float_format="%.4f"))
    except ImportError:
        pass
    return results


def op_video(ctx) -> str:
    """``--video_frames`` (default 120) frames along ``--camera_path``;
    returns the video's path."""
    from acn_tpu_torch.pipelines.video_gen import render_video

    n = int(getattr(ctx["P"], "video_frames", 0) or 120)
    return render_video(ctx, n_poses=n)


def op_view(ctx):
    """The interactive viewer (needs viser) until ``--viewer_timeout``."""
    from acn_tpu_torch.viewer.viewer import launch_viewer

    return launch_viewer(ctx)


def op_bake(ctx) -> str:
    """Distill the restored field into a baked serving asset,
    ``baked_<R>.npz`` in the run's log directory, for ``--op video
    --baked_asset`` and ``--op eval --baked_asset``; returns its path."""
    from acn_tpu_torch.pipelines.baking import bake_container, save_baked

    P, logger = ctx["P"], ctx["logger"]
    R = int(P.bake_resolution)
    t0 = time.time()
    baked = bake_container(
        ctx["model"], aabb=np.asarray(ctx["global_aabb"]), resolution=R,
        bake_dirs=int(P.bake_dirs), sh_degree=int(getattr(P, "bake_sh", 0)),
        supersample=int(getattr(P, "bake_supersample", 1)))
    occ_frac = float(baked["occ_state"]["binaries"].float().mean())
    out = Path(logger.logdir) / f"baked_{R}.npz"
    save_baked(out, baked)
    table_mb = baked["table"].numel() * baked["table"].element_size() / 2**20
    logger.log(f"[bake] {R}^3 table ({table_mb:.0f} MB, {occ_frac:.1%} cells occupied) "
               f"in {time.time() - t0:.1f}s → {out}")
    return str(out)


def main(argv=None, device=None):
    """Parse the flags (``argv``, else the command line) and run the op on
    ``device`` (``None``: the card; over several processes this rank's
    card). Returns the op's result (None on a rank above 0 of an op other
    than ``train``)."""
    import faulthandler
    import signal

    # live stack dumps on SIGUSR1
    try:
        faulthandler.register(signal.SIGUSR1)
    except (AttributeError, ValueError):
        pass

    P = parse_args(argv)
    # the process group before any use of the card
    started = pmesh.maybe_init_distributed(
        P, device, timeout_s=max(pmesh.DEFAULT_TIMEOUT_S,
                                 float(getattr(P, "startup_timeout", 2400) or 0)))
    try:
        if started:
            P.rank = pmesh.world_rank()[1]
            device = pmesh.rank_device(device)
            if P.op != "train":  # rank 0 serves alone: every rank leaves the group
                # once all have joined: a rank that leaves while another is
                # still connecting to it fails that one's join
                pmesh.host_barrier()
                pmesh.shutdown()
                started = False
                if P.rank > 0:
                    return None
        # the whole set-up (restore, ray building, routing, pools) is
        # bounded; training hands over to the loop's own watchdog
        startup.arm(float(getattr(P, "startup_timeout", 2400) or 0),
                    what=f"op={P.op} startup (restore/data)")
        ctx = build_context(P, P.op, device=device)
        if P.op == "train":
            return op_train(ctx)
        startup.mark_ready()
        if P.op == "eval":
            return op_eval(ctx)
        if P.op == "video":
            return op_video(ctx)
        if P.op == "view":
            return op_view(ctx)
        if P.op == "bake":
            return op_bake(ctx)
        raise ValueError(P.op)
    finally:
        if started:
            pmesh.shutdown()
