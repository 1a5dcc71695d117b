"""The synthetic serving scene and training batch, built without JAX.

The model is ``configs/train_occ.json`` as ``acn_tpu``'s runner resolves it
(``runner.build_model_configs`` / ``build_occ_config`` with the config
defaults): 4 NGP experts, a cell-layout hash grid of 8 levels × 4 features
with 2^(20−3) rows and dense coarse levels (min res 16, max res 4096),
64-wide σ and color MLPs (σ depth 2, color depth 2), SH-4 directions and an
SH-4 → 32 → 3 background MLP; boundary margin 1.05, 2-D clustering; an
occupancy grid of 128³ × 1 level with alpha threshold 1e-2, rebuilt every 16
steps by an EMA update (decay 0.95, threshold 1e-2) after a stratified
warm-up of 256 steps; 64 kept samples per ray in the strided march and a
packed budget of 32 per ray over 256 bins, switched to automatically once
the would-be overflow stays at or under 2 % for 3 readings; 4,000,000 chunk
points. Training:
FoMAML with 8 inner steps at rate 0.015, bf16 compute (``use_amp``), Adam
with per-group rates decayed tenfold over 10,000 steps, the global-norm clip
at 1 and the non-finite guard; 3 tasks per expert of 1,024 support and 512
query rays.

``camera_ray_stores`` is a synthetic dataset over the quadrant scene: per
expert, pinhole cameras looking down on its quadrant, all their pixels' rays
(with near and far from the expert's box) in a ray store, colored by a
pattern of the point where each ray leaves the box.

``bench_problem`` is the model of the JAX package's step benchmark
(``bench.py``, through ``__graft_entry__._toy_problem``): K experts over
the same [-1, 1]³ box, a cell-layout hash grid of 8 levels × 4 features
with 2^16 rows (max res 1024), 64-wide MLPs; ``bench_params`` its P and
``bench_occ_config`` its occupancy grid.

The scene is the one the JAX package's render benchmark builds
(``acn_tpu/scripts/bench_render.py``): the [-1, 1]³ box cut into four
quadrant expert AABBs with ~10 % overlap, centroids at (0, ±0.55, ±0.55),
per-expert random occupancy at a 10 % fill, and an overhead camera. Weights
are random, drawn from a seed. The training batch is the synthetic one of
the JAX package's step benchmark (``bench.py``): rays from z = 2 down
through the box, random colors.
"""

from __future__ import annotations

import types
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from acn_tpu_torch.models.container import (
    Container,
    ContainerConfig,
    init_container,
    param_group_labels,
)
from acn_tpu_torch.models.encodings import HashGridConfig
from acn_tpu_torch.models.ngp import NGPConfig
from acn_tpu_torch.models.nn import norm3, tree_map
from acn_tpu_torch.nerfs import rays as raylib
from acn_tpu_torch.occupancy.grid import OccConfig, init_occ_state
from acn_tpu_torch.utils.optim import Optimizer, build_optimizer

SCENE_AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)


def train_occ_config() -> Tuple[ContainerConfig, types.SimpleNamespace, OccConfig]:
    """(model config, render params P, occupancy config) of
    ``configs/train_occ.json``."""
    cfg = ContainerConfig(
        num_submodules=4,
        boundary_margin=1.05,
        cluster_2d=True,
        use_bg_nerf=True,
        bg_hidden=32,
        expert=NGPConfig(
            hidden=64, sigma_depth=2, color_hidden=64, color_depth=2,
            geo_feat_dim=15,
            hash=HashGridConfig(levels=8, min_res=16, max_res=4096,
                                log2_hashmap_size=20 - 3, features_per_level=4,
                                layout="cell", dense_levels=True),
        ),
    )
    P = types.SimpleNamespace(
        ray_samples=96, chunk_points=4_000_000, bg_color_default="random",
        occ_s_max=256, occ_s_kept=64, occ_budget_per_ray=32,
        occ_render_s_max=0,
        # training (configs/train_occ.json over the config defaults)
        algo="fomaml", inner_iter=8, inner_lr=0.015, use_amp=True,
        color_space="linear", train_chunk_rays=0, fim=False,
        batch_size=3, support_rays=1024, query_rays=512,
        optimizer="adam", encoding_lr=1e-2, sigma_lr=2e-3, color_lr=2e-3,
        bg_lr=1e-3, lr=1e-4, outer_steps=10_000, decay_factor=10.0,
        no_scheduler=False, grad_clip=1.0, guard_nonfinite=1,
        # the regime schedule: stratified for occ_warmup steps, then strided
        # with the would-be overflow measured until the auto switch
        occ_warmup=256, occ_regime="auto", occ_auto_thresh=0.02,
        occ_auto_patience=3,
        # the loop (meta_trainer) and its data
        seed=0, cell_dim=5, test_batch_size=1, max_test_tasks=4, eval_step=200,
        eval_render="stratified", save_step=500, save_optimizer=1, print_step=20,
        watchdog_timeout=900, profile_at=0, profile_steps=3, near=0.0,
    )
    occ_cfg = OccConfig(resolution=128, levels=1, occ_thre=1e-2, ema_decay=0.95,
                        warmup_steps=256, update_interval=16, alpha_thre=1e-2,
                        alpha_thre_start=0.0, cosine_anneal=True,
                        cone_angle=0.004, near_plane=0.0, far_plane=100000.0)
    return cfg, P, occ_cfg


def quadrant_layout(K: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """(expert AABBs (K, 2, 3), centroids (K, 3)) of the 2×2 city grid."""
    assert K == 4, "the quadrant layout has 4 experts"
    quad, cents = [], []
    for iy in (-1, 1):
        for iz in (-1, 1):
            lo = [-1.0, min(0.1 * iy, float(iy)), min(0.1 * iz, float(iz))]
            hi = [1.0, max(0.1 * iy, float(iy)), max(0.1 * iz, float(iz))]
            quad.append([lo, hi])
            cents.append([0.0, 0.55 * iy, 0.55 * iz])
    return np.asarray(quad, np.float32), np.asarray(cents, np.float32)


def random_occ_states(expert_aabbs: np.ndarray, occ_cfg: OccConfig,
                      fill: float = 0.10, seed: int = 0,
                      device=None) -> Dict[str, torch.Tensor]:
    """Stacked (K, ...) occupancy states, each expert's cells occupied at
    random with probability ``fill`` (numpy seed), over the scene box."""
    rng = np.random.default_rng(seed)
    K, L, R = expert_aabbs.shape[0], occ_cfg.levels, occ_cfg.resolution
    base = init_occ_state(torch.from_numpy(SCENE_AABB), occ_cfg)
    bins = rng.random((K, L, R, R, R), dtype=np.float32) < fill
    return {
        "occs": base["occs"].expand(K, *base["occs"].shape).clone().to(device),
        "binaries": torch.from_numpy(bins).to(device),
        "aabbs": base["aabbs"].expand(K, *base["aabbs"].shape).clone().to(device),
    }


def serving_model(cfg: ContainerConfig, seed: int = 0, device=None) -> Container:
    """Random weights (CPU generator from ``seed``, then moved, so every
    device gets the same bits) over the quadrant layout."""
    boxes, cents = quadrant_layout(cfg.num_submodules)
    gen = torch.Generator().manual_seed(seed)
    model = init_container(cfg, torch.from_numpy(cents), torch.from_numpy(boxes),
                           torch.from_numpy(SCENE_AABB), generator=gen)
    return model.to(device)


def overhead_camera(H: int, W: int, lift: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Camera looking down (+x is Down in DRB) from ``lift`` above the scene
    box's top face (default: half its largest extent, where the quadrant
    experts' rects each crop about a third of the frame; from 3 the box
    fills the middle of the frame and the sky is around it): {c2w (3, 4),
    intrinsics (4,), aabb (2, 3)}."""
    lo, hi = SCENE_AABB
    c = 0.5 * (lo + hi)
    cam_x = float(lo[0] - (0.5 * (hi - lo).max() if lift is None else lift))
    c2w = np.array([[0.0, 0.0, -1.0, cam_x],
                    [0.0, 1.0, 0.0, float(c[1])],
                    [1.0, 0.0, 0.0, float(c[2])]], np.float32)
    fy = 0.7 * H
    intr = np.array([fy, fy, W / 2, H / 2], np.float32)
    return {"c2w": c2w, "intrinsics": intr, "aabb": SCENE_AABB.copy()}


def identical_experts(model: Container) -> Container:
    """A copy of ``model`` whose every expert has expert 0's weights and the
    scene's global box: the soft-MoE blend is then expert 0's field
    everywhere, and a routed frame (given the true boxes for its rects)
    reproduces the dense one."""
    K = model.cfg.num_submodules
    params = model.params()
    with torch.no_grad():
        experts = tree_map(lambda t: t[:1].expand_as(t).clone(), params["experts"])
        bg = tree_map(lambda t: t.clone(), params["bg_mlp"]) if "bg_mlp" in params else None
    return Container(model.cfg, experts, bg, model.centroids.clone(),
                     model.global_aabb[None].expand(K, 2, 3).clone(),
                     model.global_aabb.clone())


def identical_occ(occ_states: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Stacked occupancy states whose every expert holds expert 0's grid."""
    return {k: v[:1].expand_as(v).clone() for k, v in occ_states.items()}


def training_batch(K: int, T: int, S: int, Q: int,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """The synthetic episode batch of ``bench.py``: for every expert and
    task, S support and Q query rays (o, d, near, far) that start on the
    plane z = 2 within |x|, |y| < 0.5 and point down (d_z ≤ −0.5 before
    normalization) over [1, 3], with uniform random colors.
    {support_rays (K, T, S, 8), support_rgbs (K, T, S, 3), query_rays,
    query_rgbs}, float32."""
    rng = np.random.default_rng(seed)
    n = S + Q
    o = np.concatenate(
        [rng.uniform(-0.5, 0.5, (K, T, n, 2)).astype(np.float32),
         np.full((K, T, n, 1), 2.0, np.float32)], axis=-1)
    d = rng.normal(size=(K, T, n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[..., 2] = -np.abs(d[..., 2]) - 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nf = np.concatenate([np.full((K, T, n, 1), 1.0, np.float32),
                         np.full((K, T, n, 1), 3.0, np.float32)], axis=-1)
    rays = np.concatenate([o, d, nf], axis=-1)
    rgbs = rng.uniform(0, 1, (K, T, n, 3)).astype(np.float32)
    return {"support_rays": rays[:, :, :S], "support_rgbs": rgbs[:, :, :S],
            "query_rays": rays[:, :, S:], "query_rgbs": rgbs[:, :, S:]}


def init_train_state(model: Container, P) -> Tuple[Optimizer, Dict[str, Any]]:
    """(optimizer, fresh training state {"model", "opt_state", "step"}) for
    ``make_meta_train_step``: per-group Adam over the model's parameters with
    P's rates, clip and guard."""
    params = model.params()
    opt = build_optimizer(P, param_group_labels(params),
                          grad_clip=getattr(P, "grad_clip", 1.0))
    return opt, {"model": model, "opt_state": opt.init(params), "step": 0}


def bench_problem(K: int = 4, seed: int = 0, device=None) -> Container:
    """``__graft_entry__._toy_problem``'s model: K experts, each over the
    whole [-1, 1]³ box, centroids on a √K × √K grid in the y-z plane,
    boundary margin 1.1, background MLP; random weights (CPU generator from
    ``seed``, then moved)."""
    cfg = ContainerConfig(
        num_submodules=K, boundary_margin=1.1, cluster_2d=True, use_bg_nerf=True,
        expert=NGPConfig(hidden=64, color_hidden=64, hash=HashGridConfig(
            levels=8, min_res=16, max_res=1024, log2_hashmap_size=16, layout="cell",
            features_per_level=4, dense_levels=True)))
    side = int(np.ceil(np.sqrt(K)))
    cents = np.asarray([[0.0, -0.5 + (k // side) / max(side - 1, 1),
                         -0.5 + (k % side) / max(side - 1, 1)] for k in range(K)],
                       np.float32)
    boxes = np.stack([SCENE_AABB] * K)
    gen = torch.Generator().manual_seed(seed)
    return init_container(cfg, torch.from_numpy(cents), torch.from_numpy(boxes),
                          torch.from_numpy(SCENE_AABB), generator=gen).to(device)


def bench_params(inner_iter: int = 8, **over) -> types.SimpleNamespace:
    """``bench.py``'s P (its optimizer, inner loop, 96 stratified samples,
    256 bins → 64 kept, bf16, white background), with ``over`` on top."""
    return types.SimpleNamespace(**{**dict(
        algo="fomaml", inner_iter=inner_iter, inner_lr=0.015, ray_samples=96,
        color_space="linear", bg_color_default="white", optimizer="adam",
        encoding_lr=1e-2, sigma_lr=2e-3, color_lr=2e-3, bg_lr=1e-3, lr=1e-4,
        outer_steps=10_000, decay_factor=10.0, no_scheduler=False, grad_clip=1.0,
        occ_s_max=256, occ_s_kept=64, use_amp=True, train_chunk_rays=0, fim=False,
        occ_budget_per_ray=0), **over})


def bench_occ_config() -> OccConfig:
    """``bench.py``'s occupancy grid: 128³, one level, near 1e-3, far 1e3."""
    return OccConfig(resolution=128, levels=1, near_plane=1e-3, far_plane=1e3)


def camera_ray_stores(K: int = 4, cams: int = 32, H: int = 192, W: int = 256,
                      seed: int = 0, device=None) -> Dict[str, Any]:
    """A synthetic dataset of the quadrant scene: per expert, ``cams``
    pinhole cameras (focal length W) half a unit above its box's top face
    (x = −1; x is Down), looking straight down, each turned by a random angle
    about the vertical and placed at random over the quadrant so that its
    whole image sees the box; every pixel's ray (``nerfs.rays.get_rays``,
    near and far from the expert's box) goes into the expert's store. A
    ray's color is a pattern of the point where it leaves the box.

    Returns {"stores": K × (rays (N, 8), rgbs (N, 3), image ids (N,)) numpy
    with N = cams·H·W, "intrinsics" (K·cams, 4) (fx, fy, cx, cy), "c2w"
    (K·cams, 3, 4) RUB camera-to-world, "H", "W"}. The rays are made on
    ``device`` (None: the card), one camera at a time."""
    from acn_tpu_torch.pipelines.renderer import resolve_device

    device = resolve_device(device)
    boxes, _ = quadrant_layout(K)
    rng = np.random.default_rng(seed)
    f = float(W)
    j = torch.arange(H, dtype=torch.float32, device=device)[:, None] + 0.5
    i = torch.arange(W, dtype=torch.float32, device=device)[None, :] + 0.5
    dirs = torch.stack([(i - W / 2).expand(H, W) / f, -(j - H / 2).expand(H, W) / f,
                        -torch.ones((H, W), device=device)], dim=-1)
    dirs = dirs / norm3(dirs)
    reach = 0.5 * float(np.hypot(W / 2, H / 2)) / f  # footprint radius on the top face
    stores, intr, poses = [], [], []
    for k in range(K):
        lo, hi = boxes[k]
        box = torch.from_numpy(boxes[k]).to(device)
        rays_k = []
        for _ in range(cams):
            a = rng.uniform(0, 2 * np.pi)
            right = np.array([0.0, np.sin(a), np.cos(a)])
            up = np.array([0.0, np.cos(a), -np.sin(a)])
            pos = [lo[0] - 0.5, rng.uniform(lo[1] + reach, hi[1] - reach),
                   rng.uniform(lo[2] + reach, hi[2] - reach)]
            c2w = np.stack([right, up, np.cross(right, up), pos], 1).astype(np.float32)
            rays_k.append(raylib.get_rays(dirs, torch.from_numpy(c2w).to(device),
                                          aabb=box).reshape(-1, 8).cpu().numpy())
            intr.append([f, f, W / 2, H / 2])
            poses.append(c2w)
        rays = np.concatenate(rays_k)
        exit_pt = rays[:, :3] + rays[:, 7:8] * rays[:, 3:6]
        y, z = exit_pt[:, 1], exit_pt[:, 2]
        rgbs = 0.5 + 0.5 * np.stack([np.sin(7 * y), np.sin(5 * z + 1),
                                     np.sin(3 * (y + z) + 2)], 1)
        img = np.repeat(np.arange(cams, dtype=np.int32), H * W)
        stores.append((rays, rgbs.astype(np.float32), img))
    return {"stores": stores, "intrinsics": np.asarray(intr, np.float32),
            "c2w": np.stack(poses), "H": H, "W": W}


def expert_layout(K: int) -> Tuple[np.ndarray, np.ndarray]:
    """(expert AABBs (K, 2, 3), centroids (K, 3)): the 2×2 quadrants for
    K = 4, two halves of the y axis (the same ~10 % overlap) for K = 2."""
    if K == 4:
        return quadrant_layout(K)
    assert K == 2, "the layouts have 2 or 4 experts"
    boxes = np.asarray([[[-1.0, -1.0, -1.0], [1.0, 0.1, 1.0]],
                        [[-1.0, -0.1, -1.0], [1.0, 1.0, 1.0]]], np.float32)
    return boxes, np.asarray([[0.0, -0.55, 0.0], [0.0, 0.55, 0.0]], np.float32)


def _zip_mask(path, mask_hw: np.ndarray) -> None:
    """A zipped ``torch.save`` of a boolean (H, W) mask, the prepared
    datasets' format (``acn_tpu/scripts/create_clusters.py``)."""
    import io
    import zipfile

    buf = io.BytesIO()
    torch.save(torch.from_numpy(np.ascontiguousarray(mask_hw)), buf)
    info = zipfile.ZipInfo(path.stem + ".inner.pt", date_time=(1980, 1, 1, 0, 0, 0))
    info.compress_type = zipfile.ZIP_DEFLATED
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(info, buf.getvalue())


def write_dataset_dir(root, K: int = 4, train_cams: int = 32, val_cams: int = 8,
                      H: int = 192, W: int = 256, downscale: float = 0.25, seed: int = 0,
                      dirname: str = "example",
                      mask_dirname: str = "g22_grid_bm110_ss11") -> Path:
    """Write a prepared dataset of the layout scene in the layout that
    ``data/dataset.py`` reads, under ``<root>/out/<dirname>``; returns that
    directory. Run the runner on it with ``--data_path <root>`` (and
    ``--num_submodules K``, ``--downscale downscale``).

    * ``coordinates.pt``: origin 0, pose scale factor 1;
    * ``{train,val}/metadata/<name>.pt``: {c2w (3, 4) RUB camera-to-world,
      W, H, intrinsics (fx, fy, cx, cy)}, the size and intrinsics at full
      resolution (1/``downscale`` times the images'), so that the loaders
      scale them back to the PNGs' size and need no resize;
    * ``{train,val}/rgbs/<name>.png`` (H × W), written by the port's codec
      with the five row filters in turn (row r with filter r mod 5), so
      that reading them takes every path of the decoder;
    * ``masks/<mask_dirname>/{params.pt, scene_boxes.pt}`` and per expert
      ``<k>/<name>.pt``: a zipped boolean mask of the pixels whose ray
      leaves the scene box inside the expert's box in y and z.

    The cameras are ``camera_ray_stores``'s: above the top face (x = −1;
    x is Down), looking straight down, each turned by a random angle about
    the vertical and placed at random over one expert's region (image i
    over expert i mod K); a pixel's colour is a pattern of the point where
    its ray leaves the scene box. Everything is drawn from ``seed``."""
    from acn_tpu_torch.data.png import write_png
    from acn_tpu_torch.data.ray_prep import get_ray_directions_np, get_rays_np

    root = Path(root)
    data = root / "out" / dirname
    masks = data / "masks" / mask_dirname
    for d in [*(data / sp / sub for sp in ("train", "val") for sub in ("metadata", "rgbs")),
              *(masks / str(k) for k in range(K))]:
        d.mkdir(parents=True, exist_ok=True)
    boxes, cents = expert_layout(K)
    torch.save({"origin_drb": torch.zeros(3), "pose_scale_factor": 1.0},
               data / "coordinates.pt")
    torch.save({"format_version": 3, "centroids": torch.from_numpy(cents),
                "grid_dim": (1, 2, K // 2), "cluster_2d": True, "boundary_margin": 1.1,
                "aabb_global": torch.from_numpy(SCENE_AABB)}, masks / "params.pt")
    torch.save({"aabb_global": torch.from_numpy(SCENE_AABB),
                "mins": torch.from_numpy(boxes[:, 0].copy()),
                "maxs": torch.from_numpy(boxes[:, 1].copy())}, masks / "scene_boxes.pt")

    rng = np.random.default_rng(seed)
    f = float(W)
    dirs = get_ray_directions_np(H, W, f, f, W / 2, H / 2)
    reach = 0.5 * float(np.hypot(W / 2, H / 2)) / f  # footprint radius on the top face
    scale = 1.0 / downscale
    for i in range(train_cams + val_cams):
        split = "train" if i < train_cams else "val"
        lo, hi = boxes[i % K]
        a = rng.uniform(0, 2 * np.pi)
        right = np.array([0.0, np.sin(a), np.cos(a)])
        up = np.array([0.0, np.cos(a), -np.sin(a)])
        pos = [SCENE_AABB[0, 0] - 0.5, rng.uniform(lo[1] + reach, hi[1] - reach),
               rng.uniform(lo[2] + reach, hi[2] - reach)]
        c2w = np.stack([right, up, np.cross(right, up), pos], 1).astype(np.float32)
        rays = get_rays_np(dirs, c2w, aabb=SCENE_AABB).reshape(-1, 8)
        exit_pt = rays[:, :3] + rays[:, 7:8] * rays[:, 3:6]
        y, z = exit_pt[:, 1], exit_pt[:, 2]
        rgb = 0.5 + 0.5 * np.stack([np.sin(7 * y), np.sin(5 * z + 1),
                                    np.sin(3 * (y + z) + 2)], 1)
        name = f"{i:06d}"
        write_png(data / split / "rgbs" / f"{name}.png",
                  np.round(rgb * 255).astype(np.uint8).reshape(H, W, 3),
                  filter_type=np.arange(H) % 5)
        torch.save({"c2w": torch.from_numpy(c2w), "W": int(round(W * scale)),
                    "H": int(round(H * scale)),
                    "intrinsics": torch.tensor([f * scale, f * scale, W / 2 * scale,
                                                H / 2 * scale])},
                   data / split / "metadata" / f"{name}.pt")
        for k in range(K):
            inside = ((y >= boxes[k, 0, 1]) & (y <= boxes[k, 1, 1])
                      & (z >= boxes[k, 0, 2]) & (z <= boxes[k, 1, 2]))
            _zip_mask(masks / str(k) / f"{name}.pt", inside.reshape(H, W))
    return data
