"""Expert partitioning: Mega-NeRF-style Voronoi cluster masks and per-expert
scene boxes.

    python -m acn_tpu_torch.scripts.create_clusters --data_path <prepared set>
        --output g22_grid_bm110_ss11 --grid_dim 2 2 --cluster_2d
        --boundary_margin 1.1 --ray_samples 256 --center_pixels
        --scene_scale 1.1 [--rank R --world_size W] [--resume] [--device cpu]

Port of ``acn_tpu/scripts/create_clusters.py`` with the same flags (plus
``--device``) and the same outputs, byte for byte where the routing agrees:

* the global scene box: ``scene_scale`` in Y/Z, the altitude band in X
  (Down; from ``coordinates.pt``'s ``altitude_range_enu`` unless
  ``--altitude_range`` is given) plus ``--altitude_pad``;
* centroids on a uniform grid (2-D YZ tiles or 3-D) or by weighted
  k-means++ over the camera positions (numpy, copied);
* per image, S samples on every pixel ray's [near, far]; the ray belongs to
  expert c iff one of its samples x has d(x, c)² ≤ m²·min_c' d(x, c')² (the
  nearest centroid alone, by argmin, at margin m = 1);
* per expert, the min, max and count of its samples, clamped to the global
  box, ε-boxes for empty experts, an optional dilation, altitude global;
* zipped per-expert boolean pixel masks (member timestamp pinned, so the
  bytes depend only on the mask), ``params.pt``, ``scene_boxes.pt`` and
  ``scene_boxes.txt``.

The routing runs on the card (``make_voronoi_kernel``): an image's rays are
copied there once, each chunk of ``--ray_chunk_size`` rays is routed by
dense tensor ops (d² by ``x² + c² − 2·x·cᵀ``, masked min/max reductions) into
an image-sized mask and running boxes that stay on the card, and the host
reads them once per image. Ray generation (numpy) and the zipping are host
work, as in ``acn_tpu``.

Host shards: N processes with ``--rank/--world_size`` (or ``RANK`` /
``WORLD_SIZE``) take images i with i % N == rank, write their masks
directly and their partial boxes and statistics to
``<out>/_partials/rank{r}of{N}.npz``; rank 0 waits for every partial whose
modification time is at most 300 s older than its own start, reduces them
(min, max, sum) and writes the boxes. A partial left by a crashed run
less than 300 s before is merged too: ``acn_tpu``'s behavior, kept.
"""

from __future__ import annotations

import argparse
import io
import os
import time
import zipfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

PARTIAL_SLACK_S = 300.0  # a partial may predate rank 0's start by this much


# ------------------------- centroids -------------------------


def grid_centroids(
    cam_pos: np.ndarray, gx: int, gy: int, gz: int, cluster_2d: bool
) -> np.ndarray:
    """Uniform tile centers over the camera bbox."""
    if cam_pos.size == 0:
        C = (gy * gz) if cluster_2d else (gx * gy * gz)
        return np.zeros((C, 3), np.float32)
    minp, maxp = cam_pos.min(0), cam_pos.max(0)
    if cluster_2d:
        x_c = 0.5 * (minp[0] + maxp[0])
        Y = minp[1] + (np.arange(gy) + 0.5) * (maxp[1] - minp[1]) / gy
        Z = minp[2] + (np.arange(gz) + 0.5) * (maxp[2] - minp[2]) / gz
        YY, ZZ = np.meshgrid(Y, Z, indexing="ij")
        X = np.full_like(YY, x_c)
        return np.stack([X, YY, ZZ], -1).reshape(-1, 3).astype(np.float32)
    X = minp[0] + (np.arange(gx) + 0.5) * (maxp[0] - minp[0]) / max(gx, 1)
    Y = minp[1] + (np.arange(gy) + 0.5) * (maxp[1] - minp[1]) / max(gy, 1)
    Z = minp[2] + (np.arange(gz) + 0.5) * (maxp[2] - minp[2]) / max(gz, 1)
    XX, YY, ZZ = np.meshgrid(X, Y, Z, indexing="ij")
    return np.stack([XX, YY, ZZ], -1).reshape(-1, 3).astype(np.float32)


def kmeans_plusplus(
    points: np.ndarray,
    K: int,
    iters: int = 25,
    seed: int = 0,
    weights: Optional[np.ndarray] = None,
    init: str = "kmeans++",
) -> np.ndarray:
    """Weighted k-means with k-means++ (or random) initialization."""
    rng = np.random.default_rng(seed)
    n = len(points)
    w = weights if weights is not None else np.ones(n)

    if init == "random":
        centers = points[rng.permutation(n)[:K]].copy()
    else:
        centers = np.empty((K, points.shape[1]), points.dtype)
        p = w / w.sum()
        centers[0] = points[rng.choice(n, p=p)]
        for k in range(1, K):
            d2 = np.min(
                ((points[:, None, :] - centers[None, :k, :]) ** 2).sum(-1), axis=1
            )
            probs = np.maximum(d2 * w, 1e-12)
            centers[k] = points[rng.choice(n, p=probs / probs.sum())]

    for _ in range(max(1, iters)):
        d2 = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        a = d2.argmin(1)
        for k in range(K):
            m = a == k
            if not m.any():
                centers[k] = points[d2[:, k].argmax()]
            else:
                centers[k] = (w[m, None] * points[m]).sum(0) / w[m].sum()
    return centers.astype(np.float32)


# ------------------------- Voronoi routing -------------------------


def make_voronoi_kernel(
    centroids: np.ndarray,  # (C, 3)
    cluster_2d: bool,
    boundary_margin: float,
    ray_samples: int,
    chunk: int = 8192,
    device=None,
):
    """The router of one image's rays on ``device`` (None: the card).

    Returns ``route(rays (n, 8) numpy or tensor)`` → (mask (n, C) bool,
    mins (C, 3), maxs (C, 3), counts (C,) int64), numpy, over all n rays.
    The rays go to the device in one copy; chunks of ``chunk`` rays (the
    tail padded with near 1 > far 0, which assigns nothing) are routed into
    a mask and boxes kept there, read back once."""
    from acn_tpu_torch.occupancy.grid import unit_linspace
    from acn_tpu_torch.pipelines.renderer import resolve_device

    device = resolve_device(device)
    cents = torch.as_tensor(np.asarray(centroids, np.float32), device=device)
    start = 1 if cluster_2d else 0
    csub = cents[:, start:]
    c2 = torch.sum(csub * csub, dim=1)[None, :]  # (1, C)
    m2 = float(boundary_margin) ** 2
    S = int(ray_samples)
    C = len(centroids)
    z = unit_linspace(S, device)  # jnp.linspace(0, 1, S)'s bits
    cell = torch.arange(C, device=device)

    def route_chunk(rays):
        o, d = rays[:, :3], rays[:, 3:6]
        near, far = rays[:, 6], rays[:, 7]
        valid = torch.isfinite(near) & torch.isfinite(far) & (far > near)
        t = near[:, None] * (1 - z) + far[:, None] * z  # (R, S)
        x = o[:, None, :] + d[:, None, :] * t[..., None]  # (R, S, 3)
        flat = x[..., start:].reshape(-1, 3 - start)
        x2 = torch.sum(flat * flat, dim=1, keepdim=True)
        d2 = torch.clamp_min(x2 + c2 - 2.0 * (flat @ csub.T), 0.0)  # (R·S, C)
        if boundary_margin == 1.0:
            # argmin takes the first of tied cells, as jnp.argmin does
            ok = torch.argmin(d2, dim=1)[:, None] == cell
        else:
            ok = d2 <= m2 * torch.amin(d2, dim=1, keepdim=True)
        ok = ok.reshape(x.shape[0], S, C) & valid[:, None, None]
        okb = ok[..., None]  # (R, S, C, 1)
        xb = x[:, :, None, :]  # (R, S, 1, 3)
        mins = torch.amin(torch.where(okb, xb, float("inf")), dim=(0, 1))  # (C, 3)
        maxs = torch.amax(torch.where(okb, xb, float("-inf")), dim=(0, 1))
        counts = torch.sum(ok, dim=(0, 1), dtype=torch.int64)
        return torch.any(ok, dim=1), mins, maxs, counts

    def route(rays_np):
        n = len(rays_np)
        n_pad = -(-n // chunk) * chunk
        rays = torch.zeros((n_pad, 8), dtype=torch.float32, device=device)
        rays[n:, 6] = 1.0  # near > far ⇒ invalid ⇒ no assignment
        rays[:n] = torch.as_tensor(rays_np, dtype=torch.float32).to(device)
        mask = torch.empty((n_pad, C), dtype=torch.bool, device=device)
        mins = torch.full((C, 3), float("inf"), device=device)
        maxs = torch.full((C, 3), float("-inf"), device=device)
        counts = torch.zeros(C, dtype=torch.int64, device=device)
        for s in range(0, n_pad, chunk):
            m, mn, mx, ct = route_chunk(rays[s:s + chunk])
            mask[s:s + chunk] = m
            mins = torch.minimum(mins, mn)
            maxs = torch.maximum(maxs, mx)
            counts += ct
        return (mask[:n].cpu().numpy(), mins.cpu().numpy(), maxs.cpu().numpy(),
                counts.cpu().numpy())

    return route


# ------------------------- mask IO -------------------------


def save_zip_mask(path: Path, mask_hw: np.ndarray) -> None:
    """Zipped torch-saved boolean mask, the prepared datasets' format (read
    by ``data/image_metadata.ImageMetadata.load_mask``). The member's
    timestamp is pinned, so the bytes depend only on the mask: a host-sharded
    run writes the same files as a single process."""
    path.parent.mkdir(parents=True, exist_ok=True)
    buf = io.BytesIO()
    torch.save(torch.from_numpy(np.ascontiguousarray(mask_hw)), buf)
    info = zipfile.ZipInfo(path.stem + ".inner.pt", date_time=(1980, 1, 1, 0, 0, 0))
    info.compress_type = zipfile.ZIP_DEFLATED
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(info, buf.getvalue())


def load_zip_mask_ok(path: Path) -> bool:
    """Whether ``path`` holds a readable zipped mask (``--resume``)."""
    if not path.exists():
        return False
    try:
        with zipfile.ZipFile(path) as zf:
            with zf.open(zf.namelist()[0]) as f:
                torch.load(f, map_location="cpu")
        return True
    except Exception:  # any unreadable file is redone
        return False


# ------------------------- main -------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Create Voronoi cluster masks")
    p.add_argument("--data_path", type=Path, required=True)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--centroid_mode", choices=["grid", "kmeans"], default="grid")
    p.add_argument("--grid_dim", type=int, nargs="+", default=[2, 2])
    p.add_argument("--cluster_2d", action="store_true")
    p.add_argument("--boundary_margin", type=float, default=1.0)
    p.add_argument("--ray_samples", type=int, default=256)
    p.add_argument("--center_pixels", action="store_true")
    p.add_argument("--scene_scale", type=float, default=1.1)
    p.add_argument("--altitude_range", type=float, nargs=2, default=None)
    p.add_argument("--altitude_pad", type=float, default=0.0, help="meters")
    p.add_argument("--box_margin", type=float, default=0.0, help="meters")
    p.add_argument("--near", type=float, default=None, help="meters")
    p.add_argument("--far", type=float, default=None, help="meters")
    p.add_argument("--downscale", type=float, default=1.0)
    p.add_argument("--kmeans_iters", type=int, default=25)
    p.add_argument("--kmeans_init", choices=["kmeans++", "random"], default="kmeans++")
    p.add_argument("--kmeans_seed", type=int, default=0)
    p.add_argument("--kmeans_weight_by_pixels", action="store_true")
    p.add_argument("--ray_chunk_size", type=int, default=8192)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--rank", type=int, default=None,
                   help="host-shard rank (default: $RANK or 0)")
    p.add_argument("--world_size", type=int, default=None,
                   help="host-shard world size (default: $WORLD_SIZE or 1)")
    p.add_argument("--merge_timeout", type=float, default=86400.0,
                   help="rank 0: seconds to wait for the other ranks' partials")
    p.add_argument("--device", default=None, help="the routing's device (default: the card)")
    return p


def _meta_list(ds: Path, split: str) -> List[Path]:
    d = ds / split / "metadata"
    if not d.exists():
        return []
    return sorted(p for p in d.iterdir() if p.suffix == ".pt")


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def main(h: Optional[argparse.Namespace] = None) -> Dict[str, float]:
    """Write the masks and boxes. Returns this rank's timings: ``images``
    routed, and seconds of ``host_rays`` (metadata and ray generation),
    ``route`` (the device's routing, its copies included) and ``write``
    (zipping the masks)."""
    from acn_tpu_torch.data.ray_prep import (
        clamp_rays_near_far_np,
        get_ray_directions_np,
        get_rays_np,
    )

    if h is None:
        h = build_parser().parse_args()
    rank = int(h.rank if h.rank is not None else os.environ.get("RANK", 0))
    world = int(h.world_size if h.world_size is not None
                else os.environ.get("WORLD_SIZE", 1))
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside world {world}")
    ds = Path(h.data_path)
    out = ds / "masks" / h.output
    out.mkdir(parents=True, exist_ok=True)
    partials_dir = out / "_partials"
    my_partial = partials_dir / f"rank{rank}of{world}.npz"
    t_start = time.time()
    if world > 1:
        partials_dir.mkdir(exist_ok=True)
        my_partial.unlink(missing_ok=True)  # never merge a stale self

    coord = _load(ds / "coordinates.pt")
    pose_scale = float(coord.get("pose_scale_factor", 1.0))
    origin_drb_x = float(np.asarray(coord.get("origin_drb", [0, 0, 0]))[0])

    # altitude band (ENU Up, meters) → normalized X (Down) extents
    if h.altitude_range is not None:
        min_enu, max_enu = sorted(map(float, h.altitude_range))
    elif coord.get("altitude_range_enu") is not None:
        min_enu, max_enu = sorted(map(float, np.asarray(coord["altitude_range_enu"])))
    else:
        min_enu = max_enu = 0.0
    x_lo = (-max_enu - origin_drb_x) / pose_scale
    x_hi = (-min_enu - origin_drb_x) / pose_scale
    x_lo, x_hi = min(x_lo, x_hi), max(x_hi, x_lo)
    pad = float(h.altitude_pad) / pose_scale
    aabb_global = np.array(
        [
            [x_lo - pad, -h.scene_scale, -h.scene_scale],
            [x_hi + pad, h.scene_scale, h.scene_scale],
        ],
        np.float32,
    )
    print(f"Global SceneBox: min={aabb_global[0]} max={aabb_global[1]}")

    train_meta = _meta_list(ds, "train")
    val_meta = _meta_list(ds, "val")
    all_meta = train_meta + val_meta
    if not all_meta:
        raise RuntimeError(f"No metadata found in {ds}/{{train,val}}/metadata")

    dims = list(map(int, h.grid_dim))
    if h.cluster_2d:
        if len(dims) != 2:
            raise ValueError("For cluster_2d use --grid_dim GY GZ")
        gx, gy, gz = 1, dims[0], dims[1]
    else:
        gx, gy, gz = (1, *dims) if len(dims) == 2 else tuple(dims)
    K = gx * gy * gz

    mds = [_load(p) for p in all_meta]
    cams = np.stack([np.asarray(m["c2w"], np.float32)[:3, 3] for m in mds])

    if h.centroid_mode == "grid":
        cents = grid_centroids(cams, gx, gy, gz, h.cluster_2d)
    else:
        wts = (
            np.array([float(m["H"]) * float(m["W"]) for m in mds])
            if h.kmeans_weight_by_pixels
            else None
        )
        if h.cluster_2d:
            cyz = kmeans_plusplus(
                cams[:, 1:], K, h.kmeans_iters, h.kmeans_seed, wts, h.kmeans_init
            )
            x_mid = 0.5 * (cams[:, 0].min() + cams[:, 0].max())
            cents = np.concatenate([np.full((K, 1), x_mid, np.float32), cyz], 1)
        else:
            cents = kmeans_plusplus(
                cams, K, h.kmeans_iters, h.kmeans_seed, wts, h.kmeans_init
            )

    # every rank computes the same centroids from all the metadata; rank 0
    # alone writes them
    if rank == 0:
        torch.save(
            {
                "format_version": 3,
                "centroid_mode": h.centroid_mode,
                "centroids": torch.from_numpy(cents),
                "grid_dim": (gx, gy, gz),
                "cluster_2d": bool(h.cluster_2d),
                "boundary_margin": float(h.boundary_margin),
                "ray_samples": int(h.ray_samples),
                "aabb_global": torch.from_numpy(aabb_global),
                "scene_scale": float(h.scene_scale),
                "near_far_override_m": (
                    float(h.near) if h.near is not None else None,
                    float(h.far) if h.far is not None else None,
                ),
            },
            out / "params.pt",
        )

    near_far_override = (
        (float(h.near) / pose_scale) if h.near is not None else None,
        (float(h.far) / pose_scale) if h.far is not None else None,
    )

    route = make_voronoi_kernel(cents, h.cluster_2d, h.boundary_margin, h.ray_samples,
                                h.ray_chunk_size, device=h.device)

    mins = np.full((K, 3), np.inf, np.float32)
    maxs = np.full((K, 3), -np.inf, np.float32)
    cnts = np.zeros(K, np.int64)
    timing = {"images": 0, "host_rays": 0.0, "route": 0.0, "write": 0.0}

    split_stats = {}
    for split, meta in (("train", train_meta), ("val", val_meta)):
        pix_per_cell = np.zeros(K, np.int64)
        imgs_with_pix = np.zeros(K, np.int64)
        total_pix = 0
        for i, mp in enumerate(meta):
            if i % world != rank:  # rank-strided images
                continue
            fname = mp.stem + ".pt"
            if h.resume and all(
                load_zip_mask_ok(out / f"{c}" / fname) for c in range(K)
            ):
                continue
            t0 = time.perf_counter()
            md = _load(mp)
            H = int(round(int(md["H"]) * h.downscale))
            W = int(round(int(md["W"]) * h.downscale))
            fx, fy, cx, cy = [float(v) * h.downscale for v in md["intrinsics"][:4]]
            c2w = np.asarray(md["c2w"], np.float32)

            dirs = get_ray_directions_np(H, W, fx, fy, cx, cy, h.center_pixels)
            rays = get_rays_np(dirs, c2w, aabb=aabb_global).reshape(-1, 8)
            rays, valid = clamp_rays_near_far_np(rays, near_far_override)
            rays[~valid, 6] = 1.0
            rays[~valid, 7] = 0.0  # invalid for the router
            t1 = time.perf_counter()

            mask, mn, mx, ct = route(rays)
            mins = np.minimum(mins, mn)
            maxs = np.maximum(maxs, mx)
            cnts += ct
            t2 = time.perf_counter()

            mask = mask.reshape(H, W, K) & valid.reshape(H, W)[..., None]
            for cid in range(K):
                m = mask[..., cid]
                s = int(m.sum())
                pix_per_cell[cid] += s
                if s > 0:
                    imgs_with_pix[cid] += 1
                save_zip_mask(out / f"{cid}" / fname, m)
            total_pix += H * W
            timing["images"] += 1
            timing["host_rays"] += t1 - t0
            timing["route"] += t2 - t1
            timing["write"] += time.perf_counter() - t2
            if (i + 1) % 20 == 0:
                print(f"[{split}] rank {rank}: {i + 1}/{len(meta)} images routed")
        split_stats[split] = (pix_per_cell, imgs_with_pix, total_pix)

    # host-shard reduction: npz partials and a file barrier
    if world > 1:
        np.savez(
            my_partial,
            mins=mins, maxs=maxs, cnts=cnts,
            **{
                f"{s}_{k}": v
                for s, (ppc, iwp, tp) in split_stats.items()
                for k, v in (("ppc", ppc), ("iwp", iwp), ("tp", np.int64(tp)))
            },
        )
        if rank != 0:
            print(f"rank {rank}/{world}: partial written to {my_partial}")
            return timing
        want = [partials_dir / f"rank{r}of{world}.npz" for r in range(world)]
        deadline = time.time() + float(h.merge_timeout)
        while True:
            fresh = [
                p for p in want
                if p.exists() and p.stat().st_mtime >= t_start - PARTIAL_SLACK_S
            ]
            if len(fresh) == world:
                break
            if time.time() > deadline:
                missing = [p.name for p in want if p not in fresh]
                raise RuntimeError(
                    f"merge timeout: missing/stale partials {missing}"
                )
            time.sleep(2.0)
        mins = np.full((K, 3), np.inf, np.float32)
        maxs = np.full((K, 3), -np.inf, np.float32)
        cnts = np.zeros(K, np.int64)
        split_stats = {
            s: [np.zeros(K, np.int64), np.zeros(K, np.int64), 0]
            for s in split_stats
        }
        for p in want:
            z = np.load(p)
            mins = np.minimum(mins, z["mins"])
            maxs = np.maximum(maxs, z["maxs"])
            cnts += z["cnts"]
            for s, acc in split_stats.items():
                acc[0] += z[f"{s}_ppc"]
                acc[1] += z[f"{s}_iwp"]
                acc[2] += int(z[f"{s}_tp"])
        print(f"rank 0: merged {world} partials")

    for split, (pix_per_cell, imgs_with_pix, total_pix) in split_stats.items():
        if total_pix:
            pct = pix_per_cell / total_pix * 100.0
            print(f"[{split}] pixels_per_centroid={np.asarray(pix_per_cell).tolist()}")
            print(f"[{split}] coverage_pct={np.round(pct, 3).tolist()}")
            print(f"[{split}] images_with_pixels={np.asarray(imgs_with_pix).tolist()}")

    # clamp to global, ε-boxes for empties, optional dilation, altitude global
    mins = np.maximum(mins, aabb_global[0])
    maxs = np.minimum(maxs, aabb_global[1])
    empties = cnts == 0
    if empties.any():
        eps = np.maximum(np.abs(aabb_global[1] - aabb_global[0]) * 1e-6, 1e-7)
        cc = np.clip(cents, aabb_global[0], aabb_global[1])
        mins[empties] = np.maximum(cc[empties] - eps, aabb_global[0])
        maxs[empties] = np.minimum(cc[empties] + eps, aabb_global[1])
    if h.box_margin and h.box_margin > 0:
        margin = float(h.box_margin) / pose_scale
        mins = np.maximum(mins - margin, aabb_global[0])
        maxs = np.minimum(maxs + margin, aabb_global[1])
    mins[:, 0] = aabb_global[0, 0]
    maxs[:, 0] = aabb_global[1, 0]

    torch.save(
        {
            "format_version": 3,
            "aabb_global": torch.from_numpy(aabb_global),
            "mins": torch.from_numpy(mins),
            "maxs": torch.from_numpy(maxs),
            "counts": torch.from_numpy(cnts),
            "centroids": torch.from_numpy(cents),
            "grid_dim": (gx, gy, gz),
            "cluster_2d": bool(h.cluster_2d),
            "boundary_margin": float(h.boundary_margin),
            "ray_samples": int(h.ray_samples),
            "scene_scale": float(h.scene_scale),
        },
        out / "scene_boxes.pt",
    )

    lines = ["==== GLOBAL ===="]
    lines.append(f"global.min = {np.round(aabb_global[0], 6).tolist()}")
    lines.append(f"global.max = {np.round(aabb_global[1], 6).tolist()}")
    lines.append("")
    lines.append("==== PER-EXPERT LOCAL BOXES (normalized DRB) ====")
    for cid in range(K):
        lines.append(
            f"[{cid:03d}] count={int(cnts[cid]):9d}  "
            f"centroid={np.round(cents[cid], 6).tolist()}  "
            f"min={np.round(mins[cid], 6).tolist()}  "
            f"max={np.round(maxs[cid], 6).tolist()}"
        )
    (out / "scene_boxes.txt").write_text("\n".join(lines))
    print(f"Done. Masks saved to: {out}")
    return timing


if __name__ == "__main__":
    main()
