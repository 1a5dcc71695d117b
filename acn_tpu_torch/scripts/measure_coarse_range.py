"""How far ``coarse_ray_range`` tightens the rays of a trained run, the
counterpart of ``acn_tpu/scripts/measure_coarse_range.py``.

    python -m acn_tpu_torch.scripts.measure_coarse_range [RUN] [PREFIX]
        [--data_path data/drz/out/example] [--mask_dirname g22_grid_bm110_ss11]
        [--downscale 0.25] [--rays 4000] [--device cuda]

Restores the run's occupancy grids (``RUN`` default ``logs/r3_flagship``,
``PREFIX`` default ``last``), takes ``--rays`` random pixels of the first,
middle and last validation views of the dataset, and runs the 32-bin range
pre-pass on each expert's grid. Prints the occupied share of each expert's
grid, the median tightened fraction of the ray span per (view, expert), and
their mean with the share of rays that keep a non-empty range.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from acn_tpu_torch.data.dataset import get_image_metadata, load_scene_boxes
from acn_tpu_torch.data.ray_prep import get_ray_directions_np, get_rays_np
from acn_tpu_torch.occupancy.grid import coarse_ray_range
from acn_tpu_torch.pipelines.renderer import resolve_device
from acn_tpu_torch.utils.checkpoint import load_checkpoint_with_fallback


def measure(run, prefix: str, data_path, mask_dirname: str, downscale: float,
            n_rays: int = 4000, device=None) -> dict:
    device = resolve_device(device)
    loaded, _ = load_checkpoint_with_fallback(run, prefix)
    occ = loaded["occ_states"]
    if occ is None:
        raise ValueError(f"{run}/{prefix} holds no occupancy grids")
    K = int(np.asarray(occ["binaries"]).shape[0])
    data_path = Path(data_path)
    ga, _ = load_scene_boxes(data_path / "masks" / mask_dirname)
    _, val_meta = get_image_metadata(data_path, downscale)
    rng = np.random.default_rng(0)
    fracs, hits = [], []
    for vi in (0, len(val_meta) // 2, len(val_meta) - 1):
        md = val_meta[vi]
        fx, fy, cx, cy = np.asarray(md.intrinsics[:4], np.float64)
        dirs = get_ray_directions_np(md.H, md.W, fx, fy, cx, cy)
        ys, xs = rng.integers(0, md.H, n_rays), rng.integers(0, md.W, n_rays)
        rays = get_rays_np(dirs[ys, xs], np.asarray(md.c2w), aabb=np.asarray(ga))
        near = np.maximum(rays[:, 6], 1e-3).astype(np.float32)
        far = np.maximum(rays[:, 7], near).astype(np.float32)
        span = far - near
        ok = span > 1e-6
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
        for k in range(K):
            st_k = {"aabbs": torch.from_numpy(np.array(occ["aabbs"][k])).to(device),
                    "binaries": torch.from_numpy(np.array(occ["binaries"][k])).to(device)}
            n2, f2 = (x.cpu().numpy() for x in coarse_ray_range(
                st_k, t(rays[:, :3]), t(rays[:, 3:6]), t(near), t(far), s_coarse=32))
            frac = (f2 - n2) / np.maximum(span, 1e-9)
            fracs.append(float(np.median(frac[ok])))
            hits.append(float(((f2 > n2) & ok)[ok].mean()))
    return {"occupied": [float(np.asarray(occ["binaries"][k]).mean()) for k in range(K)],
            "median_fraction": fracs, "mean_fraction": float(np.mean(fracs)),
            "mean_hit_rate": float(np.mean(hits))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run", nargs="?", default="logs/r3_flagship")
    ap.add_argument("prefix", nargs="?", default="last")
    ap.add_argument("--data_path", default="data/drz/out/example")
    ap.add_argument("--mask_dirname", default="g22_grid_bm110_ss11")
    ap.add_argument("--downscale", type=float, default=0.25)
    ap.add_argument("--rays", type=int, default=4000)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    res = measure(args.run, args.prefix, args.data_path, args.mask_dirname, args.downscale,
                  args.rays, args.device)
    print("occ occupied per expert:", [f"{v:.1%}" for v in res["occupied"]])
    print("median tightened fraction per (view,expert):",
          [f"{f:.2f}" for f in res["median_fraction"]])
    print("mean frac:", f"{res['mean_fraction']:.3f}", "mean hit-rate:",
          f"{res['mean_hit_rate']:.2f}")
    return res


if __name__ == "__main__":
    main()
