"""Clustering diagnostics: Voronoi region maps, camera scatter, RGB overlays.

    python -m acn_tpu_torch.scripts.visualize_clustering --data_path <prepared set>
        --mask_dirname <name> [--out_dir DIR] [--num_overlays 4] [--downscale 0.25]

Port of ``acn_tpu/scripts/visualize_clustering.py``: (a) the 2-D Voronoi
region map over the ground plane with the margin's overlap bands darkened,
the centroids and the cameras; (b) the cameras colored by their nearest
centroid; (c) per-image RGB overlays colored by owning expert, overlaps
brightened. Host work. The arrays are computed without matplotlib
(``region_image``, ``camera_owners``, ``color_overlay``); matplotlib (Agg)
and PIL are imported only where a figure or a PNG is written.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="Visualize clustering")
    p.add_argument("--data_path", type=Path, required=True,
                   help="prepared dataset root")
    p.add_argument("--mask_dirname", type=str, required=True)
    p.add_argument("--out_dir", type=Path, default=None)
    p.add_argument("--num_overlays", type=int, default=4)
    p.add_argument("--downscale", type=float, default=0.25)
    return p


CELL_COLORS = np.array(
    [
        [0.894, 0.102, 0.110], [0.216, 0.494, 0.722], [0.302, 0.686, 0.290],
        [0.596, 0.306, 0.639], [1.000, 0.498, 0.000], [1.000, 1.000, 0.200],
        [0.651, 0.337, 0.157], [0.969, 0.506, 0.749],
    ]
)


def region_image(centroids, aabb_global, boundary_margin, res=512):
    """The ground-plane (YZ) region map: (image (res, res, 3) with rows over
    Y and columns over Z, the owners (res·res,) of its points, the Y and Z
    axes). A point's color is its nearest centroid's; points within the
    margin of two or more centroids are darkened."""
    ys = np.linspace(aabb_global[0][1], aabb_global[1][1], res)
    zs = np.linspace(aabb_global[0][2], aabb_global[1][2], res)
    YY, ZZ = np.meshgrid(ys, zs, indexing="ij")
    pts = np.stack([YY.ravel(), ZZ.ravel()], 1)
    d = np.linalg.norm(pts[:, None, :] - centroids[:, 1:][None], axis=-1)
    owner = d.argmin(1)
    img = CELL_COLORS[owner % len(CELL_COLORS)].reshape(res, res, 3).copy()
    if boundary_margin > 1.0:
        mind = d.min(1)
        n_within = (d <= boundary_margin * mind[:, None]).sum(1)
        img[(n_within > 1).reshape(res, res)] *= 0.55  # darken overlap bands
    return img, owner, ys, zs


def camera_owners(centroids, cams, cluster_2d=True):
    """Each camera's nearest centroid (in YZ with ``cluster_2d``)."""
    sub = (1, 2) if cluster_2d else (0, 1, 2)
    d = np.linalg.norm(cams[:, None, sub] - centroids[None, :, sub], axis=-1)
    return d.argmin(1)


def save_region_viz2d(out_path, centroids, aabb_global, cams, boundary_margin,
                      cluster_2d=True, res=512):
    """The region map of ``region_image`` with the centroids and cameras."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img, _, ys, zs = region_image(centroids, aabb_global, boundary_margin, res)
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.imshow(
        np.transpose(img, (1, 0, 2)), origin="lower",
        extent=[ys[0], ys[-1], zs[0], zs[-1]],
    )
    ax.scatter(cams[:, 1], cams[:, 2], s=6, c="k", label="cameras")
    ax.scatter(centroids[:, 1], centroids[:, 2], s=120, marker="*",
               c="white", edgecolors="k", label="centroids")
    ax.set_xlabel("R (east)")
    ax.set_ylabel("B (south)")
    ax.set_title(f"Voronoi regions (K={len(centroids)}, bm={boundary_margin})")
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def save_overview_scatter(out_path, centroids, cams, cluster_2d=True):
    """Cameras colored by their nearest centroid."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    owner = camera_owners(centroids, cams, cluster_2d)
    fig, ax = plt.subplots(figsize=(7, 7))
    for cid in range(len(centroids)):
        sel = owner == cid
        ax.scatter(
            cams[sel, 1], cams[sel, 2], s=10,
            color=CELL_COLORS[cid % len(CELL_COLORS)],
            label=f"module {cid} ({sel.sum()})",
        )
    ax.scatter(centroids[:, 1], centroids[:, 2], s=140, marker="*",
               c="white", edgecolors="k", zorder=5)
    ax.set_xlabel("R (east)")
    ax.set_ylabel("B (south)")
    ax.set_title("Cameras by nearest centroid")
    ax.legend(fontsize=8)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def color_overlay(rgb01: np.ndarray, masks: np.ndarray, alpha=0.45) -> np.ndarray:
    """Per-expert colors over an image (H, W, 3) in [0, 1], masks (K, H, W);
    pixels of two or more experts brightened."""
    out = rgb01.copy()
    count = masks.sum(0)
    for cid in range(masks.shape[0]):
        col = CELL_COLORS[cid % len(CELL_COLORS)]
        m = masks[cid]
        out[m] = (1 - alpha) * out[m] + alpha * col
    out[count > 1] = np.clip(out[count > 1] * 1.3, 0, 1)  # highlight overlaps
    return out


def image_masks(mask_root: Path, md, K: int) -> np.ndarray:
    """(K, H, W) masks of image ``md`` at its size (nearest resize), empty
    for an expert without a file."""
    from acn_tpu_torch.scripts.log_mask_info import load_mask

    masks = []
    for c in range(K):
        p = mask_root / str(c) / f"{Path(md.image_path).stem}.pt"
        m = load_mask(p) if p.exists() else np.zeros((md.H, md.W), bool)
        if m.shape != (md.H, md.W):  # nearest resize
            ys = (np.arange(md.H) * m.shape[0] / md.H).astype(int)
            xs = (np.arange(md.W) * m.shape[1] / md.W).astype(int)
            m = m[ys][:, xs]
        masks.append(m)
    return np.stack(masks)


def run_visualize(h) -> Path:
    import torch
    from PIL import Image

    from acn_tpu_torch.data.dataset import get_image_metadata, load_clustering_meta

    data_path = Path(h.data_path)
    mask_root = data_path / "masks" / h.mask_dirname
    out_dir = h.out_dir or (mask_root / "viz")
    out_dir.mkdir(parents=True, exist_ok=True)

    params = load_clustering_meta(mask_root)
    boxes = torch.load(mask_root / "scene_boxes.pt", map_location="cpu",
                       weights_only=False)
    cents = np.asarray(params["centroids"], np.float32)
    aabb_g = np.asarray(boxes["aabb_global"], np.float32)
    K = len(cents)

    train_md, val_md = get_image_metadata(data_path, h.downscale)
    cams = np.stack([m.c2w[:, 3] for m in train_md + val_md])
    save_region_viz2d(out_dir / "regions.png", cents, aabb_g, cams,
                      float(params["boundary_margin"]),
                      bool(params["cluster_2d"]))
    print(f"wrote {out_dir / 'regions.png'}")
    save_overview_scatter(out_dir / "scatter_cameras.png", cents, cams,
                          bool(params["cluster_2d"]))
    print(f"wrote {out_dir / 'scatter_cameras.png'}")

    for split, metas in (("train", train_md), ("val", val_md)):
        split_dir = out_dir / "clustering" / split
        split_dir.mkdir(parents=True, exist_ok=True)
        for md in metas[: h.num_overlays]:
            rgb = md.load_image().astype(np.float32) / 255.0
            over = color_overlay(rgb, image_masks(mask_root, md, K))
            name = Path(md.image_path).stem
            Image.fromarray((over * 255).astype(np.uint8)).save(
                split_dir / f"{name}_assign.png"
            )
            print(f"wrote {split_dir / f'{name}_assign.png'}")
    return out_dir


def main(h=None):
    if h is None:
        h = build_parser().parse_args()
    run_visualize(h)


if __name__ == "__main__":
    main()
