"""Dataset audit: pose / intrinsics / extent / FOV statistics in DRB.

    python -m acn_tpu_torch.scripts.log_dataset_info --data_path <prepared set>
        [--out info.txt]

Port of ``acn_tpu/scripts/log_dataset_info.py``, copied (host numpy and
torch I/O; the same text): writes an ``info.txt`` of camera translation
ranges, rotation orthonormality, intrinsics and field-of-view statistics,
baselines, attitude and split sizes. Flipped axes never crash a run, they
ruin its training; this audit shows them.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="Log dataset info")
    p.add_argument("--data_path", type=Path, required=True,
                   help="prepared dataset root (contains coordinates.pt)")
    p.add_argument("--out", type=Path, default=None,
                   help="output file (default <data_path>/info.txt)")
    return p


def dataset_info(data_path: Path) -> str:
    import torch

    lines = []
    coord = torch.load(data_path / "coordinates.pt", map_location="cpu",
                       weights_only=False)
    psf = float(coord["pose_scale_factor"])
    lines.append(f"pose_scale_factor: {psf:.4f} m")
    lines.append(f"origin_drb (m): {np.asarray(coord['origin_drb']).tolist()}")
    if coord.get("altitude_range_enu") is not None:
        lines.append(
            f"altitude_range_enu (m): {np.asarray(coord['altitude_range_enu']).tolist()}"
        )
    if coord.get("enu_ref_coords") is not None:
        lines.append(f"enu_ref_coords: {coord['enu_ref_coords']}")

    for split in ("train", "val"):
        meta_dir = data_path / split / "metadata"
        if not meta_dir.exists():
            continue
        files = sorted(meta_dir.glob("*.pt"))
        if not files:
            continue
        c2ws, intr, sizes = [], [], []
        for f in files:
            md = torch.load(f, map_location="cpu", weights_only=False)
            c2ws.append(np.asarray(md["c2w"], np.float64))
            intr.append(np.asarray(md["intrinsics"], np.float64))
            sizes.append((int(md["H"]), int(md["W"])))
        c2ws = np.stack(c2ws)
        intr = np.stack(intr)
        t = c2ws[:, :, 3]
        R = c2ws[:, :, :3]

        lines.append(f"\n==== split {split}: {len(files)} images ====")
        for a, name in enumerate(("Down", "Right", "Back")):
            lines.append(
                f"t.{name:<5} normalized: {t[:, a].min():+.4f} .. {t[:, a].max():+.4f}"
                f"  (m: {t[:, a].min() * psf:+.1f} .. {t[:, a].max() * psf:+.1f})"
            )
        # rotation orthonormality audit
        err = np.max(np.abs(np.einsum("nij,nkj->nik", R, R) - np.eye(3)))
        det = np.linalg.det(R)
        lines.append(f"R orthonormality max err: {err:.2e}; det range "
                     f"{det.min():.6f}..{det.max():.6f}")
        # camera forward = -z column (RUB): check cameras generally look down
        fwd_drb = -R[:, :, 2]
        lines.append(
            f"forward·Down mean: {fwd_drb[:, 0].mean():+.3f} "
            f"(aerial datasets should be positive)"
        )
        def rng_mean_std(v):
            return (f"{v.min():+.4f}..{v.max():+.4f} "
                    f"mean {v.mean():+.4f} std {v.std():.4f}")

        fx, fy = intr[:, 0], intr[:, 1]
        cx, cy = intr[:, 2], intr[:, 3]
        H = np.array([s[0] for s in sizes], np.float64)
        W = np.array([s[1] for s in sizes], np.float64)
        fov_x = 2 * np.degrees(np.arctan(W / (2 * fx)))
        fov_y = 2 * np.degrees(np.arctan(H / (2 * fy)))
        lines.append(f"fx: {rng_mean_std(fx)}")
        lines.append(f"fy: {rng_mean_std(fy)}")
        lines.append(f"cx: {rng_mean_std(cx)}  (W/2 = {W.mean() / 2:.1f})")
        lines.append(f"cy: {rng_mean_std(cy)}  (H/2 = {H.mean() / 2:.1f})")
        lines.append(f"fov_x: {fov_x.min():.2f}..{fov_x.max():.2f} deg; "
                     f"fov_y: {fov_y.min():.2f}..{fov_y.max():.2f} deg")
        if np.any(np.abs(fx - fy) / np.maximum(fx, 1e-9) > 0.10):
            lines.append(
                "WARNING: fx and fy differ by >10% (non-square pixels)"
            )
        from collections import Counter

        lines.append(f"sizes: {Counter(sizes).most_common()}")
        lines.append(f"ray total: {int((H * W).sum()):,}")

        # per-axis position quantiles (reference _quantiles, :82-95)
        q = [0.0, 0.05, 0.5, 0.95, 1.0]
        for a, name in enumerate(("Down", "Right", "Back")):
            vals = np.quantile(t[:, a], q)
            lines.append(
                f"t.{name:<5} quantiles {q}: "
                + " ".join(f"{v:+.4f}" for v in vals)
            )
        # normalization audit (reference :245-249): every camera must land
        # inside the unit cube or ray near/far planes clip wrong
        oor = int((np.abs(t) > 1.0001).any(axis=1).sum())
        if oor:
            lines.append(
                f"WARNING: {oor} camera translations fall outside [-1,1] "
                "after normalization"
            )

        # scene extent + camera baselines (reference :215-310)
        ext = t.max(0) - t.min(0)
        lines.append(
            f"camera bbox extent (norm): {ext.tolist()} "
            f"diag {np.linalg.norm(ext):.4f} "
            f"({np.linalg.norm(ext) * psf:.1f} m)"
        )
        if len(t) > 1:
            d2 = np.linalg.norm(t[:, None] - t[None], axis=-1)
            np.fill_diagonal(d2, np.inf)
            nn = d2.min(1)
            lines.append(
                f"nearest-neighbor baseline (m): mean {nn.mean() * psf:.2f} "
                f"min {nn.min() * psf:.2f} max {nn.max() * psf:.2f}"
            )
            # all-pairs baseline quantiles (reference :267-276): how spread
            # the capture is, not just how dense
            pair = d2[np.isfinite(d2)] * psf
            qs = np.quantile(pair, [0.05, 0.5, 0.95])
            lines.append(
                f"pairwise baseline (m): min {pair.min():.2f} p05 {qs[0]:.2f} "
                f"med {qs[1]:.2f} p95 {qs[2]:.2f} max {pair.max():.2f}"
            )

        # signed roll about the forward axis (reference _signed_roll_deg,
        # :130-152): project camera Right onto the plane ⊥ forward and
        # measure its angle to the horizontal in-plane direction
        fwd = fwd_drb / np.linalg.norm(fwd_drb, axis=1, keepdims=True)
        right = R[:, :, 0]
        up_world = np.array([-1.0, 0.0, 0.0])  # "up" = -Down
        horiz = np.cross(up_world[None], fwd)
        norm = np.linalg.norm(horiz, axis=1, keepdims=True)
        ok = norm[:, 0] > 1e-6
        if ok.any():
            h_dir = horiz[ok] / norm[ok]
            r_proj = right[ok] - (right[ok] * fwd[ok]).sum(1, keepdims=True) * fwd[ok]
            r_proj /= np.maximum(np.linalg.norm(r_proj, axis=1, keepdims=True), 1e-9)
            cosang = np.clip((r_proj * h_dir).sum(1), -1, 1)
            sinang = (np.cross(h_dir, r_proj) * fwd[ok]).sum(1)
            roll = np.degrees(np.arctan2(sinang, cosang))
            lines.append(
                f"signed roll (deg): mean {roll.mean():+.2f} "
                f"std {roll.std():.2f} range {roll.min():+.2f}..{roll.max():+.2f}"
            )
        lines.append(
            "mean forward (DRB): "
            + np.array2string(fwd.mean(0), precision=3)
        )
        # tilt-from-nadir distribution (aerial capture audit): angle between
        # the camera forward and straight Down. Banded histogram + yaw
        # heading stats follow the reference's attitude audit (:305-345)
        tilt = np.degrees(np.arccos(np.clip(fwd_drb[:, 0], -1, 1)))
        lines.append(f"tilt from nadir (deg): {rng_mean_std(tilt)}")
        bands = [0, 5, 15, 30, 45, 60, 180]
        hist, _ = np.histogram(tilt, bands)
        lines.append(
            "pitch bands: "
            + ", ".join(
                f"{lo}-{hi}° {100.0 * n / max(len(tilt), 1):.1f}%"
                for lo, hi, n in zip(bands[:-1], bands[1:], hist)
            )
        )
        yaw = np.degrees(np.arctan2(fwd_drb[:, 2], fwd_drb[:, 1]))
        lines.append(f"yaw heading (deg, atan2(Back,Right)): "
                     f"mean {yaw.mean():+.2f} std {yaw.std():.2f}")
        # principal-point offset from image center (reference :360-369)
        cx_rel = np.abs(cx / np.maximum(W, 1e-8) - 0.5).mean()
        cy_rel = np.abs(cy / np.maximum(H, 1e-8) - 0.5).mean()
        lines.append(
            f"principal point offset (mean abs): |cx/W-0.5|={cx_rel:.4f}, "
            f"|cy/H-0.5|={cy_rel:.4f}"
        )
        # altitude-band sanity: the scene's altitude band (from points3D at
        # prepare time) must sit BELOW every camera, or rays near nadir have
        # inverted near/far
        if coord.get("altitude_range_enu") is not None:
            band = np.asarray(coord["altitude_range_enu"], np.float64)
            origin = np.asarray(coord["origin_drb"], np.float64)
            # absolute ENU altitude: up = −(normalized_down·psf + origin_down)
            cam_alt = -(t[:, 0] * psf + origin[0])
            lines.append(
                f"camera altitude ENU (m): {rng_mean_std(cam_alt)}; "
                f"scene altitude band ENU: [{band[0]:.1f}, {band[1]:.1f}] "
                "(= [lowest points3D percentile, highest camera])"
            )
            # the band floor must sit below every camera or nadir rays
            # start inside geometry
            if band[0] > cam_alt.min():
                lines.append(
                    "WARNING: scene altitude floor is above the lowest "
                    "camera — check prepare_dataset altitude flags"
                )
    return "\n".join(lines)


def main(h=None):
    if h is None:
        h = build_parser().parse_args()
    text = dataset_info(Path(h.data_path))
    out = h.out or (Path(h.data_path) / "info.txt")
    Path(out).write_text(text)
    print(text)
    print(f"\nwritten to {out}")


if __name__ == "__main__":
    main()
