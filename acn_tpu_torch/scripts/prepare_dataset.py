"""COLMAP → framework dataset conversion.

    python -m acn_tpu_torch.scripts.prepare_dataset --data_path <colmap dir> \\
        --output_path <prepared dir> [--val_split 0.1] [--ecef_to_enu]

The port's own copy of ``acn_tpu/scripts/prepare_dataset.py`` (host code:
numpy, OpenCV and ``torch.save``); its outputs equal that script's file for
file.

Counterpart of the reference's ``scripts/prepare_dataset.py``. Conventions
preserved exactly (they are load-bearing for everything downstream,
reference prepare_dataset.py:26-100):

* COLMAP gives world→camera RDF poses; camera centers C = −Rᵀt (with the
  ``‖R·C + t‖`` consistency check);
* optional ECEF→ENU world change with origin policy first/mean/median/custom;
* the target world basis is **DRB** ([D,R,B] = [−U, E, −N]); translations are
  normalized by the bbox-midpoint origin and a pose scale factor
  (camera_max / camera_p99 / bbox_diag of camera distances);
* the stored camera rotation is **RUB→DRB**: ENU_TO_DRB · R_c2w_rdf · RDF_TO_RUB;
* the altitude band [low points3D percentile (clamped below the lowest camera
  minus maximum_allowed_height), highest camera] is saved in ENU meters;
* outputs: per-image undistorted JPEG + metadata ``{H, W, c2w (3,4),
  intrinsics [fx fy cx cy], distortion}`` .pt files under train|val,
  ``coordinates.pt``, ``mappings.txt`` — identical formats to the reference.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np

from acn_tpu_torch.data import transformations as tf
from acn_tpu_torch.data.colmap import get_cam_intrinsics, qvec2rotmat, read_model


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="COLMAP → prepared dataset")
    p.add_argument("--data_path", type=str, required=True,
                   help="dir with model/ (COLMAP sparse) and images/")
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--val_split", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=17)
    p.add_argument(
        "--scale_strategy", type=str, default="camera_max",
        choices=["camera_max", "camera_p99", "bbox_diag"],
    )
    p.add_argument("--ecef_to_enu", action="store_true")
    p.add_argument(
        "--enu_ref", type=str, default="median",
        choices=["first", "mean", "median", "custom"],
    )
    p.add_argument("--enu_ref_lat", type=float, default=None)
    p.add_argument("--enu_ref_lon", type=float, default=None)
    p.add_argument("--enu_ref_alt", type=float, default=None)
    p.add_argument("--points_low_alt_percentile", type=float, default=0.01)
    p.add_argument("--maximum_allowed_height", type=float, default=200.0)
    p.add_argument("--verify_enu_geodetic", action="store_true")
    p.add_argument("--yes", action="store_true", help="overwrite without asking")
    return p


def main(hparams=None) -> None:
    import cv2
    import torch  # .pt interop

    if hparams is None:
        hparams = build_parser().parse_args()

    cameras, images, points3D = read_model(Path(hparams.data_path) / "model")
    images_ordered = sorted(images.values(), key=lambda x: x.id)
    ordered_indices = np.arange(len(images_ordered))
    print(
        f"Loaded {len(images_ordered)} images; {len(points3D)} 3D points; "
        f"{len(cameras)} cameras."
    )

    # camera centers + w2c rotations (RDF), with consistency check
    # (reference prepare_dataset.py:216-229)
    centers, R_w2c_list = [], []
    for img in images_ordered:
        R_w2c = qvec2rotmat(img.qvec)
        t = np.asarray(img.tvec, np.float64)
        C = -R_w2c.T @ t
        residual = np.linalg.norm(R_w2c @ C + t)
        if residual > 1e-6:
            print(f"[WARN] COLMAP consistency residual for {img.id}: {residual:.3e}")
        centers.append(C)
        R_w2c_list.append(R_w2c)
    centers = np.stack(centers)
    R_c2w_rdf = np.transpose(np.stack(R_w2c_list), (0, 2, 1))

    print(
        f"Mean radius (ecef heuristic): {np.linalg.norm(centers, axis=1).mean():.1f} m"
        f" (ECEF? {'YES' if tf.is_likely_ecef(centers) else 'NO'})"
    )

    pts_xyz = (
        np.stack([np.asarray(p.xyz, np.float64) for p in points3D.values()])
        if points3D
        else None
    )

    # optional ECEF→ENU world change (reference prepare_dataset.py:254-309)
    if hparams.ecef_to_enu:
        lats, lons, alts = tf.ecef_to_geodetic(
            centers[:, 0], centers[:, 1], centers[:, 2]
        )
        lat0, lon0, h0, desc = tf.choose_enu_origin(
            hparams.enu_ref, lats, lons, alts, ordered_indices, hparams
        )
        print(f"ENU origin: {desc} → lat={lat0:.8f}, lon={lon0:.8f}, h={h0:.3f}")
        e, n, u = tf.ecef_to_enu(centers[:, 0], centers[:, 1], centers[:, 2],
                                 lat0, lon0, h0)
        cam_enu = np.stack([e, n, u], axis=1)
        Q = tf.ecef_to_enu_rot(lat0, lon0)
        R_c2w_rdf = Q @ R_c2w_rdf
        if pts_xyz is not None:
            pe, pn, pu = tf.ecef_to_enu(
                pts_xyz[:, 0], pts_xyz[:, 1], pts_xyz[:, 2], lat0, lon0, h0
            )
            pts_up = np.asarray(pu)
        else:
            pts_up = None
        enu_ref_coords = (float(lat0), float(lon0), float(h0))
    else:
        print("[INFO] Assuming input world is already ENU-aligned (E, N, U).")
        cam_enu = centers.copy()
        pts_up = pts_xyz[:, 2] if pts_xyz is not None else None
        enu_ref_coords = None
        lat0 = lon0 = h0 = None

    # altitude band (reference prepare_dataset.py:319-341)
    cam_up = cam_enu[:, 2]
    lowest_acceptable = float(cam_up.min()) - hparams.maximum_allowed_height
    if pts_up is not None and pts_up.size > 0:
        p_low = float(np.quantile(pts_up, hparams.points_low_alt_percentile))
        lowest_point = max(p_low, lowest_acceptable)
        if p_low != lowest_point:
            print(f"[WARN] points3D low percentile {p_low:.3f} clamped to "
                  f"{lowest_acceptable:.3f}")
    else:
        lowest_point = lowest_acceptable
        print("[WARN] points3D empty; altitude floor from lowest camera")
    altitude_range_enu = np.array([lowest_point, float(cam_up.max())], np.float32)
    print(f"[ALTITUDE] ENU range (m): {altitude_range_enu.tolist()}")

    # ENU→DRB (reference prepare_dataset.py:344-359)
    T_drb = cam_enu @ tf.ENU_TO_DRB.T
    R_rub_to_drb = (tf.ENU_TO_DRB @ R_c2w_rdf @ tf.RDF_TO_RUB).astype(np.float32)

    v0 = tf.ENU_TO_DRB @ cam_enu[0]
    if not np.allclose(v0, T_drb[0], atol=1e-6):
        raise SystemExit("[ERR] R/T world-basis mismatch (ENU_TO_DRB sanity check)")

    # origin & scale (reference prepare_dataset.py:367-379)
    mx, mn = T_drb.max(axis=0), T_drb.min(axis=0)
    origin_drb = 0.5 * (mx + mn)
    dists = np.linalg.norm(T_drb - origin_drb, axis=1)
    if hparams.scale_strategy == "camera_max":
        pose_scale = float(dists.max())
    elif hparams.scale_strategy == "camera_p99":
        pose_scale = float(np.quantile(dists, 0.99))
    else:
        pose_scale = float(max(np.linalg.norm(mx - mn) * 0.5, 1e-8))
    print(f"Origin (DRB, m): {origin_drb.tolist()}; pose_scale: {pose_scale:.6f}")

    out_dir = Path(hparams.output_path)
    if out_dir.exists():
        if not hparams.yes:
            resp = input(f"[WARNING] {out_dir} exists. Overwrite? [y/N]: ").lower()
            if resp not in ("y", "yes"):
                print("Aborting.")
                return
        shutil.rmtree(out_dir)
    for split in ("train", "val"):
        (out_dir / split / "metadata").mkdir(parents=True, exist_ok=True)
        (out_dir / split / "rgbs").mkdir(parents=True, exist_ok=True)

    # deterministic evenly-spaced val split (reference prepare_dataset.py:404-416)
    all_by_name = sorted(images.values(), key=lambda x: x.name)
    N = len(all_by_name)
    num_val = max(0, int(round(hparams.val_split * N)))
    val_ids = (
        set(np.round(np.linspace(0, N - 1, num=num_val)).astype(int).tolist())
        if num_val
        else set()
    )
    print(f"{num_val} images reserved for validation (evenly spaced).")

    index_by_name = {img.name: i for i, img in enumerate(images_ordered)}

    with open(out_dir / "mappings.txt", "w") as mappings_f:
        for i, img in enumerate(all_by_name):
            split = "val" if i in val_ids else "train"
            cam = cameras[img.camera_id]
            K, distortion, is_fisheye = get_cam_intrinsics(cam)

            src = Path(hparams.data_path) / "images" / img.name
            distorted = cv2.imread(str(src))
            if distorted is None:
                raise FileNotFoundError(f"Cannot read image: {src}")
            if np.any(distortion):
                if is_fisheye:
                    und = cv2.fisheye.undistortImage(distorted, K, distortion)
                else:
                    und = cv2.undistort(distorted, K, distortion)
            else:
                und = distorted
            cv2.imwrite(str(out_dir / split / "rgbs" / f"{i:06d}.jpg"), und)

            j = index_by_name[img.name]
            t_norm = (T_drb[j] - origin_drb) / pose_scale
            c2w = np.zeros((3, 4), np.float32)
            c2w[:, :3] = R_rub_to_drb[j]
            c2w[:, 3] = t_norm.astype(np.float32)

            torch.save(
                {
                    "H": und.shape[0],
                    "W": und.shape[1],
                    "c2w": torch.from_numpy(c2w),
                    "intrinsics": torch.tensor(
                        [K[0, 0], K[1, 1], K[0, 2], K[1, 2]], dtype=torch.float32
                    ),
                    "distortion": torch.tensor(distortion, dtype=torch.float32),
                },
                out_dir / split / "metadata" / f"{i:06d}.pt",
            )
            mappings_f.write(f"{img.name},{i:06d}.pt\n")

    torch.save(
        {
            "origin_drb": torch.from_numpy(origin_drb.astype(np.float32)),
            "pose_scale_factor": pose_scale,
            "altitude_range_enu": torch.from_numpy(altitude_range_enu),
            "enu_ref_coords": enu_ref_coords,
        },
        out_dir / "coordinates.pt",
    )
    print("Dataset preparation complete.")

    if hparams.verify_enu_geodetic and hparams.ecef_to_enu:
        la, lo, al = tf.enu_to_geodetic(
            cam_enu[:, 0], cam_enu[:, 1], cam_enu[:, 2], lat0, lon0, h0
        )
        print(f"[VERIFY] ENU→Geodetic lat range: {la.min():.8f} .. {la.max():.8f}")
        print(f"[VERIFY] ENU→Geodetic lon range: {lo.min():.8f} .. {lo.max():.8f}")
        print(f"[VERIFY] ENU→Geodetic alt range: {al.min():.3f} .. {al.max():.3f}")


if __name__ == "__main__":
    main()
