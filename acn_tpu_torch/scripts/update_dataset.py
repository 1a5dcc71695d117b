"""Continual-batch ingestion: register newly arrived images into an existing
prepared dataset without recomputing its normalization.

    python -m acn_tpu_torch.scripts.update_dataset --update_model_path <colmap dir> \\
        --prepared_dir <prepared dir> --batch_tag b000 [--on_overflow abort|clip]

The port's own copy of ``acn_tpu/scripts/update_dataset.py`` (host code:
numpy, OpenCV and ``torch.save``). The viewer's runtime-adapt mode trains on
the batches it writes, oldest first.

Counterpart of the reference's ``scripts/update_dataset.py``: reuse the frozen
``origin_drb`` / ``pose_scale_factor`` / ``enu_ref_coords`` from
``coordinates.pt``, detect images absent from ``mappings.txt``, convert /
undistort / normalize only those into
``<prepared>/continual/<batch_tag>/{rgbs,metadata}`` (same metadata schema as
prepare_dataset), guard against out-of-range cameras (``--on_overflow
abort|clip``), append to mappings, and write a ``manifest.json``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from acn_tpu_torch.data import transformations as tf
from acn_tpu_torch.data.colmap import get_cam_intrinsics, qvec2rotmat, read_model


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Ingest a continual batch")
    p.add_argument("--update_model_path", type=str, required=True,
                   help="dir with the re-registered COLMAP model/ and images/")
    p.add_argument("--prepared_dir", type=str, required=True)
    p.add_argument("--batch_tag", type=str, required=True)
    p.add_argument("--on_overflow", choices=["abort", "clip"], default="abort")
    return p


def main(hp=None) -> None:
    import cv2
    import torch

    if hp is None:
        hp = build_parser().parse_args()

    prep_dir = Path(hp.prepared_dir)
    update_path = Path(hp.update_model_path)

    coords_path = prep_dir / "coordinates.pt"
    if not coords_path.exists():
        raise FileNotFoundError(f"coordinates.pt not found at {coords_path}")
    coordinates = torch.load(coords_path, map_location="cpu", weights_only=False)
    origin_drb = np.asarray(coordinates["origin_drb"], np.float32)
    pose_scale = float(coordinates["pose_scale_factor"])
    enu_ref = coordinates.get("enu_ref_coords")

    # existing images → skip; ids continue from the current max
    # (reference update_dataset.py:122-138)
    existing_names = set()
    existing_ids = []
    mappings_path = prep_dir / "mappings.txt"
    if mappings_path.exists():
        for line in mappings_path.read_text().splitlines():
            if not line.strip():
                continue
            name, idpt = line.split(",")
            existing_names.add(name)
            try:
                existing_ids.append(int(Path(idpt).stem))
            except ValueError:
                pass
    next_id = (max(existing_ids) + 1) if existing_ids else 0

    cameras, images, _ = read_model(update_path / "model")
    new_images = [
        im for im in sorted(images.values(), key=lambda x: x.name)
        if im.name not in existing_names
    ]
    print(f"[UPDATE] {len(new_images)} new images (of {len(images)})")

    batch_dir = prep_dir / "continual" / hp.batch_tag
    (batch_dir / "rgbs").mkdir(parents=True, exist_ok=True)
    (batch_dir / "metadata").mkdir(parents=True, exist_ok=True)

    manifest_items = []
    added = 0
    with open(mappings_path, "a") as map_f:
        for im in new_images:
            R_w2c = qvec2rotmat(im.qvec)
            t = np.asarray(im.tvec, np.float64)
            C = -R_w2c.T @ t
            R_c2w_rdf = R_w2c.T

            if enu_ref is not None:
                lat0, lon0, h0 = enu_ref
                e, n, u = tf.ecef_to_enu(C[0], C[1], C[2], lat0, lon0, h0)
                cam_enu = np.array([float(e), float(n), float(u)])
                Q = tf.ecef_to_enu_rot(lat0, lon0)
                R_c2w_rdf = Q @ R_c2w_rdf
            else:
                cam_enu = C

            t_drb = tf.ENU_TO_DRB @ cam_enu
            R_saved = (tf.ENU_TO_DRB @ R_c2w_rdf @ tf.RDF_TO_RUB).astype(np.float32)
            t_norm = (t_drb - origin_drb) / pose_scale

            max_abs = float(np.abs(t_norm).max())
            if max_abs > 1.0 + 1e-6:
                if hp.on_overflow == "abort":
                    raise RuntimeError(
                        f"New camera '{im.name}' exceeds normalized range "
                        f"|t_norm|={max_abs:.3f} > 1. Recompute the scene "
                        "normalization or rerun with --on_overflow clip."
                    )
                print(f"[WARN] clipping '{im.name}' (|t_norm|={max_abs:.3f})")
                t_norm = np.clip(t_norm, -1.0, 1.0)

            cam = cameras[im.camera_id]
            K, distortion, is_fisheye = get_cam_intrinsics(cam)
            img_bgr = cv2.imread(str(update_path / "images" / im.name))
            if img_bgr is None:
                raise FileNotFoundError(f"Cannot read image: {im.name}")
            if np.any(distortion):
                und = (
                    cv2.fisheye.undistortImage(img_bgr, K, distortion)
                    if is_fisheye
                    else cv2.undistort(img_bgr, K, distortion)
                )
            else:
                und = img_bgr

            new_id = next_id
            next_id += 1
            cv2.imwrite(str(batch_dir / "rgbs" / f"{new_id:06d}.jpg"), und)

            c2w = np.zeros((3, 4), np.float32)
            c2w[:, :3] = R_saved
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
                batch_dir / "metadata" / f"{new_id:06d}.pt",
            )
            map_f.write(f"{im.name},{new_id:06d}.pt\n")
            manifest_items.append(
                {
                    "image_name": im.name,
                    "id": f"{new_id:06d}",
                    "camera_id": int(im.camera_id),
                    "undistort": "fisheye" if is_fisheye else "opencv",
                    "pose_rev": 0,
                }
            )
            added += 1

    with open(batch_dir / "manifest.json", "w") as f:
        json.dump({"batch_tag": hp.batch_tag, "count": added,
                   "items": manifest_items}, f, indent=2)
    print(f"[UPDATE] Added {added} new images to {batch_dir}")


if __name__ == "__main__":
    main()
