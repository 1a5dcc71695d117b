"""COLMAP sparse-model readers (binary and text) and camera intrinsics.

The port's own copy of ``acn_tpu/data/colmap.py`` (numpy only).

Counterpart of the reference's vendored ``data/colmap_utils.py``. Implements
the documented COLMAP sparse format (cameras/images/points3D in .bin or .txt,
https://colmap.github.io/format.html) with numpy records, plus the camera-
model → (K, distortion) mapping used by dataset preparation.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

# COLMAP camera model ids → (name, number of params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) w x y z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (P, 2)
    point3D_ids: np.ndarray  # (P,)


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(qvec) -> np.ndarray:
    """Quaternion (w, x, y, z) → 3×3 rotation (COLMAP convention,
    reference colmap_utils.py:73-92)."""
    w, x, y, z = [float(v) for v in qvec]
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R) -> np.ndarray:
    """3×3 rotation → quaternion (w, x, y, z)."""
    R = np.asarray(R, np.float64)
    K = (
        np.array(
            [
                [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
                [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
                [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
                [
                    R[2, 1] - R[1, 2],
                    R[0, 2] - R[2, 0],
                    R[1, 0] - R[0, 1],
                    R[0, 0] + R[1, 1] + R[2, 2],
                ],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


# ---------------------------- binary readers ----------------------------


def _read(fmt: str, f) -> tuple:
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            cam_id, model_id, w, h = _read("<iiQQ", f)
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f"<{n_params}d", f))
            cams[cam_id] = Camera(cam_id, name, int(w), int(h), params)
    return cams


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            img_id = _read("<i", f)[0]
            qvec = np.array(_read("<4d", f))
            tvec = np.array(_read("<3d", f))
            cam_id = _read("<i", f)[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read("<Q", f)
            data = np.frombuffer(f.read(24 * n_pts), dtype=np.float64).reshape(-1, 3)
            xys = data[:, :2].copy()
            ids = data[:, 2].view(np.int64)[:].copy()
            images[img_id] = ColmapImage(
                img_id, qvec, tvec, cam_id, name.decode("utf-8"), xys, ids
            )
    return images


def read_points3d_binary(path) -> Dict[int, Point3D]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read("<Q", f)
        for _ in range(n):
            pid = _read("<Q", f)[0]
            xyz = np.array(_read("<3d", f))
            rgb = np.array(_read("<3B", f))
            (err,) = _read("<d", f)
            (track_len,) = _read("<Q", f)
            track = np.frombuffer(f.read(8 * track_len), dtype=np.int32).reshape(-1, 2)
            pts[pid] = Point3D(pid, xyz, rgb, float(err), track[:, 0].copy(),
                               track[:, 1].copy())
    return pts


# ---------------------------- text readers ----------------------------


def _data_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path) -> Dict[int, Camera]:
    cams = {}
    for line in _data_lines(path):
        el = line.split()
        cam_id = int(el[0])
        cams[cam_id] = Camera(
            cam_id, el[1], int(el[2]), int(el[3]), np.array([float(x) for x in el[4:]])
        )
    return cams


def read_images_text(path) -> Dict[int, ColmapImage]:
    images = {}
    lines = list(_data_lines(path))
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        img_id = int(el[0])
        qvec = np.array([float(x) for x in el[1:5]])
        tvec = np.array([float(x) for x in el[5:8]])
        cam_id = int(el[8])
        name = el[9]
        el2 = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(x) for x in el2]).reshape(-1, 3) if el2 else np.zeros((0, 3))
        images[img_id] = ColmapImage(
            img_id, qvec, tvec, cam_id, name,
            xys[:, :2] if len(xys) else np.zeros((0, 2)),
            xys[:, 2].astype(np.int64) if len(xys) else np.zeros((0,), np.int64),
        )
    return images


def read_points3d_text(path) -> Dict[int, Point3D]:
    pts = {}
    for line in _data_lines(path):
        el = line.split()
        pid = int(el[0])
        xyz = np.array([float(x) for x in el[1:4]])
        rgb = np.array([int(x) for x in el[4:7]])
        err = float(el[7])
        track = np.array([int(x) for x in el[8:]]).reshape(-1, 2)
        pts[pid] = Point3D(pid, xyz, rgb, err,
                           track[:, 0] if len(track) else np.zeros((0,), np.int64),
                           track[:, 1] if len(track) else np.zeros((0,), np.int64))
    return pts


def read_model(path, ext: Optional[str] = None):
    """Read a COLMAP sparse model directory → (cameras, images, points3D)
    (reference colmap_utils.py:299-325)."""
    path = Path(path)
    if ext is None:
        ext = ".bin" if (path / "cameras.bin").exists() else ".txt"
    if ext == ".bin":
        cameras = read_cameras_binary(path / "cameras.bin")
        images = read_images_binary(path / "images.bin")
        p3d_path = path / "points3D.bin"
        points3d = read_points3d_binary(p3d_path) if p3d_path.exists() else {}
    else:
        cameras = read_cameras_text(path / "cameras.txt")
        images = read_images_text(path / "images.txt")
        p3d_path = path / "points3D.txt"
        points3d = read_points3d_text(p3d_path) if p3d_path.exists() else {}
    return cameras, images, points3d


# ---------------------------- intrinsics mapping ----------------------------


def get_cam_intrinsics(cam: Camera) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Camera model → (K 3×3, distortion coeffs, is_fisheye)
    (reference colmap_utils.py:326-404). Distortion is OpenCV-ordered
    (k1, k2, p1, p2[, k3, ...]) or fisheye (k1..k4)."""
    p = cam.params
    m = cam.model
    if m == "SIMPLE_PINHOLE":
        f, cx, cy = p
        K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]])
        return K, np.zeros(4), False
    if m == "PINHOLE":
        fx, fy, cx, cy = p
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        return K, np.zeros(4), False
    if m == "SIMPLE_RADIAL":
        f, cx, cy, k = p
        K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]])
        return K, np.array([k, 0, 0, 0]), False
    if m == "RADIAL":
        f, cx, cy, k1, k2 = p
        K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]])
        return K, np.array([k1, k2, 0, 0]), False
    if m == "OPENCV":
        fx, fy, cx, cy, k1, k2, p1, p2 = p
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        return K, np.array([k1, k2, p1, p2]), False
    if m == "OPENCV_FISHEYE":
        fx, fy, cx, cy, k1, k2, k3, k4 = p
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        return K, np.array([k1, k2, k3, k4]), True
    if m == "FULL_OPENCV":
        fx, fy, cx, cy = p[:4]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        return K, np.asarray(p[4:]), False
    raise NotImplementedError(f"Unsupported COLMAP camera model: {m}")
