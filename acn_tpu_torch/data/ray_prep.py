"""Host-side (numpy) ray preparation for the dataset loaders.

Port of ``acn_tpu/data/ray_prep.py``, copied whole: building every pixel ray
of hundreds of images is a one-time host job that runs in worker processes,
so it is plain numpy, the twin of ``nerfs/rays.py``. Its results equal
``acn_tpu``'s bit for bit (``tests/test_torch_dataset.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

AABB_MAX_BOUND = 1e10
AABB_INVALID_VALUE = 1e10


def get_ray_directions_np(
    H: int, W: int, fx, fy, cx, cy, center_pixels: bool = True
) -> np.ndarray:
    """Unit camera-frame directions (H, W, 3), RUB pinhole
    (reference ray_sampling.py:111-136)."""
    j, i = np.meshgrid(
        np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij"
    )
    if center_pixels:
        i = i + 0.5
        j = j + 0.5
    dirs = np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], axis=-1)
    norm = np.clip(np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-12, None)
    return (dirs / norm).astype(np.float32)


def ray_aabb_intersect_np(
    aabb: np.ndarray,  # (2, 3)
    origins: np.ndarray,  # (N, 3)
    directions: np.ndarray,  # (N, 3)
    eps: float = 1e-8,
    max_bound: float = AABB_MAX_BOUND,
    invalid_value: float = AABB_INVALID_VALUE,
) -> Tuple[np.ndarray, np.ndarray]:
    """Slab test (reference scene_box.py:45-107), numpy."""
    d_safe = np.where(
        np.abs(directions) < eps, np.where(directions >= 0, eps, -eps), directions
    )
    inv = 1.0 / d_safe
    t0 = (aabb[0][None] - origins) * inv
    t1 = (aabb[1][None] - origins) * inv
    t_min = np.minimum(t0, t1).max(axis=-1)
    t_max = np.maximum(t0, t1).min(axis=-1)
    t_min = np.clip(t_min, 0.0, max_bound)
    t_max = np.clip(t_max, 0.0, max_bound)
    invalid = t_max <= t_min
    t_min[invalid] = invalid_value
    t_max[invalid] = invalid_value
    return t_min, t_max


def get_rays_np(
    directions: np.ndarray,  # (H, W, 3) or (N, 3)
    c2w: np.ndarray,  # (3, 4)
    aabb: Optional[np.ndarray] = None,
    near: Optional[float] = None,
    far: Optional[float] = None,
) -> np.ndarray:
    """Packed rays (..., 8) (reference ray_sampling.py:50-108), numpy."""
    shape = directions.shape[:-1]
    flat = directions.reshape(-1, 3)
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    d = (flat @ R.T).astype(np.float32)
    o = np.broadcast_to(t.astype(np.float32), d.shape)

    if aabb is not None:
        tmin, tmax = ray_aabb_intersect_np(np.asarray(aabb, np.float32), o, d)
        near_v, far_v = tmin[:, None], tmax[:, None]
    else:
        assert near is not None and far is not None
        near_v = np.full((len(d), 1), near, np.float32)
        far_v = np.full((len(d), 1), far, np.float32)

    rays = np.concatenate([o, d, near_v, far_v], axis=-1).astype(np.float32)
    return rays.reshape(*shape, 8)


def clamp_rays_near_far_np(
    rays: np.ndarray,
    near_far_override: Optional[Tuple[Optional[float], Optional[float]]],
    eps: float = 1e-6,
) -> Tuple[np.ndarray, np.ndarray]:
    """(reference ray_sampling.py:139-176), numpy; mutates a copy."""
    near = rays[:, 6].copy()
    far = rays[:, 7].copy()
    if near_far_override is not None:
        n_o, f_o = near_far_override
        if n_o is not None:
            near = np.maximum(near, np.float32(n_o))
        if f_o is not None:
            far = np.minimum(far, np.float32(f_o))
    valid = np.isfinite(near) & np.isfinite(far) & (far > near + eps)
    if near_far_override is not None:
        near[~valid] = np.inf
        far[~valid] = np.inf
        rays = rays.copy()
        rays[:, 6] = near
        rays[:, 7] = far
    return rays, valid
