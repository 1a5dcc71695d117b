"""Axis-aligned scene boxes as functions over ``(2, 3)`` tensors.

Port of ``acn_tpu/nerfs/scene_box.py`` (the parts the serving path and the
viewer use): an AABB is a ``(2, 3)`` float32 tensor ``[min, max]`` in the
world DRB convention, stackable to ``(K, 2, 3)``; an oriented box (the
viewer's crop) is the tuple (R (3, 3), T (3,), S (3,)): rotation, center and
full sizes.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Default slab-test tags (as in acn_tpu).
AABB_MAX_BOUND = 1e10
AABB_INVALID_VALUE = 1e10


def make_aabb(mins, maxs, device=None) -> torch.Tensor:
    """Build a (2, 3) AABB from min / max corners."""
    return torch.tensor([list(mins), list(maxs)], dtype=torch.float32,
                        device=device)


def ray_aabb_intersect(
    aabb: torch.Tensor,  # (2, 3)
    origins: torch.Tensor,  # (N, 3)
    directions: torch.Tensor,  # (N, 3)
    eps: float = 1e-8,
    max_bound: float = AABB_MAX_BOUND,
    invalid_value: float = AABB_INVALID_VALUE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized slab test: near-zero direction components become ±eps,
    t is clamped to [0, max_bound], rays with no forward hit get
    (invalid_value, invalid_value). Returns (t_min, t_max), each (N,)."""
    d_safe = torch.where(
        torch.abs(directions) < eps,
        torch.where(directions >= 0, eps, -eps).to(directions.dtype),
        directions,
    )
    inv = 1.0 / d_safe
    t0 = (aabb[0][None, :] - origins) * inv
    t1 = (aabb[1][None, :] - origins) * inv
    t_min = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_max = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_min = torch.clamp(t_min, 0.0, max_bound)
    t_max = torch.clamp(t_max, 0.0, max_bound)
    invalid = t_max <= t_min
    fill = torch.full_like(t_min, invalid_value)
    return torch.where(invalid, fill, t_min), torch.where(invalid, fill, t_max)


def within(aabb: torch.Tensor, pts: torch.Tensor,
           inclusive: bool = False) -> torch.Tensor:
    """Membership test of points (..., 3)."""
    if inclusive:
        return torch.all(pts >= aabb[0], dim=-1) & torch.all(pts <= aabb[1], dim=-1)
    return torch.all(pts > aabb[0], dim=-1) & torch.all(pts < aabb[1], dim=-1)


# ============================ oriented boxes ============================


def obb_from_params(pos, rpy, scale) -> tuple:
    """(R, T, S) from a position, roll / pitch / yaw in radians and full
    sizes, all float32: R = Rz(yaw) · Ry(pitch) · Rx(roll)."""
    r, p, y = (torch.as_tensor(v, dtype=torch.float32) for v in rpy)
    one, zero = torch.ones(()), torch.zeros(())
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    mat = lambda rows: torch.stack([torch.stack(row) for row in rows])
    Rz = mat([[cy, -sy, zero], [sy, cy, zero], [zero, zero, one]])
    Ry = mat([[cp, zero, sp], [zero, one, zero], [-sp, zero, cp]])
    Rx = mat([[one, zero, zero], [zero, cr, -sr], [zero, sr, cr]])
    return (Rz @ Ry @ Rx, torch.as_tensor(pos, dtype=torch.float32),
            torch.as_tensor(scale, dtype=torch.float32))


def obb_within(obb: tuple, pts: torch.Tensor) -> torch.Tensor:
    """Mask of the points (N, 3) strictly inside the oriented box."""
    R, T, S = (torch.as_tensor(v, dtype=torch.float32) for v in obb)
    local = (pts - T[None, :]) @ R  # Rᵀ x, row-wise
    half = S / 2.0
    return torch.all((local > -half[None, :]) & (local < half[None, :]), dim=-1)


def obb_to_aabb(obb: tuple) -> torch.Tensor:
    """The tight world-aligned (2, 3) box around the oriented box."""
    R, T, S = (torch.as_tensor(v, dtype=torch.float32) for v in obb)
    ext = torch.abs(R) @ (S / 2.0)
    return torch.stack([T - ext, T + ext])
