"""Occupancy grids and budget-packed ray marching.

Port of ``acn_tpu/occupancy/grid.py`` (the packed-budget path's part):
``OccConfig``, ``level_aabbs``, ``init_occ_state``, ``occupancy_lookup`` and
``march_rays_budget`` with bin midpoints or the counter-hash jitter
(``_u01``) and no coarse range-finding pre-pass. The grid update, the
strided ``march_rays`` and ``coarse_ray_range`` are not ported. An occupancy
state is a dict of tensors: ``occs`` (L, R, R, R) f32, ``binaries``
(L, R, R, R) bool and ``aabbs`` (L, 2, 3); the container's per-expert states
carry a leading K axis.

JAX's dropping scatter (``.at[i].set(v, mode="drop")``) becomes a scatter
into a target with one spill slot at the end, sliced off afterwards.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import torch


@dataclass(frozen=True)
class OccConfig:
    """The fields of ``acn_tpu``'s ``OccConfig`` that marching and rendering
    read, with its defaults. The training step marches fixed grids; the
    fields of the grid update (EMA decay, annealing, update cadence) come
    with ``update_occ_grid``."""

    resolution: int = 128
    levels: int = 1
    alpha_thre: float = 1e-2
    near_plane: float = 0.05
    far_plane: float = 1e3


def level_aabbs(roi_aabb: torch.Tensor, levels: int) -> torch.Tensor:
    """(levels, 2, 3): level l = roi scaled by 2^l around its center."""
    c = 0.5 * (roi_aabb[0] + roi_aabb[1])
    half = 0.5 * (roi_aabb[1] - roi_aabb[0])
    scales = 2.0 ** torch.arange(levels, dtype=torch.float32,
                                 device=roi_aabb.device)
    mins = c[None, :] - half[None, :] * scales[:, None]
    maxs = c[None, :] + half[None, :] * scales[:, None]
    return torch.stack([mins, maxs], dim=1)


def init_occ_state(roi_aabb: torch.Tensor, cfg: OccConfig) -> Dict[str, torch.Tensor]:
    """Fresh (empty) occupancy state for one expert, on roi_aabb's device."""
    R, L = cfg.resolution, cfg.levels
    dev = roi_aabb.device
    return {
        "occs": torch.zeros((L, R, R, R), dtype=torch.float32, device=dev),
        "binaries": torch.zeros((L, R, R, R), dtype=torch.bool, device=dev),
        "aabbs": level_aabbs(roi_aabb.to(torch.float32), L),
    }


def occupancy_lookup(state: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Occupied? for world points x (..., 3) using the finest level whose
    AABB contains each point. Points outside all levels → False."""
    aabbs = state["aabbs"]  # (L, 2, 3)
    binaries = state["binaries"]  # (L, R, R, R)
    L, R = binaries.shape[0], binaries.shape[1]

    occupied = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    assigned = torch.zeros_like(occupied)
    for l in range(L):
        mn, mx = aabbs[l, 0], aabbs[l, 1]
        u = (x - mn) / (mx - mn)
        inside = torch.all((u >= 0.0) & (u < 1.0), dim=-1)
        # truncate toward zero, then clip (JAX's astype(int32) + clip); the
        # float clamp first keeps far-outside points (masked anyway) from
        # overflowing the integer conversion
        idx = torch.clamp(torch.clamp(u * R, -1.0, float(R)).to(torch.int64),
                          0, R - 1)
        val = binaries[l, idx[..., 0], idx[..., 1], idx[..., 2]]
        take = inside & ~assigned
        occupied = torch.where(take, val, occupied)
        assigned = assigned | inside
    return occupied


@functools.lru_cache(maxsize=None)
def bin_edges(s_max: int, device: torch.device) -> torch.Tensor:
    """(1, s_max+1) float32 fractions 0..1 — ``jnp.linspace``'s values.

    Built on the CPU and moved, so the bins (and with them every discrete
    occupancy and hash decision) are the same bits on the card as on the
    CPU; ``torch.linspace`` on the CPU equals ``jnp.linspace`` at these
    sizes (17, 33, 65, 129, 257 points). Cached per (s_max, device): the
    blocking host-to-device copy happens once, not in every chunk."""
    return torch.linspace(0.0, 1.0, s_max + 1, dtype=torch.float32)[None, :].to(device)


_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2³² for int64 ``h`` in [0, 2³²) and a constant below 2³²,
    in two halves so that no product leaves int64 (h · c can reach 2⁶⁴)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _u01(idx: torch.Tensor, salt: Union[int, torch.Tensor]) -> torch.Tensor:
    """Counter hash of non-negative integer ``idx`` and a salt → U[0, 1) in
    float32 with 24 random bits: ``acn_tpu``'s ``_u01``
    (``acn_tpu/occupancy/grid.py:483-488``) bit for bit. There it is uint32
    arithmetic with wraparound; here int64, masked to 32 bits after every
    multiply and before every shift."""
    h = _mul32((idx.to(torch.int64) + salt) & _M32, 0x9E3779B1)
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def march_rays_budget(
    state: Dict[str, torch.Tensor],
    rays: torch.Tensor,  # (N, 8)
    cfg: OccConfig,
    s_max: int,
    budget_per_ray: int,
    extra_valid_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    salt: Optional[Union[int, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Occupancy marching with a global cross-ray sample budget.

    ``s_max`` uniform bins span each ray's [near, far]; a bin is valid when
    its midpoint is occupied (and ``extra_valid_fn`` agrees). All valid bins
    of the batch pack ray-major into ONE buffer of B = N·budget_per_ray
    slots through a two-level prefix count; samples past B are dropped
    batch-tail-first and ``overflow`` reports the dropped fraction, exactly
    as ``acn_tpu`` does. The pack moves one flat index per kept sample; the
    B rows rebuild their geometry from (ray, bin) arithmetic.

    Returns {xd (B, 6), t0_b/t1_b (B,), ray_id (B,), slot_real (B,),
    ray_start (N,), gpos (N, s_max), valid (N, s_max), t_starts/t_ends
    (N, s_max), overflow (0-dim)}. Nothing here synchronizes with the host.
    """
    o, d = rays[:, :3], rays[:, 3:6]
    near, far = rays[:, 6], rays[:, 7]
    near = torch.clamp(near, min=cfg.near_plane)
    far = torch.clamp(far, max=cfg.far_plane)
    far = torch.maximum(far, near)

    N = rays.shape[0]
    B = N * int(budget_per_ray)
    dev = rays.device

    e = bin_edges(s_max, dev)
    edges = near[:, None] * (1.0 - e) + far[:, None] * e
    t0, t1 = edges[:, :-1], edges[:, 1:]
    flat_ids = (
        torch.arange(N, dtype=torch.int64, device=dev)[:, None] * s_max
        + torch.arange(s_max, dtype=torch.int64, device=dev)[None, :]
    )  # (N, s_max)
    u = 0.5 if salt is None else _u01(flat_ids, salt)
    t_s = t0 + u * (t1 - t0)
    x = o[:, None, :] + d[:, None, :] * t_s[..., None]  # (N, s_max, 3)

    valid = (t1 > t0) & occupancy_lookup(state, x)
    if extra_valid_fn is not None:
        valid = valid & extra_valid_fn(x)

    # two-level prefix count: within-ray ranks + an exclusive scan over rays
    counts = torch.sum(valid, dim=1)  # (N,) int64
    ray_start = torch.cumsum(counts, 0) - counts
    rank = torch.cumsum(valid, dim=1) - 1
    gpos = ray_start[:, None] + rank  # global rank among valid samples
    n_valid = ray_start[-1] + counts[-1]

    keep = valid & (gpos < B)
    slot = torch.where(keep, gpos, B).reshape(-1)  # B = spill slot
    buffer_idx = torch.zeros(B + 1, dtype=torch.int64, device=dev).scatter_(
        0, slot, flat_ids.reshape(-1))[:B]

    # B-row geometry reconstruction (elementwise, O(B))
    rid = buffer_idx // s_max
    sl = buffer_idx - rid * s_max
    nr, fr = near[rid], far[rid]
    inv_s = 1.0 / s_max
    e0 = sl.to(torch.float32) * inv_s
    e1 = e0 + inv_s
    t0_b = nr * (1.0 - e0) + fr * e0
    t1_b = nr * (1.0 - e1) + fr * e1
    u_b = 0.5 if salt is None else _u01(buffer_idx, salt)
    t_sb = t0_b + u_b * (t1_b - t0_b)
    d_b = d[rid]
    xd = torch.cat([o[rid] + d_b * t_sb[:, None], d_b], dim=-1)

    slot_real = torch.arange(B, device=dev) < torch.clamp(n_valid, max=B)
    overflow = torch.clamp(n_valid - B, min=0) / torch.clamp(n_valid, min=1)
    return {
        "xd": xd,
        "t0_b": t0_b,
        "t1_b": t1_b,
        "ray_id": rid,
        "slot_real": slot_real,
        "ray_start": ray_start,
        "gpos": gpos,
        "valid": keep,
        "t_starts": t0,
        "t_ends": t1,
        "overflow": overflow,
    }
