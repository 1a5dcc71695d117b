"""Occupancy grids, their EMA update, and ray marching.

Port of ``acn_tpu/occupancy/grid.py``: ``OccConfig``, ``level_aabbs``,
``init_occ_state``, ``cell_centers``, ``_anneal_alpha_thre``,
``update_occ_grid``, ``occupancy_lookup``, the compactions
``compact_samples`` and ``compact_samples_strided``, the per-ray strided
``march_rays`` (with ``report_budget``) and the packed ``march_rays_budget``
with bin midpoints or the counter-hash jitter (``_u01``), and the camera
prune ``mark_invisible_cells``. Not ported: ``march_t_schedule`` and
``coarse_ray_range``. An
occupancy state is a dict of tensors: ``occs`` (L, R, R, R) f32,
``binaries`` (L, R, R, R) bool and ``aabbs`` (L, 2, 3); the container's
per-expert states carry a leading K axis.

Randomness is injected: JAX draws from a key, the port takes the draws
(``u``, ``phase_bits``, ``jitter``) as tensors, or ``draw_march`` /
a ``torch.Generator`` makes them. Given JAX's own draws the port marches the
same samples.

JAX's dropping scatter (``.at[i].set(v, mode="drop")``) becomes a scatter
into a target with one spill slot at the end, sliced off afterwards.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from acn_tpu_torch.models.nn import norm3

# points per density block of the grid update, as in acn_tpu
UPDATE_BLOCK = 262_144


@dataclass(frozen=True)
class OccConfig:
    """``acn_tpu``'s ``OccConfig``, with its defaults."""

    resolution: int = 128
    levels: int = 1
    occ_thre: float = 1e-2
    ema_decay: float = 0.95
    warmup_steps: int = 256
    update_interval: int = 16
    alpha_thre: float = 1e-2
    alpha_thre_start: float = 0.0
    cosine_anneal: bool = True
    cone_angle: float = 1.0 / 256.0
    near_plane: float = 0.05
    far_plane: float = 1e3
    render_step_size: Optional[float] = None  # None ⇒ diag(roi)/1000

    def step_size_for(self, aabb) -> float:
        if self.render_step_size is not None:
            return float(self.render_step_size)
        ext = np.asarray(aabb[1], np.float32) - np.asarray(aabb[0], np.float32)
        return float(np.linalg.norm(ext) / 1000.0)

    def step_size_for_traced(self, aabb: torch.Tensor) -> torch.Tensor:
        """diag(aabb)/1000 as a 0-dim tensor on the aabb's device (no host
        sync), unless ``render_step_size`` overrides it."""
        if self.render_step_size is not None:
            return torch.tensor(self.render_step_size, dtype=torch.float32,
                                device=aabb.device)
        return norm3(aabb[1] - aabb[0])[0] / 1000.0


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


def cell_centers(state: Dict[str, torch.Tensor], cfg: OccConfig) -> torch.Tensor:
    """(L, R³, 3) world-space cell centers per level."""
    R = cfg.resolution
    dev = state["aabbs"].device
    r = torch.arange(R, device=dev)
    idx = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
    u = (idx.to(torch.float32) + 0.5) / R  # cell-center unit coords
    aabbs = state["aabbs"]  # (L, 2, 3)
    return aabbs[:, 0][:, None, :] + u[None, :, :] * (
        aabbs[:, 1] - aabbs[:, 0])[:, None, :]


def _anneal_alpha_thre(cfg: OccConfig, step) -> torch.Tensor:
    """Alpha-threshold ramp start → end over the warm-up, cosine or linear,
    as a 0-dim float32 tensor (``step`` may be a number or a tensor)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    t = torch.clamp(step / max(1, cfg.warmup_steps - 1), 0.0, 1.0)
    mix = 0.5 * (1.0 - torch.cos(math.pi * t)) if cfg.cosine_anneal else t
    return (1.0 - mix) * cfg.alpha_thre_start + mix * cfg.alpha_thre


def update_occ_grid(
    state: Dict[str, torch.Tensor],
    density_fn: Callable[[torch.Tensor], torch.Tensor],  # (M, 3) world → (M,) σ
    cfg: OccConfig,
    step_size,
    jitter: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """One EMA occupancy update over every cell, as ``acn_tpu`` does it.

    occ ← max(occ · decay, σ(x) · step_size) where occ ≥ 0 (cells marked
    invisible, occ < 0, stay as they are), at x = cell center + jitter · cell
    size; binaries = occ > max(min(occ_thre, mean occ over visible cells),
    1e-6). ``jitter`` (L, R³, 3) in [−0.5, 0.5) is injected, or drawn from
    ``generator`` (on its device); one of the two is required.

    The densities are evaluated in blocks of ``UPDATE_BLOCK`` points, the
    last one padded with zeros, without autograd: the peak is one block's."""
    L, R = cfg.levels, cfg.resolution
    centers = cell_centers(state, cfg)  # (L, R³, 3)
    cell_size = (state["aabbs"][:, 1] - state["aabbs"][:, 0]) / R  # (L, 3)
    if jitter is None:
        if generator is None:
            raise ValueError("update_occ_grid needs a jitter tensor or a generator")
        jitter = torch.rand(centers.shape, generator=generator,
                            device=generator.device) - 0.5
    x = (centers + jitter.to(centers.device) * cell_size[:, None, :]).reshape(-1, 3)

    m = x.shape[0]
    pad = (-m) % UPDATE_BLOCK
    x_pad = torch.cat([x, x.new_zeros((pad, 3))])
    with torch.no_grad():
        sigma = torch.cat([density_fn(b) for b in x_pad.split(UPDATE_BLOCK)])[:m]
    new_occ = sigma.reshape(L, R * R * R).to(torch.float32) * step_size

    occs = state["occs"].reshape(L, -1)
    visible = occs >= 0.0
    updated = torch.maximum(occs * cfg.ema_decay, new_occ)
    occs = torch.where(visible, updated, occs)

    mean_occ = torch.sum(torch.where(visible, occs, 0.0)) / torch.clamp(
        torch.sum(visible), min=1)
    # floor the threshold: occ = σ·Δ < 1e-6 ⇒ alpha < 1e-6, always skippable
    thre = torch.clamp(torch.clamp(mean_occ, max=cfg.occ_thre), min=1e-6)
    return {
        "occs": occs.reshape(L, R, R, R),
        "binaries": (occs > thre).reshape(L, R, R, R),
        "aabbs": state["aabbs"],
    }


INVISIBLE_BLOCK = 65536  # cells per block of mark_invisible_cells


def mark_invisible_cells(
    state: Dict[str, torch.Tensor],
    K_mats: torch.Tensor,  # (C, 3, 3) intrinsics
    c2w_rdf: torch.Tensor,  # (C, 3, 4) camera-to-world, RDF camera basis
    width: int,
    height: int,
    near_plane: float = 0.0,
    cfg: OccConfig = OccConfig(),
) -> Dict[str, torch.Tensor]:
    """Mark the cells no camera sees with occ = −1 (a one-time prune; the
    update never raises them again) and clear their binaries.

    A cell is seen by a camera when its center lies in front of it (depth
    above ``near_plane``) and projects inside the image, ``0 ≤ u < width``
    and ``0 ≤ v < height``. Both 3×3 products are written out as three
    products summed in index order, the order of ``acn_tpu``'s einsums, so
    that a center on the image border falls on the same side; the cells are
    taken in blocks of ``INVISIBLE_BLOCK`` against every camera."""
    centers = cell_centers(state, cfg).reshape(-1, 3)  # (M, 3)
    R_wc = c2w_rdf[:, :3, :3]  # (C, 3, 3) cam → world
    t_wc = c2w_rdf[:, :3, 3]  # (C, 3)
    seen_any = []
    for xb in centers.split(INVISIBLE_BLOCK):
        rel = xb[None, :, :] - t_wc[:, None, :]  # (C, B, 3)
        # world → camera: x_cam[j] = Σ_i R[i, j] · rel[i]
        x_cam = (rel[..., 0:1] * R_wc[:, None, 0, :] + rel[..., 1:2] * R_wc[:, None, 1, :]
                 + rel[..., 2:3] * R_wc[:, None, 2, :])
        z = x_cam[..., 2]  # RDF: +z forward
        # uvw[i] = Σ_j K[i, j] · x_cam[j]
        uvw = (x_cam[..., 0:1] * K_mats[:, None, :, 0] + x_cam[..., 1:2] * K_mats[:, None, :, 1]
               + x_cam[..., 2:3] * K_mats[:, None, :, 2])
        zs = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
        u, v = uvw[..., 0] / zs, uvw[..., 1] / zs
        seen = (z > near_plane) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
        seen_any.append(seen.any(dim=0))
    visible = torch.cat(seen_any).reshape(state["occs"].shape)
    occs = torch.where(visible, state["occs"], -1.0)
    return {"occs": occs, "binaries": state["binaries"] & (occs >= 0),
            "aabbs": state["aabbs"]}


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
def unit_linspace(n: int, device: torch.device) -> torch.Tensor:
    """(1, n) float32 fractions 0..1, ``jnp.linspace(0, 1, n)``'s bits: XLA
    takes i · (1/(n−1)) in float32 and sets the last to 1 (``torch.linspace``
    differs from it by an ulp at most sizes, 96 among them).

    Built on the CPU and moved, so the bins (and with them every discrete
    occupancy and hash decision) are the same bits on the card as on the
    CPU. Cached per (n, device): the blocking host-to-device copy happens
    once, not in every chunk."""
    if n == 1:
        return torch.zeros((1, 1), device=device)
    i = torch.arange(n - 1, dtype=torch.float32)
    frac = torch.cat([i * torch.tensor(1.0 / (n - 1), dtype=torch.float32),
                      torch.ones(1)])
    return frac[None, :].to(device)


def ray_bins(rays: torch.Tensor, cfg: OccConfig, s_max: int):
    """(o, d, near, far, t0, t1): the rays' clamped [near, far] cut into
    ``s_max`` uniform bins [t0, t1) (N, s_max); an invalid ray gets an empty
    interval."""
    o, d = rays[:, :3], rays[:, 3:6]
    near = torch.clamp(rays[:, 6], min=cfg.near_plane)
    far = torch.clamp(rays[:, 7], max=cfg.far_plane)
    far = torch.maximum(far, near)
    e = unit_linspace(s_max + 1, rays.device)  # bin edges as fractions
    edges = near[:, None] * (1.0 - e) + far[:, None] * e
    return o, d, near, far, edges[:, :-1], edges[:, 1:]


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
    o, d, near, far, t0, t1 = ray_bins(rays, cfg, s_max)
    N = rays.shape[0]
    B = N * int(budget_per_ray)
    dev = rays.device

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


# ============================ per-ray compaction ============================


def _scatter_kept(pos: torch.Tensor, s_kept: int) -> torch.Tensor:
    """(N, s_kept) int64: row n holds at slot ``pos[n, j]`` the bin index j,
    and 0 where no bin lands; slots ≥ ``s_kept`` are dropped (JAX's
    ``.at[p].set(s, mode="drop")``, here a spill column sliced off)."""
    n, s_max = pos.shape
    src = torch.arange(s_max, device=pos.device).expand(n, s_max)
    out = torch.zeros((n, s_kept + 1), dtype=torch.int64, device=pos.device)
    return out.scatter_(1, torch.clamp(pos, max=s_kept), src)[:, :s_kept]


def compact_samples(valid: torch.Tensor, s_kept: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray stable compaction: the bin indices of the first ``s_kept``
    valid samples (N, s_kept) and their validity mask."""
    counts = torch.cumsum(valid, dim=1)  # inclusive prefix counts
    pos = torch.where(valid, counts - 1, s_kept)
    kept_valid = (torch.arange(s_kept, device=valid.device)[None, :]
                  < counts[:, -1:])
    return _scatter_kept(pos, s_kept), kept_valid


def compact_samples_strided(
    valid: torch.Tensor, s_kept: int, phase_bits: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Even-stride compaction: keep every ⌈n_valid/s_kept⌉-th valid sample
    of each ray, from a phase in [0, stride).

    ``phase_bits`` (N,) integers in [0, 2³⁰) give the phase as
    ``phase_bits % stride`` (JAX's ``randint(key, (N,), 0, 1 << 30)``);
    None is phase 0. Returns (idx (N, s_kept) int64, mask (N, s_kept) bool,
    scale (N,) f32 = the stride, by which the renderer widens each kept
    interval so that the expected opacity stays unbiased)."""
    n = valid.shape[0]
    counts = torch.cumsum(valid, dim=1)  # inclusive
    n_valid = counts[:, -1]
    stride = torch.clamp(-torch.div(-n_valid, s_kept, rounding_mode="floor"), min=1)

    rank = counts - 1  # a valid sample's rank among the valid ones
    phase = (torch.zeros(n, dtype=torch.int64, device=valid.device)
             if phase_bits is None else phase_bits.to(valid.device) % stride)
    rel = rank - phase[:, None]
    take = valid & (rel >= 0) & (torch.remainder(rel, stride[:, None]) == 0)
    slot = torch.div(rel, stride[:, None], rounding_mode="floor")  # < s_kept
    idx = _scatter_kept(torch.where(take, slot, s_kept), s_kept)

    kept = torch.clamp(-torch.div(-(n_valid - phase), stride, rounding_mode="floor"),
                       min=0)
    mask = torch.arange(s_kept, device=valid.device)[None, :] < kept[:, None]
    return idx, mask, stride.to(torch.float32)


def draw_march(n: int, s_max: int, generator: torch.Generator):
    """One strided march's draws from ``generator``, on its device: (u
    (n, s_max) in [0, 1), phase_bits (n,) in [0, 2³⁰))."""
    dev = generator.device
    return (torch.rand((n, s_max), generator=generator, device=dev),
            torch.randint(0, 1 << 30, (n,), generator=generator, device=dev))


def strided_samples(t0, t1, x, valid, s_kept: int,
                    phase_bits: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The strided compaction of candidate bins [t0, t1) (N, s_max) with
    sample points x (N, s_max, 3) and validity: {t_starts, t_ends (N, s_kept)
    the kept bins, dts their stride-widened widths (use these for opacity),
    positions (N, s_kept, 3), mask (N, s_kept)}."""
    idx, mask, scale = compact_samples_strided(valid, s_kept, phase_bits)
    t0k = torch.gather(t0, 1, idx)
    t1k = torch.gather(t1, 1, idx)
    xk = torch.gather(x, 1, idx[..., None].expand(-1, -1, 3))
    return {"t_starts": t0k, "t_ends": t1k, "dts": (t1k - t0k) * scale[:, None],
            "positions": xk, "mask": mask}


def march_rays(
    state: Dict[str, torch.Tensor],
    rays: torch.Tensor,  # (N, 8)
    cfg: OccConfig,
    s_max: int,
    s_kept: int,
    u: Optional[torch.Tensor] = None,
    phase_bits: Optional[torch.Tensor] = None,
    extra_valid_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    report_budget: int = 0,
) -> Dict[str, torch.Tensor]:
    """Occupancy-guided marching to a fixed (N, s_kept) layout.

    ``s_max`` uniform bins span each ray's [near, far]; a bin is valid when
    its sample point (at fraction ``u`` (N, s_max) of the bin, or its
    midpoint) is occupied and ``extra_valid_fn`` agrees; the strided
    compaction keeps ``s_kept`` of them per ray (``strided_samples``).
    ``report_budget > 0`` adds ``overflow``, the share of valid candidates
    that ``march_rays_budget`` WOULD drop at that budget per ray on this
    batch (the auto-regime switch reads it)."""
    o, d, _, _, t0, t1 = ray_bins(rays, cfg, s_max)
    t_s = t0 + (0.5 if u is None else u) * (t1 - t0)
    x = o[:, None, :] + d[:, None, :] * t_s[..., None]  # (N, s_max, 3)

    valid = (t1 > t0) & occupancy_lookup(state, x)
    if extra_valid_fn is not None:
        valid = valid & extra_valid_fn(x)
    out = strided_samples(t0, t1, x, valid, s_kept, phase_bits)
    if report_budget > 0:
        n_valid = torch.sum(valid)
        cap = rays.shape[0] * int(report_budget)
        out["overflow"] = torch.clamp(n_valid - cap, min=0) / torch.clamp(n_valid, min=1)
    return out
