"""The baked serving path: the trained field distilled into a dense voxel
table, rendered with no hash lookup or MLP per sample.

Port of ``acn_tpu/pipelines/baking.py``:

* ``bake_field`` evaluates a field over the R³ lattice of a box, in chunks
  of ``chunk`` points (the last padded), averaging σ over ``bake_dirs``
  Fibonacci directions and either averaging the color (``sh_degree`` 0) or
  projecting it on the real SH-1 basis by least squares through a host
  ``pinv`` (degree 1, at least 8 directions); ``supersample`` s averages an
  s³ sub-lattice of each voxel's neighborhood. The table is assembled on the
  host, chunk by chunk.
* ``pack_baked`` derives the marching occupancy: σ max-pooled onto the
  occupancy grid, thresholded, dilated by one cell along each axis with a
  wrap-around roll. ``bake_container`` bakes the soft-MoE container through
  ``render_occ._soft_moe_eval``.
* ``save_baked`` / ``load_baked`` write and read the same ``.npz`` keys and
  dtypes as ``acn_tpu``, so each package reads the other's asset.
* ``trilinear_lookup`` (8 gathered rows per sample), ``pack_zpairs`` and
  ``trilinear_lookup_zpair`` (4 rows, both z corners in one), summed over
  the corners in ``acn_tpu``'s order.
* ``render_baked_rays``: with a budget, ``march_rays_budget`` (with the
  ``coarse_ray_range`` pre-pass when ``s_coarse`` > 0) over the baked grid,
  one lookup per packed sample and ``composite_packed`` (one segmented scan
  per call); with budget 0, the strided ``march_rays`` over max(4·s_max,
  128) bins kept to ``s_max`` and fixed-layout compositing (no scan).
* ``BakedRenderer``: frames in fixed row chunks with rays made on the
  device, the z-pair table by default, ``random`` backgrounds served white.

Assets live on a device: ``load_baked`` and ``pack_baked`` put the table and
grid on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from acn_tpu_torch.nerfs.render import (
    bg_default_color,
    composite,
    composite_packed,
    render_weights_from_density,
)
from acn_tpu_torch.occupancy import grid as occ_grid
from acn_tpu_torch.occupancy.grid import OccConfig
from acn_tpu_torch.pipelines.renderer import (
    _pinhole_block_rays,
    _slot,
    frame_outputs,
    resolve_device,
)


# ============================ baking ============================


def _lattice_points(aabb: np.ndarray, R: int, flat_lo: int, flat_hi: int) -> np.ndarray:
    """Lattice points [flat_lo, flat_hi) of the R³ grid, in x-major flat
    order (ix·R + iy)·R + iz, on the host."""
    idx = np.arange(flat_lo, flat_hi, dtype=np.int64)
    iz = idx % R
    iy = (idx // R) % R
    ix = idx // (R * R)
    u = np.stack([ix, iy, iz], axis=-1).astype(np.float32) / max(R - 1, 1)
    lo, hi = np.asarray(aabb[0], np.float32), np.asarray(aabb[1], np.float32)
    return lo + u * (hi - lo)


def fibonacci_dirs(n: int) -> np.ndarray:
    """n roughly uniform unit directions (a Fibonacci sphere)."""
    i = np.arange(n, dtype=np.float32) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)], axis=-1
    ).astype(np.float32)


# real SH basis constants (degree 0 and the three degree-1 terms)
_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199


def sh1_basis(dirs):
    """(…, 3) unit directions → (…, 4) real-SH basis [Y00, Y1-1, Y10, Y11]
    = [c0, c1·y, c1·z, c1·x], float32: a tensor for a tensor, numpy for
    numpy (the bake's host projection)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    if isinstance(dirs, np.ndarray):
        return np.stack([np.full_like(x, _SH_C0), _SH_C1 * y, _SH_C1 * z, _SH_C1 * x],
                        axis=-1).astype(np.float32)
    return torch.stack([torch.full_like(x, _SH_C0), _SH_C1 * y, _SH_C1 * z, _SH_C1 * x],
                       dim=-1)


def decode_sh1(coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """(B, 12) SH-1 coefficients ([4 basis × 3 rgb], basis-major) and (B, 3)
    view directions → (B, 3) rgb in [0, 1]."""
    rgb = torch.einsum("bk,bkc->bc", sh1_basis(dirs), coeffs.reshape(-1, 4, 3))
    return torch.clamp(rgb, 0.0, 1.0)


@torch.no_grad()
def bake_field(
    field_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    aabb,  # (2, 3)
    resolution: int,
    *,
    bake_dirs: int = 4,
    chunk: int = 2**18,
    occ_resolution: int = 128,
    occ_thre: float = 5e-3,
    sh_degree: int = 0,
    supersample: int = 1,
    device=None,
) -> Dict[str, Any]:
    """Evaluate ``field_fn`` ((M, 6) [xyz, dir] → (σ (M,), rgb (M, 3)), on
    ``device``, default the card) over the R³ lattice of ``aabb`` → the
    baked asset (``pack_baked``'s dict, on the same device).

    The table has F = 4 channels [rgb, σ] (``sh_degree`` 0) or 13 [12 SH-1
    color coefficients, σ]; σ is the mean over the directions."""
    device = resolve_device(device)
    R = int(resolution)
    sh_degree = int(sh_degree)
    if sh_degree not in (0, 1):
        raise ValueError(f"sh_degree must be 0 or 1, got {sh_degree}")
    aabb_np = np.asarray(aabb, np.float32)
    ss = max(int(supersample), 1)
    if ss > 1:
        sub = (np.stack(np.meshgrid(*([np.arange(ss, dtype=np.float32)] * 3), indexing="ij"),
                        axis=-1).reshape(-1, 3) + 0.5) / ss - 0.5
        voxel = (aabb_np[1] - aabb_np[0]) / max(R - 1, 1)
        sub_w = torch.from_numpy((sub * voxel[None, :]).astype(np.float32)).to(device)
    n_dirs = max(int(bake_dirs), 1 if sh_degree == 0 else 8)
    dirs_np = fibonacci_dirs(n_dirs)
    dirs = torch.from_numpy(dirs_np).to(device)
    if sh_degree:
        # least squares rgb(d) ≈ Σ_k coeff_k · Y_k(d): coeffs = pinv(B) @ rgb
        # over the sampled directions, on the host
        proj = torch.from_numpy(
            np.linalg.pinv(sh1_basis(dirs_np)).astype(np.float32)).to(device)  # (4, D)

    def eval_chunk(x):  # (C, 3) → (C, F)
        C = x.shape[0]
        if ss > 1:  # the voxel's sub-lattice, averaged below
            x = (x[:, None, :] + sub_w[None, :, :]).reshape(-1, 3)
        sigs, rgbs = [], []
        for d in dirs:
            sigma, rgb = field_fn(torch.cat([x, d.expand_as(x)], dim=-1))
            if ss > 1:
                sigma = torch.mean(sigma.reshape(C, ss**3), dim=1)
                rgb = torch.mean(rgb.reshape(C, ss**3, 3), dim=1)
            sigs.append(sigma)
            rgbs.append(rgb)
        sig = torch.mean(torch.stack(sigs), dim=0)[:, None]
        rgb = torch.stack(rgbs)  # (D, C, 3)
        if sh_degree == 0:
            return torch.cat([torch.mean(rgb, dim=0), sig], dim=-1)
        coef = torch.einsum("kd,dcj->ckj", proj, rgb)  # (C, 4, 3)
        return torch.cat([coef.reshape(C, 12), sig], dim=-1)

    n = R * R * R
    F = 4 if sh_degree == 0 else 13
    table = np.empty((n, F), np.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        x = _lattice_points(aabb_np, R, s, e)
        if e - s < chunk:  # pad to the fixed chunk
            x = np.concatenate([x, np.zeros((chunk - (e - s), 3), np.float32)])
        out = eval_chunk(torch.from_numpy(x).to(device))
        table[s:e] = out[: e - s].to(torch.float32).cpu().numpy()
    return pack_baked(table, aabb_np, R, occ_resolution=occ_resolution,
                      occ_thre=occ_thre, sh_degree=sh_degree, device=device)


def pack_baked(table: np.ndarray, aabb: np.ndarray, R: int, *,
               occ_resolution: int = 128, occ_thre: float = 5e-3,
               sh_degree: int = 0, device=None) -> Dict[str, Any]:
    """The serving asset from a raw (R³, F) table (σ in the last channel):
    degree-0 colors clipped to [0, 1] (SH coefficients stay as they are;
    ``decode_sh1`` clips), and the marching occupancy, σ max-pooled onto the
    occupancy grid (at the bake's resolution when that does not divide it),
    above ``occ_thre``, dilated by one cell with a wrap-around roll (a
    voxel's support spans its neighbors). On ``device``, default the card."""
    device = resolve_device(device)
    sigma = table[:, -1].reshape(R, R, R)
    Ro = int(min(occ_resolution, R))
    f = R // Ro
    if f * Ro != R:
        Ro, f = R, 1
    pooled = sigma.reshape(Ro, f, Ro, f, Ro, f).max(axis=(1, 3, 5))
    occ = pooled > occ_thre
    for ax in (0, 1, 2):
        occ = occ | np.roll(occ, 1, ax) | np.roll(occ, -1, ax)
    occ_cfg = OccConfig(resolution=Ro, levels=1)
    return _asset(table if sh_degree else np.concatenate(
        [np.clip(table[:, :3], 0.0, 1.0), table[:, 3:4]], axis=-1),
        aabb, R, sh_degree, occ[None], occ_cfg, device)


def _asset(table, aabb, R, sh_degree, binaries, occ_cfg, device) -> Dict[str, Any]:
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32)).to(device)
    state = occ_grid.init_occ_state(aabb_t, occ_cfg)
    state["binaries"] = torch.as_tensor(np.asarray(binaries, bool)).to(device)
    return {"table": torch.as_tensor(np.asarray(table, np.float32)).to(device),
            "aabb": aabb_t, "resolution": int(R), "sh_degree": int(sh_degree),
            "occ_state": state, "occ_cfg": occ_cfg}


def bake_container(model, *, resolution: int, aabb=None, bake_dirs: int = 4,
                   chunk: int = 2**18, occ_resolution: int = 128, occ_thre: float = 5e-3,
                   sh_degree: int = 0, supersample: int = 1) -> Dict[str, Any]:
    """Bake the soft-MoE container over ``aabb`` (default its global box) on
    the model's device, with the σ-weighted expert blend of the live
    renderer (``render_occ._soft_moe_eval``)."""
    from acn_tpu_torch.nerfs.render_occ import _soft_moe_eval

    if aabb is None:
        aabb = model.global_aabb.detach().cpu().numpy()
    return bake_field(lambda xd: _soft_moe_eval(model, xd), aabb, resolution,
                      bake_dirs=bake_dirs, chunk=chunk, occ_resolution=occ_resolution,
                      occ_thre=occ_thre, sh_degree=sh_degree, supersample=supersample,
                      device=model.global_aabb.device)


def save_baked(path, baked: Dict[str, Any]) -> None:
    """Write the asset as one ``.npz`` (a temporary file, then renamed), with
    ``acn_tpu``'s keys and dtypes."""
    tmp = str(path) + ".tmp"
    np.savez_compressed(
        tmp,
        table=baked["table"].detach().cpu().numpy().astype(np.float32),
        aabb=baked["aabb"].detach().cpu().numpy().astype(np.float32),
        resolution=np.int32(baked["resolution"]),
        occ_binaries=baked["occ_state"]["binaries"].detach().cpu().numpy(),
        occ_resolution=np.int32(baked["occ_cfg"].resolution),
        sh_degree=np.int32(baked.get("sh_degree", 0)),
    )
    # numpy appends .npz to a name without it
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", str(path))


def load_baked(path, device=None) -> Dict[str, Any]:
    """An asset that either package wrote, on ``device`` (default the card)."""
    device = resolve_device(device)
    with np.load(path) as z:
        occ_cfg = OccConfig(resolution=int(z["occ_resolution"]), levels=1)
        return _asset(z["table"], z["aabb"], int(z["resolution"]),
                      int(z["sh_degree"]) if "sh_degree" in z else 0,
                      z["occ_binaries"], occ_cfg, device)


# ============================ serving ============================


def _cell(aabb: torch.Tensor, R: int, x: torch.Tensor, dtype):
    """The lattice cell of each point and its fraction in it: (base flat
    index (B,), f (B, 3))."""
    lo, hi = aabb[0], aabb[1]
    u = (x - lo) / torch.clamp(hi - lo, min=1e-12) * (R - 1)
    u = torch.clamp(u, 0.0, R - 1 - 1e-4)
    i0 = torch.floor(u).to(torch.int64)
    f = (u - i0.to(u.dtype)).to(dtype)
    return (i0[:, 0] * R + i0[:, 1]) * R + i0[:, 2], f


def trilinear_lookup(table: torch.Tensor, aabb: torch.Tensor, R: int,
                     x: torch.Tensor) -> torch.Tensor:
    """(B, 3) positions → (B, F) by trilinear interpolation of the flat
    (R³, F) table (values at the lattice points): 8 gathered rows."""
    base, f = _cell(aabb, R, x, table.dtype)
    out = None
    for cx in (0, 1):
        wx = (1.0 - f[:, 0]) if cx == 0 else f[:, 0]
        for cy in (0, 1):
            wy = (1.0 - f[:, 1]) if cy == 0 else f[:, 1]
            for cz in (0, 1):
                wz = (1.0 - f[:, 2]) if cz == 0 else f[:, 2]
                v = table[base + (cx * R + cy) * R + cz]
                w = (wx * wy * wz)[:, None]
                out = v * w if out is None else out + v * w
    return out


def pack_zpairs(table: torch.Tensor, R: int) -> torch.Tensor:
    """(R³, F) → (R³, 2F): row i carries [v(i), v(i + ẑ)], so both z
    corners of a cell come in one gathered row."""
    nxt = torch.cat([table[1:], table[-1:]], dim=0)
    return torch.cat([table, nxt], dim=-1)


def trilinear_lookup_zpair(table2: torch.Tensor, aabb: torch.Tensor, R: int,
                           x: torch.Tensor) -> torch.Tensor:
    """``trilinear_lookup`` over a ``pack_zpairs`` table: 4 gathered rows,
    the z lerp inside each."""
    F = table2.shape[-1] // 2
    base, f = _cell(aabb, R, x, table2.dtype)
    fz = f[:, 2:3]
    out = None
    for cx in (0, 1):
        wx = (1.0 - f[:, 0]) if cx == 0 else f[:, 0]
        for cy in (0, 1):
            wy = (1.0 - f[:, 1]) if cy == 0 else f[:, 1]
            v2 = table2[base + (cx * R + cy) * R]
            v = v2[:, :F] * (1.0 - fz) + v2[:, F:] * fz
            w = (wx * wy)[:, None]
            out = v * w if out is None else out + v * w
    return out


def _lookup(baked: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    if "table_z" in baked:
        v = trilinear_lookup_zpair(baked["table_z"], baked["aabb"], baked["resolution"], x)
    else:
        v = trilinear_lookup(baked["table"], baked["aabb"], baked["resolution"], x)
    return v.to(torch.float32)


def render_baked_rays(
    baked: Dict[str, Any],
    rays: torch.Tensor,  # (N, 8)
    *,
    s_max: int = 128,
    budget_per_ray: int = 32,
    alpha_thre: float = 0.0,
    bg_rgb: Optional[torch.Tensor] = None,
    s_coarse: int = 0,
):
    """Render rays of the baked table at bin midpoints (no caller jitters a
    frozen asset). With ``budget_per_ray`` > 0: the packed march over the
    baked grid (the range pre-pass with ``s_coarse``), one lookup per packed
    sample, an SH-1 decode in the packed view direction,
    ``composite_packed``; returns (rgb, depth, extras {wmax, went}, acc).
    With 0: the unbiased strided march over max(4·s_max, 128) bins kept to
    ``s_max`` and fixed-layout compositing; returns (rgb, depth, weights,
    acc)."""
    sh1 = int(baked.get("sh_degree", 0)) == 1
    if budget_per_ray == 0:
        samples = occ_grid.march_rays(baked["occ_state"], rays, baked["occ_cfg"],
                                      max(s_max * 4, 128), s_max)
        x = samples["positions"]  # (N, S, 3)
        N, S = x.shape[0], x.shape[1]
        v = _lookup(baked, x.reshape(-1, 3)).reshape(N, S, -1)
        if sh1:
            d = rays[:, None, 3:6].expand_as(x).reshape(-1, 3)
            rgbs = decode_sh1(v.reshape(-1, v.shape[-1])[:, :12], d).reshape(N, S, 3)
        else:
            rgbs = v[..., :3]
        sigmas = torch.clamp(v[..., -1], min=0.0)
        mask = samples["mask"]
        if alpha_thre > 0.0:
            alpha = 1.0 - torch.exp(-sigmas * torch.clamp(samples["dts"], min=0.0))
            mask = mask & (alpha >= alpha_thre)
        weights, _ = render_weights_from_density(
            samples["t_starts"], samples["t_ends"], sigmas, sample_mask=mask,
            dts=samples["dts"])
        t_mid = 0.5 * (samples["t_starts"] + samples["t_ends"])
        rgb_map, depth, acc = composite(weights, rgbs, t_mid, bg_rgb=bg_rgb)
        return rgb_map, depth, weights, acc

    samples = occ_grid.march_rays_budget(baked["occ_state"], rays, baked["occ_cfg"],
                                         s_max, budget_per_ray, s_coarse=s_coarse)
    v = _lookup(baked, samples["xd"][:, :3])
    # interpolating then decoding equals decoding then interpolating (both linear)
    rgb = decode_sh1(v[:, :12], samples["xd"][:, 3:6]) if sh1 else v[:, :3]
    rgb_map, depth, acc, extras = composite_packed(
        torch.clamp(v[:, -1], min=0.0), rgb, samples, rays.shape[0], bg_rgb=bg_rgb,
        alpha_thre=alpha_thre)
    return rgb_map, depth, extras, acc


class BakedRenderer:
    """Frames of a baked asset, with the dispatch of ``Renderer``: rays made
    on the device, fixed row chunks of ``chunk_points // (per-ray samples ·
    W)`` rows, one wait at the end; the asset's device is the renderer's."""

    def __init__(self, baked: Dict[str, Any], *, s_max: int = 128,
                 budget_per_ray: int = 32, chunk_points: int = 4_000_000,
                 bg_color: str = "white", zpair: bool = True, s_coarse: int = 0):
        if zpair and "table_z" not in baked:
            baked = {**baked, "table_z": pack_zpairs(baked["table"], baked["resolution"])}
        self.baked = baked
        self.device = baked["table"].device
        self.s_max = int(s_max)
        self.budget = int(budget_per_ray)
        self.s_coarse = int(s_coarse)
        self.chunk_points = int(chunk_points)
        # a 'random' background is a training regularizer; a frozen asset
        # is served deterministically
        self.bg_color = "white" if bg_color == "random" else bg_color
        # the serving table: the z-pair one when there is one
        self._served = {k: v for k, v in baked.items()
                        if not (k == "table" and "table_z" in baked)}

    def rows(self, W: int) -> int:
        per_ray = self.budget if self.budget > 0 else self.s_max
        return max(self.chunk_points // (per_ray * W), 1)

    def _block(self, rows: int, W: int, cam, row0: float):
        rays = _pinhole_block_rays(rows, W, *cam, row0, 0.0)
        bg = bg_default_color(rays.shape[0], self.bg_color, device=rays.device)
        rgb, depth, _, acc = render_baked_rays(
            self._served, rays, s_max=self.s_max, budget_per_ray=self.budget, bg_rgb=bg,
            s_coarse=self.s_coarse)
        rgb_u8 = torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.uint8)
        return rgb_u8, depth.to(torch.float16), acc.to(torch.float16)

    @torch.no_grad()
    def render_image(self, *, H: int, W: int, intrinsics, c2w, near_far_override=None,
                     download: bool = True, mesh=None):
        """The frame → (rgb (H, W, 3) in [0, 1] from u8, depth (H·W,), acc
        (H·W,)), or ``(None, None, None)`` with ``download=False`` once the
        card is done. ``mesh``: the row-block fan-out of
        ``Renderer.render_image`` over its ranks."""
        dev = self.device
        rows = self.rows(W)
        slot, n_dev = _slot(mesh)
        n_o, f_o = (near_far_override or (None, None))
        cam = (torch.as_tensor(np.asarray(c2w, np.float32), device=dev),
               torch.as_tensor(np.asarray(intrinsics[:4], np.float32), device=dev),
               self.baked["aabb"],
               torch.tensor([n_o if n_o is not None else -np.inf,
                             f_o if f_o is not None else np.inf],
                            dtype=torch.float32, device=dev))
        pending = [self._block(rows, W, cam, float(r0 + slot * rows))
                   for r0 in range(0, H, rows * n_dev)]
        if not download:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return None, None, None
        rgb_u8, depth, acc = frame_outputs(mesh, pending, H * W)
        rgb = rgb_u8.numpy().astype(np.float32) / 255.0
        return (np.clip(rgb, 0, 1).reshape(H, W, 3), depth.numpy().astype(np.float32),
                acc.numpy().astype(np.float32))
