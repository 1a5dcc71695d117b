"""Full-frame and ray-batch rendering of the routed container, stratified
or occupancy-guided.

Port of ``acn_tpu/pipelines/renderer.py`` without an ``active_module``
(the soft-MoE paths): stratified over ``container_forward`` when there is no
``OccConfig``; with one, the strided per-ray march (``render_rays_occ``)
when ``P.occ_budget_per_ray`` is 0, else the packed-budget march
(``render_rays_occ_budget``). Chunking is over a fixed chunk size computed
exactly as in JAX; the last chunk is padded. Everything stays on the device
until the frame is done: no chunk synchronizes with the host.

The routed (per-expert) paths, the mesh fan-out and randomized sampling are
not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from acn_tpu_torch.models import container as cont
from acn_tpu_torch.models.container import Container, ContainerConfig
from acn_tpu_torch.models.nn import norm3
from acn_tpu_torch.nerfs import rays as raylib
from acn_tpu_torch.nerfs.render import bg_default_color, render_rays_stratified
from acn_tpu_torch.nerfs.render_occ import render_rays_occ, render_rays_occ_budget
from acn_tpu_torch.occupancy.grid import OccConfig


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when the card is asked for and there
    is none: an entry point never carries on quietly on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "acn_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU")
        # the reference's f32 products are full f32: keep TF32 off on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _pinhole_block_rays(rows: int, W: int, c2w, intr, aabb, nf, row0: float,
                        col0: float) -> torch.Tensor:
    """The (rows × W) pixel block's rays, generated on the device from the
    pose. Rays outside [near, far] are made inert (near 0, far −1)."""
    dev = c2w.device
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    j = (row0 + torch.arange(rows, dtype=torch.float32, device=dev))[:, None] + 0.5
    i = (col0 + torch.arange(W, dtype=torch.float32, device=dev))[None, :] + 0.5
    j = j.expand(rows, W)
    i = i.expand(rows, W)
    dirs = torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], dim=-1)
    dirs = dirs / torch.clamp(norm3(dirs), min=1e-12)
    rays = raylib.get_rays(dirs.reshape(-1, 3), c2w, aabb=aabb)
    near = torch.maximum(rays[:, 6], nf[0])
    far = torch.minimum(rays[:, 7], nf[1])
    valid = torch.isfinite(near) & torch.isfinite(far) & (far > near + 1e-6)
    rays[:, 6] = torch.where(valid, near, 0.0)
    rays[:, 7] = torch.where(valid, far, -1.0)  # inert
    return rays


class Renderer:
    """Renders a ``Container`` with its stacked occupancy states (ignored by
    the stratified path) on ``device`` (default: the card)."""

    def __init__(
        self,
        cfg: ContainerConfig,
        P,
        occ_cfg: Optional[OccConfig] = None,
        chunk_rays: Optional[int] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.P = P
        self.occ_cfg = occ_cfg
        self._chunk_override = None if chunk_rays is None else int(chunk_rays)
        self.chunk_rays = self._chunk_size(occ_cfg is not None)
        self.budget = int(getattr(P, "occ_budget_per_ray", 0) or 0)
        self.ray_samples = int(P.ray_samples)
        if occ_cfg is not None:
            # render-time bin resolution (serving may march coarser bins),
            # and the strided march's kept samples, scaled with ray_samples
            self.s_max = (int(getattr(P, "occ_render_s_max", 0) or 0)
                          or int(P.occ_s_max))
            self.s_kept = min(int(P.occ_s_kept), max(self.ray_samples, 8))

    def _chunk_size(self, use_occ: bool) -> int:
        """Rays per chunk, budgeting point-expert evals from
        P.chunk_points — ``acn_tpu``'s sizing, unchanged, so a chunk packs
        the same B samples as there."""
        if self._chunk_override is not None:
            return self._chunk_override
        P, cfg = self.P, self.cfg
        k = max(cfg.num_submodules, 1)
        if use_occ:
            budget = int(getattr(P, "occ_budget_per_ray", 0) or 0)
            s = budget if budget > 0 else min(
                max(int(P.ray_samples), 1),
                int(getattr(P, "occ_s_kept", P.ray_samples)),
            )
        else:
            s = max(int(P.ray_samples), 1)
        expert = getattr(cfg, "expert", None)
        corner = getattr(getattr(expert, "hash", None), "layout", "cell") == "corner"
        blow = 8 if corner else 1
        return max(1024, int(P.chunk_points) // (blow * k * max(s, 1)))

    # ---------------- chunk functions ----------------

    def _render_chunk(self, model: Container, occ_states, rays: torch.Tensor):
        """One chunk → (rgb (n,3), depth (n,), acc (n,), wmax (n,), went (n,));
        wmax and went (the entropy of the normalized weights) are the
        weight-shape statistics fog suppression reads."""
        n = rays.shape[0]
        if self.cfg.use_bg_nerf:
            bg = cont.background_color(model, rays[:, 3:6])
        else:
            bg = bg_default_color(n, self.P.bg_color_default, device=rays.device)
        if self.occ_cfg is None:
            rgb, depth, weights, acc = render_rays_stratified(
                lambda xd: cont.container_forward(model, xd), rays,
                self.ray_samples, bg_rgb=bg)
        elif self.budget > 0:
            rgb, depth, extras, acc = render_rays_occ_budget(
                model, occ_states, self.occ_cfg, rays, s_max=self.s_max,
                budget_per_ray=self.budget, alpha_thre=self.occ_cfg.alpha_thre,
                bg_rgb=bg)
            return rgb, depth, acc, extras["wmax"], extras["went"]
        else:
            rgb, depth, weights, acc = render_rays_occ(
                model, occ_states, self.occ_cfg, rays, s_max=self.s_max,
                s_kept=self.s_kept, alpha_thre=self.occ_cfg.alpha_thre, bg_rgb=bg)
        wsum = torch.clamp(torch.sum(weights, dim=1, keepdim=True), min=1e-12)
        p = weights / wsum
        went = -torch.sum(p * torch.log(torch.clamp(p, min=1e-12)), dim=1)
        return rgb, depth, acc, torch.amax(weights, dim=1), went

    def _frame_chunk(self, model, occ_states, W: int, rows: int, c2w, intr,
                     aabb, nf, row0: float, col0: float):
        """A (rows × W) block rendered from rays made on the device, with
        compact outputs quantized on the device: u8 rgb, f16 depth/acc."""
        rays = _pinhole_block_rays(rows, W, c2w, intr, aabb, nf, row0, col0)
        rgb, depth, acc, _, _ = self._render_chunk(model, occ_states, rays)
        rgb_u8 = torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.uint8)
        return rgb_u8, depth.to(torch.float16), acc.to(torch.float16)

    # ---------------- public API ----------------

    @torch.no_grad()
    def render_rays(
        self,
        model: Container,
        occ_states: Dict[str, torch.Tensor],
        rays: np.ndarray,  # (N, 8)
        *,
        with_stats: bool = False,
    ):
        """Chunked ray rendering → (rgb (N,3), depth (N,), acc (N,)) numpy,
        plus (wmax (N,), w_entropy (N,)) when ``with_stats``."""
        rays = np.asarray(rays, np.float32)
        N = rays.shape[0]
        C = self.chunk_rays
        outs = []
        for s in range(0, N, C):
            e = min(s + C, N)
            chunk = rays[s:e]
            if e - s < C:  # pad to the fixed chunk shape with inert rays
                pad = np.zeros((C - (e - s), 8), np.float32)
                pad[:, 7] = -1.0
                chunk = np.concatenate([chunk, pad])
            chunk_t = torch.from_numpy(chunk).to(self.device)
            outs.append([o[: e - s] for o in
                         self._render_chunk(model, occ_states, chunk_t)])
        if not outs:
            empty = (np.zeros((0, 3), np.float32),) + (np.zeros((0,), np.float32),) * 4
            return empty if with_stats else empty[:3]
        res = [torch.cat(parts).cpu().numpy() for parts in zip(*outs)]
        return tuple(res) if with_stats else tuple(res[:3])

    @torch.no_grad()
    def render_image(
        self,
        model: Container,
        occ_states: Dict[str, torch.Tensor],
        *,
        H: int,
        W: int,
        intrinsics,  # (4,) [fx, fy, cx, cy]
        c2w,  # (3, 4)
        aabb,  # (2, 3) scene box for per-ray near/far
        near_far_override=None,
        download: bool = True,
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], Optional[np.ndarray]]:
        """Full-frame render with rays made on the device. Returns (rgb
        (H,W,3) in [0,1] from the u8 frame, depth (H·W,), acc (H·W,)); with
        ``download=False`` the frame stays on the device, the call waits for
        it to be computed and returns ``(None, None, None)``."""
        dev = self.device
        rows = max(self.chunk_rays // W, 1)
        c2w_t = torch.as_tensor(np.asarray(c2w, np.float32), device=dev)
        intr_t = torch.as_tensor(np.asarray(intrinsics[:4], np.float32), device=dev)
        aabb_t = torch.as_tensor(np.asarray(aabb, np.float32), device=dev)
        n_o, f_o = (near_far_override or (None, None))
        nf_t = torch.tensor([n_o if n_o is not None else -np.inf,
                             f_o if f_o is not None else np.inf],
                            dtype=torch.float32, device=dev)

        pending = [
            self._frame_chunk(model, occ_states, W, rows, c2w_t, intr_t,
                              aabb_t, nf_t, float(r0), 0.0)
            for r0 in range(0, H, rows)
        ]
        if not download:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return None, None, None
        rgb_u8, depth, acc = (torch.cat(parts)[: H * W].cpu() for parts in
                              zip(*pending))
        rgb = (rgb_u8.numpy().astype(np.float32) / 255.0).reshape(H, W, 3)
        return (np.clip(rgb, 0.0, 1.0), depth.numpy().astype(np.float32),
                acc.numpy().astype(np.float32))
