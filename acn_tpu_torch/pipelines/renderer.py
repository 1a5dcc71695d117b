"""Full-frame and ray-batch rendering of the routed container, stratified
or occupancy-guided, dense or per expert rectangle.

Port of ``acn_tpu/pipelines/renderer.py`` (all but the mesh fan-out). A
chunk is dispatched by (occupancy?, expert, budget) as in JAX: without
occupancy, stratified over ``container_forward`` (one expert's when
``active_module`` is set); with it, the soft-MoE packed-budget march
(``render_rays_occ_budget``) or the strided one (``render_rays_occ``), or
for one expert its own grid through ``render_expert_occ_budget`` (with the
``occ_render_s_coarse`` range pre-pass) or ``render_expert_occ``.
``render_image_routed`` renders each expert only over the image rectangle
its box projects to, and stitches the rectangles on the host weighted by
opacity. Chunking is over a fixed chunk size computed exactly as in JAX;
the last chunk is padded. Everything stays on the device until the frame is
done: no chunk synchronizes with the host.

Randomness (the ``random`` background, ``randomized`` sampling) comes from
``RenderDraws``: a ``torch.Generator`` on the device (a seed-0 one when none
is given, as JAX's default ``PRNGKey(0)``), or a function through which a
test replays JAX's per-chunk keys. ``mesh=`` raises: the row-block fan-out
over several cards is ROADMAP.md M11.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from acn_tpu_torch.models import container as cont
from acn_tpu_torch.models.container import Container, ContainerConfig
from acn_tpu_torch.models.nn import norm3
from acn_tpu_torch.nerfs import rays as raylib
from acn_tpu_torch.nerfs.render import bg_default_color, render_rays_stratified
from acn_tpu_torch.nerfs.render_occ import (
    render_expert_occ,
    render_expert_occ_budget,
    render_rays_occ,
    render_rays_occ_budget,
)
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


def refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "rendering over a device mesh (the row-block fan-out) is not ported: "
            "ROADMAP.md M11")


class RenderDraws:
    """The random draws of one render call, asked for by chunk:
    ``get(what, c, shape)`` for dispatched chunk ``c`` (in dispatch order),
    ``what`` one of "bg" (the ``random`` background, (n, 3)), "salt" (the
    budget march's, 0-dim), "u" and "phase" (the strided march's jitter
    (n, s_max) and phase bits (n,)) and "strat_u" (the stratified jitter
    (n, ray_samples)).

    ``draws``: a ``torch.Generator``, None (a generator on ``device`` seeded
    with 0), or a function ``fn(what, c, shape)`` returning the draw.
    ``acn_tpu`` splits its key once per chunk (``key, k = split(key)``), the
    chunk's key into (background, render), and the strided march's render
    key into (jitter, phase)."""

    def __init__(self, draws, device: torch.device):
        self.device = device
        if draws is None:
            draws = torch.Generator(device=device).manual_seed(0)
        if isinstance(draws, torch.Generator):
            gen = draws

            def draws(what, c, shape):
                if what == "salt":
                    return torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device)
                if what == "phase":
                    return torch.randint(0, 1 << 30, shape, generator=gen, device=gen.device)
                return torch.rand(shape, generator=gen, device=gen.device)
        elif not callable(draws):
            raise TypeError("draws: None, a torch.Generator or a function, "
                            f"not {type(draws).__name__}")
        self.fn: Callable = draws

    def get(self, what: str, c: int, shape):
        x = self.fn(what, c, tuple(shape))
        return x if isinstance(x, int) else torch.as_tensor(x).to(self.device)


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
            # the strided march's kept samples (scaled with ray_samples in
            # each call), and the single-expert path's range pre-pass
            self.s_max = (int(getattr(P, "occ_render_s_max", 0) or 0)
                          or int(P.occ_s_max))
            self.s_kept = self._s_kept(self.ray_samples)
            self.s_coarse = int(getattr(P, "occ_render_s_coarse", 0) or 0)

    def _s_kept(self, ray_samples: int) -> int:
        """The strided march's kept samples: the viewer's preview halves
        ``ray_samples`` and the march keeps fewer with it."""
        return min(int(self.P.occ_s_kept), max(int(ray_samples), 8))

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

    def _render_chunk(self, model: Container, occ_states, rays: torch.Tensor, *,
                      use_occ: bool, active_module: Optional[int] = None,
                      randomized: bool = False, ray_samples: Optional[int] = None,
                      rnd: Optional[RenderDraws] = None, c: int = 0):
        """Chunk ``c`` → (rgb (n,3), depth (n,), acc (n,), wmax (n,), went
        (n,)); wmax and went (the entropy of the normalized weights) are the
        weight-shape statistics fog suppression reads. ``rnd`` gives the
        chunk's draws (the ``random`` background; with ``randomized``, the
        sampling's)."""
        n = rays.shape[0]
        ray_samples = int(ray_samples or self.ray_samples)
        policy = self.P.bg_color_default
        if self.cfg.use_bg_nerf:
            bg = cont.background_color(model, rays[:, 3:6])
        elif policy == "random":
            bg = bg_default_color(n, policy, u=rnd.get("bg", c, (n, 3)))
        else:
            bg = bg_default_color(n, policy, device=rays.device)
        draw = (lambda what, shape: rnd.get(what, c, shape)) if randomized else (
            lambda what, shape: None)

        if not use_occ:
            rgb, depth, weights, acc = render_rays_stratified(
                lambda xd: cont.container_forward(model, xd, active_module=active_module),
                rays, ray_samples, u=draw("strat_u", (n, ray_samples)), bg_rgb=bg)
        else:
            occ_cfg = self.occ_cfg
            if self.budget > 0:
                salt = draw("salt", ())
                if active_module is None:
                    rgb, depth, extras, acc = render_rays_occ_budget(
                        model, occ_states, occ_cfg, rays, s_max=self.s_max,
                        budget_per_ray=self.budget, alpha_thre=occ_cfg.alpha_thre,
                        salt=salt, bg_rgb=bg)
                else:
                    rgb, depth, extras, acc = render_expert_occ_budget(
                        model, {k: v[active_module] for k, v in occ_states.items()},
                        occ_cfg, rays, active_module=active_module, s_max=self.s_max,
                        budget_per_ray=self.budget, alpha_thre=occ_cfg.alpha_thre,
                        salt=salt, bg_rgb=bg, s_coarse=self.s_coarse)
                return rgb, depth, acc, extras["wmax"], extras["went"]
            common = dict(s_max=self.s_max, s_kept=self._s_kept(ray_samples),
                          alpha_thre=occ_cfg.alpha_thre, u=draw("u", (n, self.s_max)),
                          phase_bits=draw("phase", (n,)), bg_rgb=bg)
            if active_module is None:
                rgb, depth, weights, acc = render_rays_occ(
                    model, occ_states, occ_cfg, rays, **common)
            else:
                rgb, depth, weights, acc = render_expert_occ(
                    model, {k: v[active_module] for k, v in occ_states.items()},
                    occ_cfg, rays, active_module=active_module, **common)
        wsum = torch.clamp(torch.sum(weights, dim=1, keepdim=True), min=1e-12)
        p = weights / wsum
        went = -torch.sum(p * torch.log(torch.clamp(p, min=1e-12)), dim=1)
        return rgb, depth, acc, torch.amax(weights, dim=1), went

    def _frame_chunk(self, model, occ_states, W: int, rows: int, cam, row0: float,
                     col0: float, **chunk_kw):
        """A (rows × W) block at (row0, col0) rendered from rays made on the
        device, with compact outputs quantized on the device: u8 rgb, f16
        depth/acc."""
        rays = _pinhole_block_rays(rows, W, *cam, row0, col0)
        rgb, depth, acc, _, _ = self._render_chunk(model, occ_states, rays, **chunk_kw)
        rgb_u8 = torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.uint8)
        return rgb_u8, depth.to(torch.float16), acc.to(torch.float16)

    def _camera(self, c2w, intrinsics, aabb, near_far_override):
        """(c2w, intrinsics, aabb, [near, far]) as tensors on the device: the
        frame's only uploads."""
        dev = self.device
        n_o, f_o = (near_far_override or (None, None))
        return (torch.as_tensor(np.asarray(c2w, np.float32), device=dev),
                torch.as_tensor(np.asarray(intrinsics[:4], np.float32), device=dev),
                torch.as_tensor(np.asarray(aabb, np.float32), device=dev),
                torch.tensor([n_o if n_o is not None else -np.inf,
                              f_o if f_o is not None else np.inf],
                             dtype=torch.float32, device=dev))

    def _use_occ(self, use_occ: Optional[bool]) -> bool:
        use_occ = (self.occ_cfg is not None) if use_occ is None else bool(use_occ)
        if use_occ and self.occ_cfg is None:
            raise ValueError("use_occ=True needs a Renderer built with an OccConfig")
        return use_occ

    # ---------------- public API ----------------

    @torch.no_grad()
    def render_rays(
        self,
        model: Container,
        occ_states: Dict[str, torch.Tensor],
        rays: np.ndarray,  # (N, 8)
        *,
        draws=None,
        use_occ: Optional[bool] = None,
        active_module: Optional[int] = None,
        randomized: bool = False,
        with_stats: bool = False,
        ray_samples: Optional[int] = None,
    ):
        """Chunked ray rendering → (rgb (N,3), depth (N,), acc (N,)) numpy,
        plus (wmax (N,), w_entropy (N,)) when ``with_stats``.
        ``active_module`` renders one expert (on its own grid with
        occupancy); ``randomized`` jitters the samples with draws from
        ``draws`` (as ``RenderDraws`` takes them), which also give a
        ``random`` background."""
        use_occ = self._use_occ(use_occ)
        rnd = RenderDraws(draws, self.device)
        rays = np.asarray(rays, np.float32)
        N = rays.shape[0]
        C = self._chunk_size(use_occ)
        outs = []
        for c, s in enumerate(range(0, N, C)):
            e = min(s + C, N)
            chunk = rays[s:e]
            if e - s < C:  # pad to the fixed chunk shape with inert rays
                pad = np.zeros((C - (e - s), 8), np.float32)
                pad[:, 7] = -1.0
                chunk = np.concatenate([chunk, pad])
            chunk_t = torch.from_numpy(chunk).to(self.device)
            outs.append([o[: e - s] for o in self._render_chunk(
                model, occ_states, chunk_t, use_occ=use_occ, active_module=active_module,
                randomized=randomized, ray_samples=ray_samples, rnd=rnd, c=c)])
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
        draws=None,
        active_module: Optional[int] = None,
        use_occ: Optional[bool] = None,
        near_far_override=None,
        ray_samples: Optional[int] = None,
        download: bool = True,
        mesh=None,
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], Optional[np.ndarray]]:
        """Full-frame render with rays made on the device, by all experts or
        by ``active_module`` alone (the viewer's single-expert preview, with
        ``ray_samples`` scaling the strided march's kept samples). Returns
        (rgb (H,W,3) in [0,1] from the u8 frame, depth (H·W,), acc (H·W,));
        with ``download=False`` the frame stays on the device, the call waits
        for it to be computed and returns ``(None, None, None)``. ``draws``
        (``RenderDraws``) gives a ``random`` background its colors."""
        refuse_mesh(mesh)
        use_occ = self._use_occ(use_occ)
        rows = max(self._chunk_size(use_occ) // W, 1)
        cam = self._camera(c2w, intrinsics, aabb, near_far_override)
        rnd = RenderDraws(draws, self.device)
        pending = [
            self._frame_chunk(model, occ_states, W, rows, cam, float(r0), 0.0,
                              use_occ=use_occ, active_module=active_module,
                              ray_samples=ray_samples, rnd=rnd, c=c)
            for c, r0 in enumerate(range(0, H, rows))
        ]
        if not download:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return None, None, None
        rgb_u8, depth, acc = (torch.cat(parts)[: H * W].cpu() for parts in
                              zip(*pending))
        rgb = (rgb_u8.numpy().astype(np.float32) / 255.0).reshape(H, W, 3)
        return (np.clip(rgb, 0.0, 1.0), depth.numpy().astype(np.float32),
                acc.numpy().astype(np.float32))

    # ---------------- routed (per-expert rect) frame rendering ----------------

    @staticmethod
    def _expert_rects(expert_aabbs: np.ndarray, c2w, intrinsics, H: int,
                      W: int, pad_px: int) -> np.ndarray:
        """Project each expert's AABB into the image → conservative pixel
        rects (K, 4) [r0, r1, c0, c1) (half-open), padded by ``pad_px`` and
        clipped. An AABB that holds the camera, or with a corner behind (or
        on) the camera plane, projects to the full frame."""
        c2w = np.asarray(c2w, np.float32)
        R, t = c2w[:3, :3], c2w[:3, 3]
        fx, fy, cx, cy = [float(v) for v in np.asarray(intrinsics[:4])]
        rects = np.zeros((expert_aabbs.shape[0], 4), np.int64)
        for k, ab in enumerate(np.asarray(expert_aabbs, np.float32)):
            lo, hi = ab[0], ab[1]
            corners = np.array(
                [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                 for z in (lo[2], hi[2])], np.float32
            )
            cam = (corners - t) @ R  # R^T (X - t), row-vector form
            zneg = -cam[:, 2]
            inside = np.all(corners.min(0) <= t) and np.all(t <= corners.max(0))
            if inside or np.any(zneg <= 1e-6):
                rects[k] = (0, H, 0, W)  # conservative: full frame
                continue
            i = cx + fx * cam[:, 0] / zneg
            j = cy - fy * cam[:, 1] / zneg
            rects[k] = (
                max(int(np.floor(j.min())) - pad_px, 0),
                min(int(np.ceil(j.max())) + 1 + pad_px, H),
                max(int(np.floor(i.min())) - pad_px, 0),
                min(int(np.ceil(i.max())) + 1 + pad_px, W),
            )
        return rects

    @staticmethod
    def _feather_weights(rect, H, W, blend_px: int) -> np.ndarray:
        """(rows, cols) stitching weights for one rect: 1 in the interior,
        linear ramp to 0 over ``blend_px`` at rect edges that are not image
        borders."""
        r0, r1, c0, c1 = [int(v) for v in rect]
        rr = np.arange(r0, r1, dtype=np.float32)
        cc = np.arange(c0, c1, dtype=np.float32)
        one_r = np.ones_like(rr)
        one_c = np.ones_like(cc)
        b = max(float(blend_px), 1.0)
        wr_lo = one_r if r0 <= 0 else np.clip((rr - r0 + 1.0) / b, 0.0, 1.0)
        wr_hi = one_r if r1 >= H else np.clip((r1 - rr) / b, 0.0, 1.0)
        wc_lo = one_c if c0 <= 0 else np.clip((cc - c0 + 1.0) / b, 0.0, 1.0)
        wc_hi = one_c if c1 >= W else np.clip((c1 - cc) / b, 0.0, 1.0)
        return np.minimum(wr_lo, wr_hi)[:, None] * np.minimum(wc_lo, wc_hi)[None, :]

    def routed_dispatch(self, rects: np.ndarray, W: int, use_occ: bool):
        """The routed frame's chunks in dispatch order: (k, row0, rows of the
        chunk inside the rect, col0, crop width, chunk rows). Single-expert
        chunks carry K× the rays of a dense one; the crop width is quantized
        to 128 px and re-anchored inside the frame; a chunk's rows are capped
        by the rect's height quantized to 64."""
        chunk = self._chunk_size(use_occ) * max(self.cfg.num_submodules, 1)
        out = []
        for k in range(rects.shape[0]):
            r0k, r1k, c0k, c1k = [int(v) for v in rects[k]]
            if r1k <= r0k or c1k <= c0k:
                continue
            W_crop = min(W, int(np.ceil((c1k - c0k) / 128.0)) * 128)
            c0k = max(0, min(c0k, W - W_crop))
            rows = max(chunk // W_crop, 1)
            rows = min(rows, int(np.ceil((r1k - r0k) / 64.0)) * 64)
            for r0 in range(r0k, r1k, rows):
                out.append((k, r0, min(rows, r1k - r0), c0k, W_crop, rows))
        return out

    def routed_rects(self, expert_aabbs: np.ndarray, c2w, intrinsics, H: int, W: int,
                     blend_px: int) -> np.ndarray:
        """The experts' rects, with the widest one widened to the full frame
        when some pixel lies in none (rays that miss every region see pure
        background)."""
        rects = self._expert_rects(expert_aabbs, c2w, intrinsics, H, W, pad_px=blend_px)
        ws = np.zeros((H, W), np.float32)
        for k in range(rects.shape[0]):
            r0, r1, c0, c1 = rects[k]
            ws[r0:r1, c0:c1] += 1.0
        if (ws <= 0).any():
            areas = (rects[:, 1] - rects[:, 0]) * (rects[:, 3] - rects[:, 2])
            rects[int(np.argmax(areas))] = (0, H, 0, W)
        return rects

    @torch.no_grad()
    def render_image_routed(
        self,
        model: Container,
        occ_states: Dict[str, torch.Tensor],
        *,
        H: int,
        W: int,
        intrinsics,
        c2w,
        aabb,
        draws=None,
        use_occ: Optional[bool] = None,
        near_far_override=None,
        ray_samples: Optional[int] = None,
        download: bool = True,
        blend_px: int = 32,
        expert_aabbs: Optional[np.ndarray] = None,
        acc_eps: float = 1e-4,
        mesh=None,
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], Optional[np.ndarray]]:
        """Full-frame render by per-expert image rectangles: each expert
        renders only the rectangle its box (``expert_aabbs``, default the
        model's) projects to, padded by ``blend_px``, single-expert (on its
        own grid with occupancy), and the rectangles are stitched on the
        host with weights ``feather × (acc + acc_eps)``: an expert that
        renders pixels outside its region, where its grid is empty, sees
        acc ≈ 0 there and contributes next to nothing where another expert
        has content. Returns what ``render_image`` returns. With identical
        experts it reproduces the dense frame up to the u8 quantization."""
        refuse_mesh(mesh)
        use_occ = self._use_occ(use_occ)
        if expert_aabbs is None:
            expert_aabbs = model.expert_aabbs.detach().cpu().numpy()
        K = expert_aabbs.shape[0]
        rects = self.routed_rects(expert_aabbs, c2w, intrinsics, H, W, blend_px)
        cam = self._camera(c2w, intrinsics, aabb, near_far_override)
        rnd = RenderDraws(draws, self.device)
        plan = self.routed_dispatch(rects, W, use_occ)
        pending = [
            self._frame_chunk(model, occ_states, W_crop, rows, cam, float(r0),
                              float(c0), use_occ=use_occ, active_module=k,
                              ray_samples=ray_samples, rnd=rnd, c=c)
            for c, (k, r0, _, c0, W_crop, rows) in enumerate(plan)
        ]
        if not download:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return None, None, None

        rgb_acc = np.zeros((H, W, 3), np.float32)
        depth_acc = np.zeros((H, W), np.float32)
        acc_acc = np.zeros((H, W), np.float32)
        w_acc = np.zeros((H, W), np.float32)
        feathers = {k: self._feather_weights(rects[k], H, W, blend_px)
                    for k in range(K)}
        for (k, r0, rows_this, c0, W_crop, _), outs in zip(plan, pending):
            rgb_u8, depth, acc = (o.cpu().numpy() for o in outs)
            rgb = rgb_u8.astype(np.float32) / 255.0
            rgb = rgb.reshape(-1, W_crop, 3)[:rows_this]
            dep = depth.astype(np.float32).reshape(-1, W_crop)[:rows_this]
            ac = acc.astype(np.float32).reshape(-1, W_crop)[:rows_this]
            fr0, _, fc0, fc1 = [int(v) for v in rects[k]]
            w = feathers[k][r0 - fr0:r0 - fr0 + rows_this]
            # the quantized crop may reach past the rect on either side:
            # accumulate only the rect's own columns
            cw0 = max(c0, fc0)
            cw1 = min(c0 + W_crop, fc1)
            wslice = w[:, cw0 - fc0:cw1 - fc0]
            sl_r = slice(r0, r0 + rows_this)
            sl_c = slice(cw0, cw1)
            src_c = slice(cw0 - c0, cw1 - c0)
            wk = wslice * (ac[:, src_c] + acc_eps)  # opacity-weighted stitch
            rgb_acc[sl_r, sl_c] += wk[..., None] * rgb[:, src_c]
            depth_acc[sl_r, sl_c] += wk * dep[:, src_c]
            acc_acc[sl_r, sl_c] += wk * ac[:, src_c]
            w_acc[sl_r, sl_c] += wk
        wsafe = np.maximum(w_acc, 1e-8)[..., None]
        rgb = np.clip(rgb_acc / wsafe, 0.0, 1.0)
        depth = (depth_acc / wsafe[..., 0]).reshape(-1)
        acc = (acc_acc / wsafe[..., 0]).reshape(-1)
        return rgb, depth, acc
