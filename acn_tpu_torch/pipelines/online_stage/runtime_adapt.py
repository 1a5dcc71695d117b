"""Online stage: test-time optimization (TTO) and the full evaluation.

Port of ``acn_tpu/pipelines/online_stage/runtime_adapt.py``:

* ``make_tto_step``: one Adam step of the whole model (not fast weights),
  in place, on an MSE of rendered support rays: through ``render_rays_occ``
  (the strided march over the grids) when occupancy states exist, else
  ``render_rays_stratified`` over the routed container; the background from
  the background MLP or the default colour; ``aligned_mse_loss``.
* ``runtime_adapt``: ``tto_steps`` such steps on rays sampled from a
  support store, with the optimizer state threaded by the caller.
* ``runtime_evaluate``: phase A adapts per metadata batch of
  ``test_batch_size`` views (all rays of those views, one optimizer for the
  whole sweep); phase B renders every view full-frame through
  ``Renderer.render_image`` and scores PSNR, SSIM and (with pretrained
  weights) LPIPS over the full image, writing pred and gt PNGs. With a
  baked asset (``ctx["baked_renderer"]``, ``--baked_asset``) the frames come
  from its table and no leg adapts: a frozen table has no weights to tune.

Randomness: the support batches come from numpy's ``default_rng(P.seed)``,
as in ``acn_tpu``, so the ray ids are the same. The render's draws (the
strided march's jitter ``u`` and phase bits, or the stratified jitter) go
through ``TTODraws``: a ``torch.Generator`` on the device, or a function
through which a test replays ``acn_tpu``'s keys. So do the ``random``
background's colors, in the TTO step and in the frames.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from acn_tpu_torch.data.image_metadata import ImageMetadata
from acn_tpu_torch.data.png import write_png
from acn_tpu_torch.data.ram_rays import RamRaysDataset
from acn_tpu_torch.models import container as cont
from acn_tpu_torch.models.container import Container, ContainerConfig
from acn_tpu_torch.models.nn import tree_leaves, tree_map
from acn_tpu_torch.nerfs.color import color_space_transformer, linear_to_srgb
from acn_tpu_torch.nerfs.losses import aligned_mse_loss, psnr as psnr_fn, ssim as ssim_fn
from acn_tpu_torch.nerfs.render import bg_default_color, render_rays_stratified
from acn_tpu_torch.nerfs.render_occ import render_rays_occ
from acn_tpu_torch.occupancy.grid import OccConfig
from acn_tpu_torch.pipelines.renderer import Renderer, resolve_device
from acn_tpu_torch.utils.optim import Optimizer, apply_updates, build_optimizer


class TTODraws:
    """The render draws of TTO step ``i`` of metadata batch ``b`` on ``n``
    rays: ``render(b, i, n)`` → (u (n, s_max), phase bits (n,)) for the
    occupancy render, u (n, ray_samples) for the stratified one; ``bg(b, i,
    n)`` → the ``random`` background's (n, 3) colors (None under another
    policy or with the background MLP); ``frame(v)`` → the draws of view
    ``v``'s frame, as ``RenderDraws`` takes them.

    ``draws``: a ``torch.Generator`` on the device, or a function
    ``fn(what, b, i, shape)`` with ``what`` one of "u", "phase" (the
    occupancy render), "strat_u" (the stratified one), "bg" (the step's
    background), or "frame_" + a ``RenderDraws`` name for chunk ``i`` of
    view ``b``'s frame. ``acn_tpu`` splits ``PRNGKey(P.seed)`` once per
    batch and that key once per step, the step's key into (background,
    render), and the render's key into (jitter, phase) for the occupancy
    render; then once per view for its frame."""

    def __init__(self, draws, device: torch.device, use_occ: bool, P, cfg=None):
        self.device, self.use_occ = device, use_occ
        self.s_max = int(P.occ_s_max)
        self.ray_samples = int(P.ray_samples)
        self.random_bg = (P.bg_color_default == "random"
                          and not (cfg is not None and cfg.use_bg_nerf))
        self.generator = draws if isinstance(draws, torch.Generator) else None
        if isinstance(draws, torch.Generator):
            gen = draws

            def draws(what, b, i, shape):
                if what == "phase":
                    return torch.randint(0, 1 << 30, shape, generator=gen, device=gen.device)
                return torch.rand(shape, generator=gen, device=gen.device)
        elif not callable(draws):
            raise TypeError("draws: a torch.Generator or a function, "
                            f"not {type(draws).__name__}")
        self.fn: Callable = draws

    def _get(self, what, b, i, shape):
        return torch.as_tensor(self.fn(what, b, i, shape)).to(self.device)

    def render(self, b: int, i: int, n: int):
        if self.use_occ:
            return (self._get("u", b, i, (n, self.s_max)), self._get("phase", b, i, (n,)))
        return self._get("strat_u", b, i, (n, self.ray_samples))

    def bg(self, b: int, i: int, n: int):
        return self._get("bg", b, i, (n, 3)) if self.random_bg else None

    def frame(self, v: int):
        if self.generator is not None:
            return self.generator
        return lambda what, c, shape: self.fn("frame_" + what, v, c, shape)


def make_tto_step(
    cfg: ContainerConfig,
    P,
    optimizer: Optimizer,
    occ_cfg: Optional[OccConfig] = None,
    use_occ: bool = False,
):
    """``tto_step(model, opt_state, occ_states, rays, rgbs, rand, bg=None)``
    → (opt_state, loss): one Adam step of full-model MSE fine-tuning, the
    model's parameters updated in place. ``rand`` is what
    ``TTODraws.render`` gives, ``bg`` what ``TTODraws.bg`` gives (the
    ``random`` background's colors)."""

    def loss_fn(model: Container, occ_states, rays, rgbs, rand, bg_u):
        n = rays.shape[0]
        if cfg.use_bg_nerf:
            bg = cont.background_color(model, rays[:, 3:6])
        else:
            bg = bg_default_color(n, P.bg_color_default, device=rays.device, u=bg_u)
        if use_occ:
            u, phase_bits = rand
            rgb_map = render_rays_occ(
                model, occ_states, occ_cfg, rays, s_max=int(P.occ_s_max),
                s_kept=int(P.occ_s_kept), alpha_thre=float(occ_cfg.alpha_thre),
                u=u, phase_bits=phase_bits, bg_rgb=bg)[0]
        else:
            rgb_map = render_rays_stratified(
                lambda xd: cont.container_forward(model, xd), rays, int(P.ray_samples),
                u=rand, bg_rgb=bg)[0]
        return aligned_mse_loss(rgb_map, rgbs, P.color_space)

    def tto_step(model: Container, opt_state, occ_states, rays, rgbs, rand, bg=None):
        params = model.params()
        leaves = tree_leaves(params)
        loss = loss_fn(model, occ_states, rays, rgbs, rand, bg)
        grads = iter(torch.autograd.grad(loss, leaves))
        updates, opt_state = optimizer.update(tree_map(lambda _: next(grads), params),
                                              opt_state)
        apply_updates(params, updates)
        return opt_state, loss.detach()

    return tto_step


def runtime_adapt(
    model: Container,
    cfg: ContainerConfig,
    P,
    support: RamRaysDataset,
    tto_steps: int,
    draws: TTODraws,
    batch: int = 0,
    batch_rays: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
    optimizer: Optional[Optimizer] = None,
    opt_state=None,
    tto_step_fn=None,
    occ_cfg: Optional[OccConfig] = None,
    occ_states=None,
) -> Tuple[Container, Any, float]:
    """Fine-tune the whole model in place for ``tto_steps`` Adam updates on
    batches of ``batch_rays`` (``P.support_rays``) rays sampled from
    ``support`` with ``rng``; ``draws`` gives the render draws of metadata
    batch ``batch``. Pass ``optimizer`` / ``opt_state`` / ``tto_step_fn`` to
    keep the optimizer's moments across calls. Returns (the model, the
    optimizer state, the last loss), the loss read once at the end."""
    if tto_steps <= 0 or len(support) == 0:
        return model, opt_state, float("nan")
    device = model.global_aabb.device
    rng = rng or np.random.default_rng(P.seed)
    batch_rays = batch_rays or int(P.support_rays)
    use_occ = occ_cfg is not None and occ_states is not None
    if optimizer is None:
        optimizer = build_optimizer(P, cont.param_group_labels(model.params()), grad_clip=1.0)
    if tto_step_fn is None:
        tto_step_fn = make_tto_step(cfg, P, optimizer, occ_cfg, use_occ)
    if opt_state is None:
        opt_state = optimizer.init(model.params())
    loss = None
    for i in range(int(tto_steps)):
        rays, rgbs, _ = support.sample(rng, batch_rays)
        opt_state, loss = tto_step_fn(
            model, opt_state, occ_states, torch.from_numpy(rays).to(device),
            torch.from_numpy(rgbs).to(device), draws.render(batch, i, batch_rays),
            bg=draws.bg(batch, i, batch_rays))
    return model, opt_state, float(loss)


def _to_png(path: Path, img01: np.ndarray) -> None:
    write_png(path, (np.clip(img01, 0, 1) * 255 + 0.5).astype(np.uint8))


def runtime_evaluate(ctx: Dict[str, Any], tto: int, draws=None) -> Dict[str, Any]:
    """The TTO sweep's evaluation at ``tto`` steps per metadata batch.

    Phase A adapts ``ctx["model"]`` in place per batch of
    ``P.test_batch_size`` views (``tto`` steps each, one persistent
    optimizer); phase B renders every view of ``ctx["test_metadata"]`` and
    scores it over the full image, writing pred and gt PNGs under the run
    directory. ``draws`` as ``TTODraws`` takes them; None draws from a
    generator on the device seeded with ``P.seed``. With
    ``ctx["baked_renderer"]`` (a ``BakedRenderer``) the frames are the
    baked table's, and a ``tto`` above 0 is logged and rendered without
    adaptation, as ``acn_tpu`` does.

    Returns ``acn_tpu``'s {psnr, ssim, lpips, duration, n_views} and, per
    view, ``views`` [{psnr, ssim, lpips?, frame_ms, ssim_ms}], with
    ``tto_losses`` (each batch's last loss) and ``adapt_s`` (the adaptation's
    wall time, support stores excluded)."""
    P = ctx["P"]
    cfg: ContainerConfig = ctx["cfg"]
    occ_cfg: Optional[OccConfig] = ctx["occ_cfg"]
    logger = ctx["logger"]
    model: Container = ctx["model"]
    occ_states = ctx["occ_states"]
    test_meta: List[ImageMetadata] = ctx["test_metadata"]
    global_aabb = np.asarray(ctx["global_aabb"])
    device = resolve_device(ctx.get("device"))
    use_occ = occ_cfg is not None and occ_states is not None
    if draws is None:
        draws = torch.Generator(device=device).manual_seed(int(P.seed))
    draws = TTODraws(draws, device, use_occ, P, cfg)
    logger.log(f"======== TTO: {tto} ========")

    baked = ctx.get("baked_renderer")
    if baked is not None and tto > 0:
        # a baked table is a frozen distillation: no weights to adapt
        logger.log("[baked] --baked_asset set: TTO does not apply to a baked "
                   f"table; rendering tto={tto} leg without adaptation")

    # ---- phase A: per-metadata-batch TTO on the eval views' rays ----
    t0 = time.perf_counter()
    tto_losses, adapt_s = [], 0.0
    if tto > 0 and baked is None:
        optimizer = build_optimizer(P, cont.param_group_labels(model.params()), grad_clip=1.0)
        tto_step_fn = make_tto_step(cfg, P, optimizer, occ_cfg, use_occ)
        opt_state = None
        bs = max(int(getattr(P, "test_batch_size", 1)), 1)
        rng = np.random.default_rng(P.seed)
        total_support = 0
        for bi in range(0, len(test_meta), bs):
            support = RamRaysDataset(
                test_meta[bi: bi + bs], center_pixels=True,
                val_balancing=False,  # the adaptation sees all rays of its views
                aabb=global_aabb, near_far_override=(P.near, P.far),
                num_workers=P.num_workers)
            total_support += len(support)
            ta = time.perf_counter()
            _, opt_state, last = runtime_adapt(
                model, cfg, P, support, tto, draws=draws, batch=bi // bs, rng=rng,
                optimizer=optimizer, opt_state=opt_state, tto_step_fn=tto_step_fn,
                occ_cfg=occ_cfg, occ_states=occ_states if use_occ else None)
            adapt_s += time.perf_counter() - ta
            tto_losses.append(last)
            logger.log(f"[Batch {bi // bs + 1}] rays={len(support)} last_loss={last:.6f}")
        logger.log(f"[ADAPTATION END] [{time.perf_counter() - t0:.2f}s] "
                   f"total support rays: {total_support}")
    duration = time.perf_counter() - t0

    # ---- phase B: full-frame rendering, metrics over full images ----
    # without grids (a params-only checkpoint) the frames are stratified
    renderer = (Renderer(cfg, P, occ_cfg if use_occ else None, device=device)
                if baked is None else None)
    out_root = Path(logger.logdir) / "rendered"
    out_pred = out_root / f"pred{tto}"
    out_gt = out_root / "gt"
    out_pred.mkdir(parents=True, exist_ok=True)
    out_gt.mkdir(parents=True, exist_ok=True)

    if "lpips" not in ctx:
        from acn_tpu_torch.models.lpips import LPIPS

        ctx["lpips"] = LPIPS(device=device)
    lpips_model = ctx["lpips"]
    # random-weight LPIPS is not the official metric: report n/a, say why once
    lpips_ok = lpips_model.pretrained
    if not lpips_ok:
        logger.log("[LPIPS] n/a — no pretrained AlexNet weights found; put "
                   "lpips_alex.npz in place (see acn_tpu_torch/models/lpips.py) "
                   "for official values")
    views = []
    for i, md in enumerate(test_meta):
        tf = time.perf_counter()
        if baked is not None:
            rgb_pred, _, _ = baked.render_image(
                H=md.H, W=md.W, intrinsics=md.intrinsics, c2w=md.c2w,
                near_far_override=(P.near, P.far))
        else:
            rgb_pred, _, _ = renderer.render_image(
                model, occ_states, H=md.H, W=md.W, intrinsics=md.intrinsics, c2w=md.c2w,
                aabb=global_aabb, near_far_override=(P.near, P.far), draws=draws.frame(i))
        frame_ms = 1e3 * (time.perf_counter() - tf)
        gt_srgb = md.load_image().astype(np.float32) / 255.0

        pred_t = torch.from_numpy(rgb_pred).to(device)
        pred_cs, gt_cs = color_space_transformer(
            pred_t, torch.from_numpy(gt_srgb).to(device), P.color_space)
        view = {"psnr": float(psnr_fn(pred_cs, gt_cs)), "frame_ms": frame_ms}
        ts = time.perf_counter()
        view["ssim"] = float(ssim_fn(pred_cs, gt_cs))
        view["ssim_ms"] = 1e3 * (time.perf_counter() - ts)
        # LPIPS on sRGB, scaled to [-1, 1] inside
        pred_srgb = (pred_cs if P.color_space == "srgb" else linear_to_srgb(pred_t)).cpu().numpy()
        if lpips_ok:
            view["lpips"] = lpips_model(pred_srgb, gt_srgb)
        views.append(view)

        _to_png(out_pred / f"{i:06d}.png", pred_srgb)
        _to_png(out_gt / f"{i:06d}.png", gt_srgb)
        logger.log(f" * [IMG {i + 1}] PSNR {view['psnr']:.3f} | SSIM {view['ssim']:.3f}"
                   + (f" | LPIPS {view['lpips']:.3f}" if lpips_ok else " | LPIPS n/a"))

    def mean(key):
        vals = [v[key] for v in views if key in v]
        return float(np.mean(vals)) if vals else float("nan")

    return {"psnr": mean("psnr"), "ssim": mean("ssim"), "lpips": mean("lpips"),
            "duration": duration, "n_views": len(test_meta), "views": views,
            "tto_losses": tto_losses, "adapt_s": adapt_s}
