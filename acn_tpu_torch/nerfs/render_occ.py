"""Occupancy-guided rendering of one expert, and of the soft-MoE container:
per-ray strided, and over a global sample budget.

Port of ``acn_tpu/nerfs/render_occ.py`` (``render_expert_occ``,
``render_expert_occ_budget``, ``_any_expert_valid_fn``, ``_soft_moe_eval``,
``render_rays_occ``, ``render_rays_occ_budget``; ``params_override``, which
nothing in ``acn_tpu`` passes, is left out). The single-expert renderers
march one expert's own grid and evaluate that expert alone (the routed
per-rect frames). In the container renderers all experts share one
t-schedule per ray; a sample survives if ANY expert's (AABB ∩ occupancy)
claims it, and the K experts' outputs are blended at every sample:

    σ_mix(x)   = Σ_k w_k(x) σ_k(x)
    rgb_mix(x) = Σ_k w_k(x) σ_k(x) c_k(x) / σ_mix(x)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from acn_tpu_torch.models import container as cont
from acn_tpu_torch.models import ngp as ngp_mod
from acn_tpu_torch.models.container import Container
from acn_tpu_torch.nerfs import scene_box as sbox
from acn_tpu_torch.nerfs.render import (
    composite,
    composite_packed,
    render_weights_from_density,
)
from acn_tpu_torch.occupancy import grid as occ_grid
from acn_tpu_torch.occupancy.grid import OccConfig


def render_expert_occ(
    model: Container,
    occ_state: Dict[str, torch.Tensor],  # the expert's own occupancy state
    occ_cfg: OccConfig,
    rays: torch.Tensor,  # (N, 8)
    *,
    active_module: int,
    s_max: int,
    s_kept: int,
    alpha_thre: float = 0.0,
    u: Optional[torch.Tensor] = None,
    phase_bits: Optional[torch.Tensor] = None,
    bg_rgb=None,
):
    """Single-expert rendering to a fixed (N, s_kept) layout: the strided
    march over the expert's own grid (jitter ``u`` and ``phase_bits`` as
    ``march_rays`` takes them), expert ``active_module`` at the kept
    samples, and fixed-layout compositing with the stride-widened widths.

    Returns (rgb_map, depth, weights (N, s_kept), acc)."""
    samples = occ_grid.march_rays(occ_state, rays, occ_cfg, s_max, s_kept,
                                  u=u, phase_bits=phase_bits)
    x = samples["positions"]  # (N, S, 3)
    xd = torch.cat([x, rays[:, None, 3:6].expand_as(x)], dim=-1).reshape(-1, 6)
    out = cont.container_forward(model, xd, active_module=active_module).reshape(
        x.shape[0], x.shape[1], 4)
    rgbs, sigmas = out[..., :3], out[..., 3]

    mask = samples["mask"]
    if alpha_thre > 0.0:
        dt = torch.clamp(samples["dts"], min=0.0)
        alpha = 1.0 - torch.exp(-torch.clamp(sigmas, min=0.0) * dt)
        mask = mask & (alpha >= alpha_thre)
    weights, _ = render_weights_from_density(
        samples["t_starts"], samples["t_ends"], sigmas, sample_mask=mask,
        dts=samples["dts"])
    t_mid = 0.5 * (samples["t_starts"] + samples["t_ends"])
    rgb_map, depth, acc = composite(weights, rgbs, t_mid, bg_rgb=bg_rgb)
    return rgb_map, depth, weights, acc


def render_expert_occ_budget(
    model: Container,
    occ_state: Dict[str, torch.Tensor],  # the expert's own occupancy state
    occ_cfg: OccConfig,
    rays: torch.Tensor,  # (N, 8)
    *,
    active_module: int,
    s_max: int,
    budget_per_ray: int,
    alpha_thre: float = 0.0,
    salt=None,
    bg_rgb=None,
    s_coarse: int = 0,
):
    """Single-expert rendering over a global sample budget: the packed
    march over the expert's own grid (with the ``coarse_ray_range``
    pre-pass when ``s_coarse`` > 0, and the ``_u01`` jitter of ``salt``),
    expert ``active_module`` on the N·budget packed points, and
    ``composite_packed`` (one segmented scan).

    Returns (rgb_map, depth, extras {wmax, went} (N,), acc)."""
    samples = occ_grid.march_rays_budget(occ_state, rays, occ_cfg, s_max,
                                         budget_per_ray, salt=salt, s_coarse=s_coarse)
    out = cont.container_forward(model, samples["xd"], active_module=active_module)
    rgb_map, depth, acc, extras = composite_packed(
        out[..., 3], out[..., :3], samples, rays.shape[0], bg_rgb=bg_rgb,
        alpha_thre=alpha_thre)
    return rgb_map, depth, extras, acc


def _any_expert_valid_fn(occ_states: Dict[str, torch.Tensor],
                         expert_aabbs: torch.Tensor):
    """(N, S, 3) → (N, S): valid if ANY expert's (AABB ∩ occupancy) claims
    the point — the implicit segment union."""

    def any_expert_valid(x):
        out = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
        for k in range(expert_aabbs.shape[0]):
            state_k = {n: t[k] for n, t in occ_states.items()}
            inside = sbox.within(expert_aabbs[k], x, inclusive=False)
            out |= inside & occ_grid.occupancy_lookup(state_k, x)
        return out

    return any_expert_valid


def _soft_moe_eval(model: Container,
                   xd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert at every point + σ-weighted soft blend. xd (M, 6) →
    (σ_mix (M,), rgb_mix (M, 3))."""
    cfg = model.cfg
    w = cont.routing_weights(model.centroids, xd[:, :3], cfg.cluster_2d,
                             cfg.boundary_margin)  # (M, K)
    outs = torch.stack([
        ngp_mod.ngp_forward(model.expert(k), cfg.expert, model.expert_aabbs[k], xd)
        for k in range(cfg.num_submodules)
    ], dim=1)  # (M, K, 4)
    SIG = outs[..., 3]  # (M, K)
    RGB = outs[..., :3]  # (M, K, 3)
    w = w.to(SIG.dtype)
    s_num = torch.clamp(torch.sum(w * SIG, dim=1, keepdim=True), min=1e-12)
    rgb = torch.sum(w[..., None] * SIG[..., None] * RGB, dim=1) / s_num
    return s_num[:, 0], rgb


def render_rays_occ_budget(
    model: Container,
    occ_states: Dict[str, torch.Tensor],  # stacked (K, ...) occupancy states
    occ_cfg: OccConfig,
    rays: torch.Tensor,  # (N, 8)
    *,
    s_max: int,
    budget_per_ray: int,
    alpha_thre: float = 0.0,
    salt=None,
    bg_rgb=None,
):
    """Full-container occupancy rendering with a global cross-ray sample
    budget: the experts evaluate exactly N·budget packed points, and
    compositing runs over the packed buffer. ``salt`` jitters the samples
    (``march_rays_budget``).

    Returns (rgb_map, depth, extras {wmax, went} (N,), acc)."""
    any_expert_valid = _any_expert_valid_fn(occ_states, model.expert_aabbs)

    # an always-on grid over the GLOBAL aabb drives the schedule (it never
    # culls — validity comes from the per-expert union)
    binaries0 = occ_states["binaries"][0]
    base_state = {
        "binaries": torch.ones_like(binaries0),
        "aabbs": occ_grid.level_aabbs(model.global_aabb, binaries0.shape[0]),
    }
    samples = occ_grid.march_rays_budget(
        base_state, rays, occ_cfg, s_max, budget_per_ray,
        extra_valid_fn=any_expert_valid, salt=salt,
    )
    sigma_mix, rgb_mix = _soft_moe_eval(model, samples["xd"])
    rgb_map, depth, acc, extras = composite_packed(
        sigma_mix, rgb_mix, samples, rays.shape[0], bg_rgb=bg_rgb,
        alpha_thre=alpha_thre,
    )
    return rgb_map, depth, extras, acc


def render_rays_occ(
    model: Container,
    occ_states: Dict[str, torch.Tensor],  # stacked (K, ...) occupancy states
    occ_cfg: OccConfig,
    rays: torch.Tensor,  # (N, 8)
    *,
    s_max: int,
    s_kept: int,
    alpha_thre: float = 0.0,
    u: Optional[torch.Tensor] = None,
    phase_bits: Optional[torch.Tensor] = None,
    bg_rgb=None,
):
    """Full-container occupancy rendering to a fixed (N, s_kept) layout:
    ``s_max`` bins over each ray's [near, far], valid where any expert's
    (AABB ∩ occupancy) claims the sample point (at fraction ``u`` of the bin,
    or its midpoint), the strided compaction (phase from ``phase_bits``, or
    0), the soft-MoE blend at the kept samples, and fixed-layout compositing
    with the stride-widened widths. Samples with alpha under ``alpha_thre``
    are masked.

    Returns (rgb_map, depth, weights (N, s_kept), acc)."""
    any_expert_valid = _any_expert_valid_fn(occ_states, model.expert_aabbs)
    o, d, _, _, t0, t1 = occ_grid.ray_bins(rays, occ_cfg, s_max)
    t_s = t0 + (0.5 if u is None else u) * (t1 - t0)
    x_all = o[:, None, :] + d[:, None, :] * t_s[..., None]
    valid = (t1 > t0) & any_expert_valid(x_all)
    smp = occ_grid.strided_samples(t0, t1, x_all, valid, s_kept, phase_bits)

    xk = smp["positions"]  # (N, S, 3)
    xd = torch.cat([xk, d[:, None, :].expand_as(xk)], dim=-1).reshape(-1, 6)
    sigma_mix, rgb_mix = _soft_moe_eval(model, xd)
    N, S = xk.shape[0], xk.shape[1]
    sigmas = sigma_mix.reshape(N, S)
    rgbs = rgb_mix.reshape(N, S, 3)

    mask = smp["mask"]
    if alpha_thre > 0.0:
        dt = torch.clamp(smp["dts"], min=0.0)
        alpha = 1.0 - torch.exp(-torch.clamp(sigmas, min=0.0) * dt)
        mask = mask & (alpha >= alpha_thre)
    weights, _ = render_weights_from_density(
        smp["t_starts"], smp["t_ends"], sigmas, sample_mask=mask, dts=smp["dts"])
    t_mid = 0.5 * (smp["t_starts"] + smp["t_ends"])
    rgb_map, depth, acc = composite(weights, rgbs, t_mid, bg_rgb=bg_rgb)
    return rgb_map, depth, weights, acc
