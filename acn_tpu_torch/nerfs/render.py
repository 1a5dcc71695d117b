"""Volume rendering: fixed-layout and stratified compositing, and
compositing over the packed sample buffer.

Port of ``acn_tpu/nerfs/render.py``: ``bg_default_color`` (the
``random`` policy from a ``torch.Generator`` or injected draws),
``apply_bg_mask``, ``volume_render``, ``render_weights_from_density``, ``composite``,
``composite_packed``, ``stratified_t_vals`` and ``render_rays_stratified``.
The stratified jitter ``u`` is injected (JAX draws it from a key); None
samples the bin edges themselves (JAX's ``randomized=False``).

Every ``jnp.clip`` / ``jnp.maximum`` on a differentiable value is
``nn.clip_half_ties``: JAX passes half the gradient at a tie. The
fixed-layout transmittance is a ``torch.cumprod`` (JAX's ``jnp.cumprod``
multiplies in another order: float32 rounding differs in the last bits)
with a backward of its own (``_ExclusiveCumprod``): torch's divides by the
input, and its second derivative at an opaque sample (1 − α + 1e-10 =
1e-10) is 0 where JAX's is not; this one divides by nothing and is twice
differentiable, as second-order MAML needs.

``composite_packed`` dispatches (``ops/composite.py``, ``takes``): float32
on the card with no gradient recorded (every serving path) is one launch of
the composite kernel; a recorded gradient without the stats (every budget
training loss) is ``composite_autograd``, the same forward kernel and one
launch of its backward kernel (under ``create_graph`` a VJP of the plain
composition, so that MAML's second derivative runs the scan's double
backward); both sum each ray in one fixed order with no atomics. Otherwise
(the CPU, or a gradient with the stats) the plain composition, where JAX's
dropping scatter-add / scatter-max (``.at[rid].add(..., mode="drop")``)
becomes ``index_add_`` / ``scatter_reduce_`` into a target with one spill
row at the end that is sliced off (on the card ``index_add_`` accumulates
with atomics, so the last bits of its sums may change from run to run). The
plain composition is differentiable in the densities, colors and
background: the gradient flows through ``index_add_``, ``torch.where(real,
…)``, ``log(1 − α + 1e-10)`` and ``seg_excl_sum``, whose backward on a CUDA
tensor is one launch of the reverse scan kernel.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from acn_tpu_torch.models.nn import clip_half_ties
from acn_tpu_torch.models.trunc_exp import trunc_exp
from acn_tpu_torch.occupancy.grid import unit_linspace
from acn_tpu_torch.ops import composite as packed
from acn_tpu_torch.ops.segscan import seg_excl_sum


def bg_default_color(n: int, bg_color: str = "white", *, device=None,
                     dtype=torch.float32, generator: Optional[torch.Generator] = None,
                     u: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Fallback background color: "white", "black", "none" (None), or
    "random": uniform (n, 3) colors, the injected draws ``u`` or drawn from
    ``generator`` (on its device); one of the two is required."""
    if bg_color == "none":
        return None
    if bg_color == "white":
        return torch.ones((n, 3), dtype=dtype, device=device)
    if bg_color == "black":
        return torch.zeros((n, 3), dtype=dtype, device=device)
    if bg_color == "random":
        return _uniform_fill((n, 3), dtype, generator, u, "bg_color='random'")
    raise ValueError(f"Unknown background policy: {bg_color}")


def _uniform_fill(shape, dtype, generator, u, what: str) -> torch.Tensor:
    if u is not None:
        return torch.as_tensor(u).to(dtype).reshape(shape)
    if generator is None:
        raise ValueError(f"{what} needs a generator or injected draws")
    return torch.rand(shape, generator=generator, device=generator.device, dtype=dtype)


def apply_bg_mask(rgb: torch.Tensor, mask_invalid: torch.Tensor, policy: str,
                  generator: Optional[torch.Generator] = None,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fill the invalid rays' colors with a background policy: "none" and
    "last_sample" leave them, "black" zeros, "random" uniform draws (``u``
    of rgb's shape, or from ``generator``), anything else white."""
    policy = str(policy).lower()
    if policy in ("none", "last_sample"):
        return rgb
    if policy == "black":
        fill = torch.zeros_like(rgb)
    elif policy == "random":
        fill = _uniform_fill(rgb.shape, rgb.dtype, generator, u, "policy='random'")
    else:
        fill = torch.ones_like(rgb)
    return torch.where(mask_invalid[:, None], fill.to(rgb.device), rgb)


def composite_packed(
    sigmas_b: torch.Tensor,  # (B,) densities at packed samples
    rgbs_b: torch.Tensor,  # (B, 3)
    samples: dict,  # march_rays_budget output (t0_b/t1_b/ray_id/slot_real/ray_start)
    n_rays: int,
    bg_rgb: Optional[torch.Tensor] = None,  # (N, 3)
    alpha_thre: float = 0.0,
    with_stats: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """Compositing directly over the ray-major packed sample buffer: per-ray
    transmittance as a segmented log-space scan, weights, and every B→N sum
    (``ops/composite.py`` states the function).

    Float32 CUDA tensors (``ops.composite.takes``) take the kernels: with no
    gradient being recorded (every serving path) the composite kernel, one
    launch; recording one without the stats (the budget training loss)
    ``ops.composite.composite_autograd``, the forward kernel and, in the
    backward, the backward kernel (under ``create_graph`` the plain
    composition's VJP). Everything else takes the plain composition
    (``ops.composite.composite_plain``, its scan this module's
    ``seg_excl_sum``: the scan kernel on the card; differentiable in the
    densities, colors and background).

    Returns (rgb_map (N,3), depth (N,), acc (N,), extras {wmax, went}).
    ``with_stats=False`` leaves the extras out (an empty dict): the training
    loss does not read them.
    """
    if packed.takes(sigmas_b, rgbs_b, samples, with_stats):
        if torch.is_grad_enabled():
            return packed.composite_autograd(sigmas_b, rgbs_b, samples, n_rays, bg_rgb,
                                             alpha_thre, scan=seg_excl_sum)
        return packed.composite_kernel(sigmas_b, rgbs_b, samples, n_rays, bg_rgb,
                                       alpha_thre, with_stats)
    return packed.composite_plain(sigmas_b, rgbs_b, samples, n_rays, bg_rgb,
                                  alpha_thre, with_stats, scan=seg_excl_sum)


# ============================ fixed-layout compositing ============================


def _suffix_affine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """R_k = a_k + b_k · R_{k+1} along dim 1, from the end (b's last column
    0): a log-depth Hillis–Steele scan of the affine maps, composed
    (a_k, b_k) ∘ (a_{k+d}, b_{k+d}) = (a_k + b_k·a_{k+d}, b_k·b_{k+d}), of
    differentiable ops."""
    n, d = a.shape[1], 1
    while d < n:
        a = torch.cat([a[:, :-d] + b[:, :-d] * a[:, d:], a[:, -d:]], dim=1)
        b = torch.cat([b[:, :-d] * b[:, d:], b[:, -d:]], dim=1)
        d *= 2
    return a


class _ExclusiveCumprod(torch.autograd.Function):
    """T_i = Π_{j<i} y_j along dim 1 (T_0 = 1), forward by ``torch.cumprod``.
    Backward without a division: ∂L/∂y_k = T_k · R_k with
    R_k = Σ_{i>k} g_i Π_{k<j<i} y_j = g_{k+1} + y_{k+1} · R_{k+1}
    (``_suffix_affine``), so that an opaque sample's tiny y divides nothing,
    and the backward, made of differentiable ops on the saved y and T, is
    itself differentiable. A backward that builds no graph (first order)
    takes ``torch.cumprod``'s own gradient: the same value in its own few
    launches, where the scan takes about 30."""

    @staticmethod
    def forward(ctx, y):
        trans = torch.cumprod(y, dim=1)
        out = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
        ctx.save_for_backward(y, out, trans)
        return out

    @staticmethod
    def backward(ctx, g):
        y, out, trans = ctx.saved_tensors
        g_next = F.pad(g[:, 1:], (0, 1))
        if not torch.is_grad_enabled():
            return torch.ops.aten.cumprod_backward(g_next, y, 1, trans)
        return out * _suffix_affine(g_next, F.pad(y[:, 1:], (0, 1)))


def _exclusive_trans(alpha: torch.Tensor) -> torch.Tensor:
    """Π_{j<i} (1 − α_j + 1e-10) along each ray, (N, S)."""
    return _ExclusiveCumprod.apply(1.0 - alpha + 1e-10)


def volume_render(
    rgb_sigma: torch.Tensor,  # (N, S, 4) [rgb in 0..1, sigma >= 0] unless raw_*
    t_vals: torch.Tensor,  # (N, S)
    bg_rgb: Optional[torch.Tensor] = None,  # (N, 3)
    *,
    raw_rgb: bool = False,
    raw_sigma: bool = False,
    sigma_scale: float = 1.0,
    sample_mask: Optional[torch.Tensor] = None,  # (N, S) bool; False ⇒ zero alpha
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Discrete transmittance integration: α_i = 1 − exp(−σ_i Δ_i),
    T_i = Π_{j<i}(1 − α_j), w_i = α_i T_i, with Δ the gap to the next sample
    (≥ 1e-4; the last repeats the one before it).

    Returns (rgb_map (N,3), depth_map (N,), weights (N,S), acc_map (N,))."""
    rgb_raw, sigma_in = rgb_sigma[..., :3], rgb_sigma[..., 3]
    rgb = torch.sigmoid(rgb_raw) if raw_rgb else clip_half_ties(rgb_raw, 0.0, 1.0)
    sigma = trunc_exp(sigma_in) if raw_sigma else clip_half_ties(sigma_in, 0.0)
    if sigma_scale != 1.0:
        sigma = sigma * float(sigma_scale)

    dists = torch.clamp(t_vals[:, 1:] - t_vals[:, :-1], min=1e-4)
    dists = torch.cat([dists, dists[:, -1:]], dim=1)
    if sample_mask is not None:
        sigma = torch.where(sample_mask, sigma, 0.0)

    alpha = clip_half_ties(1.0 - torch.exp(-sigma * dists), 0.0, 1.0 - 1e-7)
    weights = alpha * _exclusive_trans(alpha)
    rgb_map, depth_map, acc_map = composite(weights, rgb, t_vals, bg_rgb)
    return rgb_map, depth_map, weights, acc_map


def render_weights_from_density(
    t_starts: torch.Tensor,  # (N, S)
    t_ends: torch.Tensor,  # (N, S)
    sigmas: torch.Tensor,  # (N, S)
    sample_mask: Optional[torch.Tensor] = None,  # (N, S)
    dts: Optional[torch.Tensor] = None,  # (N, S) interval-width override
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample weights from interval densities over a fixed layout;
    ``dts`` overrides the interval widths (the strided march widens them by
    its stride). Returns (weights (N,S), trans (N,S))."""
    dt = torch.clamp(t_ends - t_starts if dts is None else dts, min=0.0)
    sigma = clip_half_ties(sigmas, 0.0)
    if sample_mask is not None:
        sigma = torch.where(sample_mask, sigma, 0.0)
    alpha = 1.0 - torch.exp(-sigma * dt)
    trans = _exclusive_trans(alpha)
    return alpha * trans, trans


def composite(
    weights: torch.Tensor,  # (N, S)
    rgbs: torch.Tensor,  # (N, S, 3)
    t_mids: torch.Tensor,  # (N, S)
    bg_rgb: Optional[torch.Tensor] = None,  # (N, 3)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Color, depth and opacity accumulated along each ray."""
    rgb_map = torch.sum(weights[..., None] * rgbs, dim=1)
    depth = torch.sum(weights * t_mids, dim=1)
    acc = torch.sum(weights, dim=1)
    if bg_rgb is not None:
        rgb_map = rgb_map + (1.0 - acc[..., None]) * bg_rgb.to(rgb_map.dtype)
    return rgb_map, depth, acc


# ============================ stratified sampling ============================


def stratified_t_vals(
    near: torch.Tensor,  # (N,)
    far: torch.Tensor,  # (N,)
    ray_samples: int,
    u: Optional[torch.Tensor] = None,  # (N, ray_samples) in [0, 1)
) -> torch.Tensor:
    """``ray_samples`` depths per ray spread over [near, far]; with ``u``,
    each moves to fraction u of its stratum (between the midpoints to its
    neighbours). Returns (N, ray_samples)."""
    t_lin = unit_linspace(ray_samples, near.device)
    t_vals = near[:, None] * (1.0 - t_lin) + far[:, None] * t_lin
    if u is None:
        return t_vals
    mids = 0.5 * (t_vals[:, :-1] + t_vals[:, 1:])
    low = torch.cat([t_vals[:, :1], mids], dim=1)
    high = torch.cat([mids, t_vals[:, -1:]], dim=1)
    return low + (high - low) * u


def render_rays_stratified(
    model_fn: Callable[[torch.Tensor], torch.Tensor],  # (M, 6) → (M, 4) [rgb, σ]
    rays: torch.Tensor,  # (N, 8)
    ray_samples: int,
    *,
    u: Optional[torch.Tensor] = None,
    bg_rgb: Optional[torch.Tensor] = None,  # (N, 3)
    sigma_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stratified renderer over a point-query function (one expert, or
    the routed container). Returns (rgb_map, depth_map, weights, acc_map)."""
    o, d = rays[:, :3], rays[:, 3:6]
    t_vals = stratified_t_vals(rays[:, 6], rays[:, 7], ray_samples, u)
    pts = o[:, None, :] + d[:, None, :] * t_vals[..., None]  # (N, S, 3)
    xd = torch.cat([pts, d[:, None, :].expand_as(pts)], dim=-1).reshape(-1, 6)
    rgb_sigma = model_fn(xd).reshape(pts.shape[0], pts.shape[1], 4)
    return volume_render(rgb_sigma, t_vals, bg_rgb=bg_rgb, sigma_scale=sigma_scale)
