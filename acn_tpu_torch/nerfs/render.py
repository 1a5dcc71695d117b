"""Volume compositing over the packed sample buffer.

Port of ``acn_tpu/nerfs/render.py`` (``bg_default_color``,
``composite_packed``). JAX's dropping scatter-add / scatter-max
(``.at[rid].add(..., mode="drop")``) becomes ``index_add_`` /
``scatter_reduce_`` into a target with one spill row at the end that is
sliced off. On the card ``index_add_`` accumulates with atomics, so its
order (and the last bits of the sums) may change from run to run.

``composite_packed`` is differentiable in the densities and colors: the
gradient flows through ``index_add_``, ``torch.where(real, …)``,
``log(1 − α + 1e-10)`` and ``seg_excl_sum``, whose backward on a CUDA tensor
is one launch of the reverse scan kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from acn_tpu_torch.models.nn import clip_half_ties
from acn_tpu_torch.ops.segscan import seg_excl_sum


def bg_default_color(n: int, bg_color: str = "white", *, device=None,
                     dtype=torch.float32) -> Optional[torch.Tensor]:
    """Deterministic fallback background color: "white", "black" or "none"."""
    if bg_color == "random":
        raise NotImplementedError(
            "the 'random' background policy is not ported (ROADMAP.md, left "
            "out of slice 1); use the background MLP, 'white', 'black' or 'none'")
    if bg_color == "none":
        return None
    if bg_color == "white":
        return torch.ones((n, 3), dtype=dtype, device=device)
    if bg_color == "black":
        return torch.zeros((n, 3), dtype=dtype, device=device)
    raise ValueError(f"Unsupported background policy: {bg_color}")


def composite_packed(
    sigmas_b: torch.Tensor,  # (B,) densities at packed samples
    rgbs_b: torch.Tensor,  # (B, 3)
    samples: dict,  # march_rays_budget output (t0_b/t1_b/ray_id/slot_real)
    n_rays: int,
    bg_rgb: Optional[torch.Tensor] = None,  # (N, 3)
    alpha_thre: float = 0.0,
    with_stats: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """Compositing directly over the ray-major packed sample buffer.

    Per-ray transmittance is a segment-exclusive product, computed as a
    segmented log-space scan that resets at every ray boundary
    (``ops.segscan.seg_excl_sum``); per-ray accumulation is a B→N segment
    sum. The scan must be segmented: opaque samples add ≈ −23 each to the
    log-transmittance, and a global float32 prefix over ~10⁶ samples would
    lose the late rays' precision.

    Padding slots past the real samples carry ray 0 (the marcher's zeroed
    buffer), so a segment opens at the first of them; ``slot_real`` zeroes
    their weights, as in JAX.

    Returns (rgb_map (N,3), depth (N,), acc (N,), extras {wmax, went}).
    ``with_stats=False`` leaves the extras out (an empty dict): the training
    loss does not read them, and eager PyTorch would otherwise compute them
    and keep their graph in every loss (under ``jit`` XLA drops them).
    """
    t0_b, t1_b = samples["t0_b"], samples["t1_b"]
    rid = samples["ray_id"]
    real = samples["slot_real"]

    dt = torch.clamp(t1_b - t0_b, min=0.0)
    sigma = torch.where(real, clip_half_ties(sigmas_b, 0.0), 0.0)
    alpha = 1.0 - torch.exp(-sigma * dt)
    if alpha_thre > 0.0:
        alpha = torch.where(alpha >= alpha_thre, alpha, 0.0)

    logt = torch.log(1.0 - alpha + 1e-10)
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=rid.device),
                           rid[1:] != rid[:-1]])
    trans = torch.exp(seg_excl_sum(logt, seg_start))  # exclusive within ray
    w = torch.where(real, alpha * trans, 0.0)

    rid_safe = torch.where(real, rid, n_rays)  # padding → spill row n_rays

    def seg_sum(vals):
        out = torch.zeros((n_rays + 1, *vals.shape[1:]), dtype=torch.float32,
                          device=vals.device)
        return out.index_add_(0, rid_safe, vals.to(torch.float32))[:n_rays]

    rgb_map = seg_sum(w[:, None] * rgbs_b)
    t_mid = 0.5 * (t0_b + t1_b)
    depth = seg_sum(w * t_mid)
    acc = seg_sum(w)

    if bg_rgb is not None:
        rgb_map = rgb_map + (1.0 - acc[:, None]) * bg_rgb.to(rgb_map.dtype)
    if not with_stats:
        return rgb_map, depth, acc, {}

    # weight-shape stats: segment max and entropy of the weights
    wmax = torch.zeros(n_rays + 1, dtype=torch.float32, device=w.device)
    wmax = wmax.scatter_reduce_(0, rid_safe, w, "amax", include_self=True)[:n_rays]
    wlogw = seg_sum(w * torch.log(torch.clamp(w, min=1e-12)))
    wsum = torch.clamp(acc, min=1e-12)
    went = torch.log(wsum) - wlogw / wsum
    return rgb_map, depth, acc, {"wmax": wmax, "went": went}
