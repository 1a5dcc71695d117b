"""Compositing over the ray-major packed sample buffer: CUDA kernels,
forward and backward, and their plain versions.

For the packed samples of the budget march (``occupancy/grid.py``
``march_rays_budget``: ``t0_b``, ``t1_b``, ``ray_id``, ``slot_real``,
``ray_start``), densities σ (B,) and colours (B, 3), per sample

    dt = max(t1 − t0, 0),  α = 1 − exp(−max(σ, 0)·dt)  (0 below alpha_thre > 0)
    T  = exp(Σ_{earlier samples of the ray} log(1 − α + 1e-10)),  w = α·T

and per ray rgb = Σ w·rgb (+ (1 − acc)·bg), depth = Σ w·½(t0 + t1),
acc = Σ w and, with ``with_stats``, wmax = max(0, max w) and
went = log(max(acc, 1e-12)) − Σ w·log max(w, 1e-12) / max(acc, 1e-12).
That is ``acn_tpu``'s ``composite_packed`` (``acn_tpu/nerfs/render.py:143``):
the Pallas scan (``acn_tpu/ops/segscan.py:180``) and XLA's segment sums,
differentiated through the scan's ``custom_vjp`` (the same kernel on the
reversed cotangent, ``acn_tpu/ops/segscan.py:251``). Here the forward is one
hand-written CUDA kernel for ``sm_90a`` and its gradient another
(``csrc/composite.cu``, built by ``ops/cuda_lib.py`` into the ``composite``
library and called through ``ctypes``). With the cotangents g (rgb), gd
(depth) and ga (acc) of a ray, the backward is

    u_i = g·(c_i − bg) + gd·t_mid_i + ga,   S_i = Σ_{k>i in the ray} w_k·u_k
    ∂rgb_i = w_i·g,   ∂α_i = T_i·u_i − S_i / (1 − α_i + 1e-10)
    ∂σ_i = ∂α_i·exp(−σ_i·dt_i)·dt_i (½ of it at σ = 0, 0 below, 0 where α
           was cut and on slots that are not real),   ∂bg_r = (1 − acc_r)·g

(the background head is trained, so bg has its gradient; t0 and t1 come
from the march and get none).

Bound: memory. The forward reads 24 bytes a real sample (σ, rgb, t0, t1)
and 8 a ray (``ray_start``; 12 more with a background), and writes 28 a ray
(20 without the stats): a dense 1080p chunk (B = 983,040 slots, N = 30,720
rays, 57 % real) is 15 MB, 4.5 µs at the H100's 3.35 TB/s. The backward
reads the same 24 and writes 16 a real sample, writes the zeros of the pad
slots (16 B and their flag each), and moves 32 bytes a ray (24 more with a
background) (``bytes_moved``, ``bytes_moved_backward``).

Design (the source has the detail). Forward: 16 lanes a ray, 2
consecutive samples a lane, 32 samples of a ray a step, 2 rays a warp
(chosen by measurement: a dense chunk's rays hold 18 samples on average), the lanes' log-transmittance
scanned within the group and each lane's sums closed by a butterfly.
Backward: a warp a ray, a lane a sample; a ray's last 64 samples are read
once and kept in registers, T scanned forward and S (summed from the
ray's end, as the plain reverse scan sums it) on them; a longer ray keeps
T of its earlier steps in ∂σ's slots between a walk from its start and one
from its end, each loading a step ahead (a training episode's march is
latency-bound). No atomics in either: every sum has
one fixed order, so two launches give the same bits (the ``index_add_``
they replace did not). Slots past a ray's end (the pad tail, what overflow
cut at B, rays dropped whole) are never read; only the last ray reads
``slot_real``, to find where the real slots end.

The plain versions: ``composite_plain``, the composition the port ran
before the kernels (``seg_excl_sum`` for the scan, its kernel on a CUDA
tensor, and ``index_add_`` / ``scatter_reduce_`` into a spill row for the
sums), differentiable in σ, rgb and bg; ``composite_backward_plain``, the
backward's formulas above in PyTorch (the scans' plain versions), in the
inputs' type (float64 stays float64).

Dispatch (``takes``, stated for ``nerfs/render.composite_packed``): σ, rgb,
t0 and t1 float32 CUDA tensors, and

* no gradient recorded (``torch.is_grad_enabled()`` false, as under every
  serving entry point's ``torch.no_grad``): the forward kernel, one launch;
* a gradient recorded with ``with_stats=False`` (every budget training
  loss): ``composite_autograd``, a ``torch.autograd.Function`` whose
  forward is the forward kernel and whose backward is the backward kernel,
  one launch each. Under ``create_graph`` (MAML's inner steps, seen as
  ``torch.is_grad_enabled()`` inside the backward) the backward is a VJP of
  differentiable ops instead: it runs ``composite_plain`` again on the saved
  inputs and differentiates it, so that the second derivative goes through
  the scan's double backward (``SegExclRSum``); this rule is set by what
  the caller asks, and ``CompositePacked.graph_backwards`` counts it;
* a gradient recorded with ``with_stats=True``: the plain composition (no
  caller differentiates wmax or went).

A CPU tensor takes the plain versions. A CUDA call that ``takes`` accepts
launches the kernel or raises: no switch, no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from acn_tpu_torch.models.nn import clip_half_ties
from acn_tpu_torch.ops import cuda_lib
from acn_tpu_torch.ops.hashgrid import _on_stream
from acn_tpu_torch.ops.segscan import (seg_excl_rsum_plain, seg_excl_sum,
                                       seg_excl_sum_plain)

SAMPLE_BYTES = 24  # read a real sample: σ, rgb, t0, t1 in float32
RAY_BYTES = 8  # read a ray: ray_start (int64); a background adds BG_BYTES
BG_BYTES = 12
OUT_BYTES = 28  # written a ray with the stats: rgb, depth, acc, wmax, went
OUT_BYTES_NO_STATS = 20
GRAD_SAMPLE_BYTES = 16  # backward, written a slot: ∂σ, ∂rgb (zeros on a pad)
GRAD_RAY_BYTES = 24  # backward, read a ray: the rgb, depth and acc cotangents, acc
GRAD_BG_BYTES = 24  # backward, a ray with a background: bg read, ∂bg written


def composite_plain(
    sigmas_b: torch.Tensor,  # (B,) densities at packed samples
    rgbs_b: torch.Tensor,  # (B, 3)
    samples: dict,  # march_rays_budget output (t0_b/t1_b/ray_id/slot_real)
    n_rays: int,
    bg_rgb: Optional[torch.Tensor] = None,  # (N, 3)
    alpha_thre: float = 0.0,
    with_stats: bool = True,
    scan=seg_excl_sum,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """Plain version: the segmented log-space scan, then B→N segment sums.

    Per-ray transmittance is a segment-exclusive product, computed as a
    segmented log-space scan that resets at every ray boundary (``scan``:
    ``ops.segscan.seg_excl_sum``, or its plain version to time the whole
    composition in PyTorch); per-ray accumulation is a B→N segment sum. The
    scan must be segmented: opaque samples add ≈ −23 each to the
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
    trans = torch.exp(scan(logt, seg_start))  # exclusive within ray
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


# ================================================================ backward, plain


def composite_backward_plain(
    sigmas_b: torch.Tensor,
    rgbs_b: torch.Tensor,
    samples: dict,
    n_rays: int,
    bg_rgb: Optional[torch.Tensor],
    alpha_thre: float,
    acc: torch.Tensor,  # (N,) the forward's
    g_rgb: Optional[torch.Tensor],  # (N, 3); None is zero
    g_depth: Optional[torch.Tensor] = None,  # (N,)
    g_acc: Optional[torch.Tensor] = None,  # (N,)
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the backward kernel: the gradient of
    ``composite_plain``'s rgb, depth and acc (``with_stats=False``) with
    respect to σ, rgb and the background, by the module docstring's
    formulas, in PyTorch; the transmittance by the scan's plain version and
    S by its reverse mode (summed from each ray's end). Works in the
    inputs' type. Returns (∂σ (B,), ∂rgb (B, 3), ∂bg (N, 3) or None without
    a background); every slot that is not real gets 0."""
    t0_b, t1_b = samples["t0_b"], samples["t1_b"]
    rid, real = samples["ray_id"], samples["slot_real"]
    dtype = torch.promote_types(sigmas_b.dtype, torch.float32)
    sig, rgb = sigmas_b.to(dtype), rgbs_b.to(dtype)
    t0, t1 = t0_b.to(dtype), t1_b.to(dtype)
    dt = torch.clamp(t1 - t0, min=0.0)
    ex = torch.exp(-torch.where(real, torch.clamp(sig, min=0.0), 0.0) * dt)
    alpha = 1.0 - ex
    keep = real
    if alpha_thre > 0.0:
        keep = real & (alpha >= alpha_thre)
        alpha = torch.where(alpha >= alpha_thre, alpha, 0.0)
    one_minus = 1.0 - alpha + 1e-10
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=rid.device),
                           rid[1:] != rid[:-1]])
    trans = torch.exp(seg_excl_sum_plain(torch.log(one_minus), seg_start))
    w = torch.where(real, alpha * trans, 0.0)

    rid_safe = torch.where(real, rid, n_rays)  # padding → a zero spill row

    def per_slot(v, width):
        if v is None:
            return torch.zeros((rid.shape[0], width), dtype=dtype, device=rid.device)
        v = v.to(dtype).reshape(n_rays, width)
        return torch.cat([v, v.new_zeros((1, width))])[rid_safe]

    g = per_slot(g_rgb, 3)
    u = (g * rgb).sum(1) + per_slot(g_depth, 1)[:, 0] * (0.5 * (t0 + t1)) \
        + per_slot(g_acc, 1)[:, 0]
    if bg_rgb is not None:
        u = u - (g * per_slot(bg_rgb, 3)).sum(1)
    wu = torch.where(real, w * u, 0.0)
    S = seg_excl_rsum_plain(wu, seg_start)
    d_alpha = trans * u - S / one_minus
    share = ((sig > 0).to(dtype) + (sig >= 0).to(dtype)) * 0.5  # clip_half_ties
    d_sigma = torch.where(keep, d_alpha * ex * dt * share, 0.0)
    d_rgb = torch.where(real[:, None], w[:, None] * g, 0.0)
    d_bg = None
    if bg_rgb is not None:
        gr = (torch.zeros((n_rays, 3), dtype=dtype, device=rid.device) if g_rgb is None
              else g_rgb.to(dtype))
        d_bg = (1.0 - acc.to(dtype))[:, None] * gr
    return d_sigma, d_rgb, d_bg


# ================================================================ kernels

_LIB = None


def _library() -> ctypes.CDLL:
    """The composite's library, loaded once, with its C signatures (pointers
    and the stream as ``c_void_p``)."""
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("composite")
        vp, ll, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
        ins = [vp, ll, vp, ll, vp, ll, vp, ll, vp, vp, vp, ll, ll, ll, f]
        lib.composite_fwd_f32.argtypes = ins + [vp, vp, vp, vp, vp, vp]
        lib.composite_fwd_f32.restype = ctypes.c_int
        lib.composite_bwd_f32.argtypes = ins + [vp, vp, ll, ll, vp, ll, vp, ll, vp, vp, vp, vp]
        lib.composite_bwd_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _f32_on(t: torch.Tensor, shape, dev, name: str, what: str) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"{what}: {name} {t.dtype} {tuple(t.shape)} on {t.device}, want "
                         f"float32 {tuple(shape)} on {dev}")


def _inputs(sigmas_b, rgbs_b, samples, n_rays, bg_rgb, what: str) -> tuple:
    """Check the inputs both kernels take and return (B, N, bg, the C
    arguments up to alpha_thre)."""
    dev = sigmas_b.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs tensors on a CUDA device, got {dev}")
    B = int(sigmas_b.shape[0]) if sigmas_b.dim() == 1 else -1
    _f32_on(sigmas_b, (B,), dev, "sigma", what)
    _f32_on(rgbs_b, (B, 3), dev, "rgb", what)
    if B and rgbs_b.stride(1) != 1:
        raise ValueError(f"{what}: rgb must have adjacent columns, got strides "
                         f"{rgbs_b.stride()}")
    t0_b, t1_b = samples["t0_b"], samples["t1_b"]
    _f32_on(t0_b, (B,), dev, "t0_b", what)
    _f32_on(t1_b, (B,), dev, "t1_b", what)
    start, real = samples["ray_start"], samples["slot_real"]
    N = int(n_rays)
    if start.dtype != torch.int64 or tuple(start.shape) != (N,) or start.device != dev \
            or not start.is_contiguous():
        raise ValueError(f"{what}: ray_start {start.dtype} {tuple(start.shape)} on "
                         f"{start.device}, want contiguous int64 ({N},) on {dev}")
    if real.dtype != torch.bool or tuple(real.shape) != (B,) or real.device != dev \
            or not real.is_contiguous():
        raise ValueError(f"{what}: slot_real {real.dtype} {tuple(real.shape)} on "
                         f"{real.device}, want contiguous bool ({B},) on {dev}")
    bg = None
    if bg_rgb is not None:
        bg = bg_rgb.to(device=dev, dtype=torch.float32)
        if tuple(bg.shape) != (N, 3):
            raise ValueError(f"{what}: bg_rgb {tuple(bg.shape)}, want ({N}, 3)")
        if N and bg.stride(1) != 1:
            bg = bg.contiguous()
    args = (sigmas_b.data_ptr(), sigmas_b.stride(0), rgbs_b.data_ptr(), rgbs_b.stride(0),
            t0_b.data_ptr(), t0_b.stride(0), t1_b.data_ptr(), t1_b.stride(0),
            start.data_ptr(), real.data_ptr(), None if bg is None else bg.data_ptr(),
            0 if bg is None else bg.stride(0), N, B)
    return B, N, bg, args


def composite_kernel(
    sigmas_b: torch.Tensor,
    rgbs_b: torch.Tensor,
    samples: dict,
    n_rays: int,
    bg_rgb: Optional[torch.Tensor] = None,
    alpha_thre: float = 0.0,
    with_stats: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """Launch the forward kernel once on the current stream; the arguments
    and the result are ``composite_plain``'s. σ (B,), t0 and t1 (B,):
    float32 of any stride; rgb (B, 3) float32 with adjacent columns;
    ``ray_start`` (N,) int64 and ``slot_real`` (B,) bool, contiguous; all on
    one CUDA device. ``bg_rgb`` (N, 3) is made float32 with adjacent
    columns (a copy only where it is not). The outputs are new contiguous
    tensors. Adds one to ``composite_kernel.launches`` per launch (none for N = 0)."""
    what = "the composite kernel"
    B, N, bg, args = _inputs(sigmas_b, rgbs_b, samples, n_rays, bg_rgb, what)
    dev = sigmas_b.device
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    rgb_map, depth, acc = new(N, 3), new(N), new(N)
    extras = {"wmax": new(N), "went": new(N)} if with_stats else {}
    if N == 0:
        return rgb_map, depth, acc, extras
    lib = _library()
    err = _on_stream(sigmas_b, lambda s: lib.composite_fwd_f32(
        *args, float(alpha_thre), rgb_map.data_ptr(), depth.data_ptr(), acc.data_ptr(),
        extras["wmax"].data_ptr() if with_stats else None,
        extras["went"].data_ptr() if with_stats else None, s))
    if err != 0:
        raise RuntimeError(f"composite kernel launch failed: CUDA error {err}")
    composite_kernel.launches += 1
    return rgb_map, depth, acc, extras


composite_kernel.launches = 0


def _cotangent(g: Optional[torch.Tensor], shape, dev, name: str) -> Optional[torch.Tensor]:
    if g is None:
        return None
    _f32_on(g, shape, dev, name, "the composite backward kernel")
    return g


def composite_backward_kernel(
    sigmas_b: torch.Tensor,
    rgbs_b: torch.Tensor,
    samples: dict,
    n_rays: int,
    bg_rgb: Optional[torch.Tensor],
    alpha_thre: float,
    acc: torch.Tensor,
    g_rgb: Optional[torch.Tensor],
    g_depth: Optional[torch.Tensor] = None,
    g_acc: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Launch the backward kernel once on the current stream; the arguments
    and the result are ``composite_backward_plain``'s, with the forward's
    inputs as ``composite_kernel`` takes them, ``acc`` (N,) float32
    contiguous and the cotangents float32 of any stride (None is zero). The
    gradients are new contiguous tensors, every slot written. Adds one to
    ``composite_backward_kernel.launches`` per launch."""
    what = "the composite backward kernel"
    B, N, bg, args = _inputs(sigmas_b, rgbs_b, samples, n_rays, bg_rgb, what)
    dev = sigmas_b.device
    _f32_on(acc, (N,), dev, "acc", what)
    if N and not acc.is_contiguous():
        raise ValueError(f"{what}: acc must be contiguous")
    g_rgb = _cotangent(g_rgb, (N, 3), dev, "g_rgb")
    g_depth = _cotangent(g_depth, (N,), dev, "g_depth")
    g_acc = _cotangent(g_acc, (N,), dev, "g_acc")
    d_sigma = torch.empty((B,), dtype=torch.float32, device=dev)
    d_rgb = torch.empty((B, 3), dtype=torch.float32, device=dev)
    d_bg = None if bg is None else torch.empty((N, 3), dtype=torch.float32, device=dev)
    if B == 0 and N == 0:
        return d_sigma, d_rgb, d_bg
    lib = _library()
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _on_stream(sigmas_b, lambda s: lib.composite_bwd_f32(
        *args, float(alpha_thre), acc.data_ptr(),
        ptr(g_rgb), 0 if g_rgb is None else g_rgb.stride(0),
        0 if g_rgb is None else g_rgb.stride(1),
        ptr(g_depth), 0 if g_depth is None else g_depth.stride(0),
        ptr(g_acc), 0 if g_acc is None else g_acc.stride(0),
        d_sigma.data_ptr(), d_rgb.data_ptr(), ptr(d_bg), s))
    if err != 0:
        raise RuntimeError(f"composite backward kernel launch failed: CUDA error {err}")
    composite_backward_kernel.launches += 1
    return d_sigma, d_rgb, d_bg


composite_backward_kernel.launches = 0


class CompositePacked(torch.autograd.Function):
    """rgb, depth and acc (``with_stats=False``) of the packed samples,
    differentiable in σ, rgb and bg: forward and backward kernels on the
    card, the plain versions on the CPU; under ``create_graph`` a VJP of
    ``composite_plain`` run again on the saved inputs (module docstring),
    counted in ``graph_backwards``."""

    graph_backwards = 0

    @staticmethod
    def forward(ctx, sigmas_b, rgbs_b, bg_rgb, t0_b, t1_b, ray_id, slot_real, ray_start,
                n_rays, alpha_thre, scan):
        samples = {"t0_b": t0_b, "t1_b": t1_b, "ray_id": ray_id, "slot_real": slot_real,
                   "ray_start": ray_start}
        fn = composite_kernel if sigmas_b.is_cuda else functools.partial(
            composite_plain, scan=scan)
        rgb_map, depth, acc, _ = fn(sigmas_b, rgbs_b, samples, n_rays, bg_rgb, alpha_thre,
                                    with_stats=False)
        ctx.save_for_backward(sigmas_b, rgbs_b, bg_rgb, t0_b, t1_b, ray_id, slot_real,
                              ray_start, acc)
        ctx.n_rays, ctx.alpha_thre, ctx.scan = n_rays, alpha_thre, scan
        ctx.set_materialize_grads(False)
        return rgb_map, depth, acc

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_acc):
        sig, rgb, bg, t0, t1, rid, real, start, acc = ctx.saved_tensors
        samples = {"t0_b": t0, "t1_b": t1, "ray_id": rid, "slot_real": real,
                   "ray_start": start}
        need = ctx.needs_input_grad[:3]
        none = (None,) * 8
        if torch.is_grad_enabled():  # create_graph: a VJP of differentiable ops
            CompositePacked.graph_backwards += 1
            outs = composite_plain(sig, rgb, samples, ctx.n_rays, bg, ctx.alpha_thre,
                                   with_stats=False, scan=ctx.scan)[:3]
            pairs = [(o, g) for o, g in zip(outs, (g_rgb, g_depth, g_acc)) if g is not None]
            wrt = [t for t, n in zip((sig, rgb, bg), need) if n]
            if not pairs or not wrt:
                return (None, None, None) + none
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                           [g for _, g in pairs], create_graph=True,
                                           allow_unused=True))
            return tuple(next(got) if n else None for n in need) + none
        fn = composite_backward_kernel if sig.is_cuda else composite_backward_plain
        d_sigma, d_rgb, d_bg = fn(sig, rgb, samples, ctx.n_rays, bg, ctx.alpha_thre, acc,
                                  g_rgb, g_depth, g_acc)
        return (d_sigma.to(sig.dtype) if need[0] else None,
                d_rgb.to(rgb.dtype) if need[1] else None,
                d_bg.to(bg.dtype) if need[2] else None) + none


def composite_autograd(
    sigmas_b: torch.Tensor,
    rgbs_b: torch.Tensor,
    samples: dict,
    n_rays: int,
    bg_rgb: Optional[torch.Tensor] = None,
    alpha_thre: float = 0.0,
    scan=seg_excl_sum,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """``composite_plain(..., with_stats=False)``'s result through
    ``CompositePacked`` (the kernels on the card): (rgb_map, depth, acc,
    {}). ``scan`` is the scan the ``create_graph`` route runs."""
    out = CompositePacked.apply(
        sigmas_b, rgbs_b, bg_rgb, samples["t0_b"], samples["t1_b"], samples["ray_id"],
        samples["slot_real"], samples["ray_start"], int(n_rays), float(alpha_thre), scan)
    return out[0], out[1], out[2], {}


def takes(sigmas_b: torch.Tensor, rgbs_b: torch.Tensor, samples: dict,
          with_stats: bool = True) -> bool:
    """Whether ``composite_packed`` launches the kernels: σ, rgb, t0 and t1
    are float32 CUDA tensors, and no gradient is being recorded or the
    stats are not asked for (module docstring)."""
    ts = (sigmas_b, rgbs_b, samples["t0_b"], samples["t1_b"])
    return ((not torch.is_grad_enabled() or not with_stats)
            and all(t.device.type == "cuda" and t.dtype == torch.float32 for t in ts))


def bytes_moved(n_real: int, n_rays: int, bg: bool, with_stats: bool = True) -> int:
    """The bytes the forward kernel must move for ``n_real`` real samples
    and ``n_rays`` rays: each input read once, each output written once."""
    return (SAMPLE_BYTES * n_real
            + n_rays * (RAY_BYTES + (BG_BYTES if bg else 0)
                        + (OUT_BYTES if with_stats else OUT_BYTES_NO_STATS)))


def bytes_moved_backward(n_real: int, n_slots: int, n_rays: int, bg: bool) -> int:
    """The bytes the backward kernel must move: the real samples read and
    their gradients written, the pad slots' zeros written and their flags
    read, each ray's start, cotangents and acc read, and with a background
    bg read and its gradient written."""
    return ((SAMPLE_BYTES + GRAD_SAMPLE_BYTES) * n_real
            + (GRAD_SAMPLE_BYTES + 1) * (n_slots - n_real)
            + n_rays * (RAY_BYTES + GRAD_RAY_BYTES + (GRAD_BG_BYTES if bg else 0)))


def launch_counts() -> tuple:
    """The (forward, backward) kernels' launches since the counters were
    last set to 0."""
    return composite_kernel.launches, composite_backward_kernel.launches


def zero_launch_counts() -> None:
    composite_kernel.launches = 0
    composite_backward_kernel.launches = 0
    CompositePacked.graph_backwards = 0
