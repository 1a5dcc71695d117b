"""Compositing over the ray-major packed sample buffer: a CUDA kernel and
its plain version.

For the packed samples of the budget march (``occupancy/grid.py``
``march_rays_budget``: ``t0_b``, ``t1_b``, ``ray_id``, ``slot_real``,
``ray_start``), densities σ (B,) and colours (B, 3), per sample

    dt = max(t1 − t0, 0),  α = 1 − exp(−max(σ, 0)·dt)  (0 below alpha_thre > 0)
    T  = exp(Σ_{earlier samples of the ray} log(1 − α + 1e-10)),  w = α·T

and per ray rgb = Σ w·rgb (+ (1 − acc)·bg), depth = Σ w·½(t0 + t1),
acc = Σ w and, with ``with_stats``, wmax = max(0, max w) and
went = log(max(acc, 1e-12)) − Σ w·log max(w, 1e-12) / max(acc, 1e-12).
That is ``acn_tpu``'s ``composite_packed`` (``acn_tpu/nerfs/render.py:143``):
the Pallas scan (``acn_tpu/ops/segscan.py:180``) and XLA's segment sums. It
has no TPU kernel of its own; here it is one hand-written CUDA kernel for
``sm_90a`` (``csrc/composite.cu``, built by ``ops/cuda_lib.py`` into the
scan's library, ``libsegscan``, and called through ``ctypes``).

Bound: memory. The kernel reads 24 bytes a real sample (σ, rgb, t0, t1) and
8 a ray (``ray_start``; 12 more with a background), and writes 28 a ray (20
without the stats). A dense 1080p chunk (B = 983,040 slots, N = 30,720 rays)
is at most 25.1 MB, 7.5 µs at the H100's 3.35 TB/s; its real samples
(about 57 %) make it less (``bytes_moved``).

Design (the source has the detail): one warp per ray, from ``ray_start[r]``
32 samples a step, the step's log-transmittance scanned by shuffles and
carried to the next, per-lane partial sums closed by a butterfly. No
atomics: every sum has one fixed order, so two launches give the same bits
(the ``index_add_`` it replaces did not). Slots past a ray's end (the pad
tail, what overflow cut at B, rays dropped whole) are never read; only the
last ray reads ``slot_real``, to find where the real slots end.

The plain version (``composite_plain``) is the composition the port ran
before the kernel: ``seg_excl_sum`` for the scan (its kernel on a CUDA
tensor) and ``index_add_`` / ``scatter_reduce_`` into a spill row for the
sums. It is differentiable in σ and rgb.

Dispatch (``takes``): ``nerfs/render.composite_packed`` calls the kernel
when σ, rgb, t0 and t1 are float32 CUDA tensors and no gradient is being
recorded (``torch.is_grad_enabled()`` false, as under every serving entry
point's ``torch.no_grad``; the rule of ``ngp_net.takes``). The kernel has
no backward: a loss that is differentiated (the budget regime's training
loss) keeps the plain composition, and with it the scan kernel forward and
reverse. A CPU tensor takes the plain version. A CUDA call that ``takes``
accepts launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from acn_tpu_torch.models.nn import clip_half_ties
from acn_tpu_torch.ops import cuda_lib
from acn_tpu_torch.ops.hashgrid import _on_stream
from acn_tpu_torch.ops.segscan import seg_excl_sum

SAMPLE_BYTES = 24  # read a real sample: σ, rgb, t0, t1 in float32
RAY_BYTES = 8  # read a ray: ray_start (int64); a background adds BG_BYTES
BG_BYTES = 12
OUT_BYTES = 28  # written a ray with the stats: rgb, depth, acc, wmax, went
OUT_BYTES_NO_STATS = 20


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


# ================================================================ kernel

_LIB = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("segscan")  # the scan's library holds the composite
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.composite_packed_f32.argtypes = [vp, ll, vp, ll, vp, ll, vp, ll, vp, vp, vp, ll,
                                             ll, ll, ctypes.c_float, ctypes.c_int, vp, vp]
        lib.composite_packed_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _f32_on(t: torch.Tensor, shape, dev, name: str, what: str) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"{what}: {name} {t.dtype} {tuple(t.shape)} on {t.device}, want "
                         f"float32 {tuple(shape)} on {dev}")


def composite_kernel(
    sigmas_b: torch.Tensor,
    rgbs_b: torch.Tensor,
    samples: dict,
    n_rays: int,
    bg_rgb: Optional[torch.Tensor] = None,
    alpha_thre: float = 0.0,
    with_stats: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """Launch the kernel once on the current stream; the arguments and the
    result are ``composite_plain``'s. σ (B,), t0 and t1 (B,): float32 of any
    stride; rgb (B, 3) float32 with adjacent columns; ``ray_start`` (N,)
    int64 and ``slot_real`` (B,) bool, contiguous; all on one CUDA device.
    ``bg_rgb`` (N, 3) is made float32 with adjacent columns (a copy only
    where it is not). The outputs are new contiguous tensors. Adds one to
    ``composite_kernel.launches`` per launch (none for N = 0)."""
    what = "the composite kernel"
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
    out = torch.empty(((7 if with_stats else 5) * N,), dtype=torch.float32, device=dev)
    rgb_map, depth, acc = out[:3 * N].view(N, 3), out[3 * N:4 * N], out[4 * N:5 * N]
    extras = {"wmax": out[5 * N:6 * N], "went": out[6 * N:]} if with_stats else {}
    if N == 0:
        return rgb_map, depth, acc, extras
    lib = _library()
    err = _on_stream(sigmas_b, lambda s: lib.composite_packed_f32(
        sigmas_b.data_ptr(), sigmas_b.stride(0), rgbs_b.data_ptr(), rgbs_b.stride(0),
        t0_b.data_ptr(), t0_b.stride(0), t1_b.data_ptr(), t1_b.stride(0),
        start.data_ptr(), real.data_ptr(), None if bg is None else bg.data_ptr(),
        0 if bg is None else bg.stride(0), N, B, float(alpha_thre), int(with_stats),
        out.data_ptr(), s))
    if err != 0:
        raise RuntimeError(f"composite kernel launch failed: CUDA error {err}")
    composite_kernel.launches += 1
    return rgb_map, depth, acc, extras


composite_kernel.launches = 0


def takes(sigmas_b: torch.Tensor, rgbs_b: torch.Tensor, samples: dict) -> bool:
    """Whether ``composite_packed`` launches the kernel: σ, rgb, t0 and t1
    are float32 CUDA tensors and no gradient is being recorded (module
    docstring)."""
    ts = (sigmas_b, rgbs_b, samples["t0_b"], samples["t1_b"])
    return (not torch.is_grad_enabled()
            and all(t.device.type == "cuda" and t.dtype == torch.float32 for t in ts))


def bytes_moved(n_real: int, n_rays: int, bg: bool, with_stats: bool = True) -> int:
    """The bytes the kernel must move for ``n_real`` real samples and
    ``n_rays`` rays: each input read once, each output written once."""
    return (SAMPLE_BYTES * n_real
            + n_rays * (RAY_BYTES + (BG_BYTES if bg else 0)
                        + (OUT_BYTES if with_stats else OUT_BYTES_NO_STATS)))


def launch_counts() -> int:
    """The kernel's launches since the counter was last set to 0."""
    return composite_kernel.launches


def zero_launch_counts() -> None:
    composite_kernel.launches = 0
