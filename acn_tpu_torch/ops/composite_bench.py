"""Layouts, inputs, clocks and bounds for the packed composite
(``ops/composite.py``): what ``scripts/bench_composite.py``, phase 17 of
``chip_smoke.py`` and ``tests/test_torch_composite.py`` share.

* Layouts (``LAYOUTS``, ``layout``): hand-made packed buffers as
  ``march_rays_budget`` writes them (ray r's real samples at
  ``ray_start[r]`` onward, ray-major; slots past the real ones carry ray 0
  and ray 0's first bin; ``slot_real`` a prefix), from a numpy seed, each
  named for the edge it holds: rays with no samples, rays longer than many
  warp steps (256 samples, and 600 as with ``occ_render_s_coarse``), the
  ray that overflow cuts at B and the rays dropped whole after it, a pad
  tail, a pad tail that continues ray 0's id, N = 1, a B that is a multiple
  of nothing, the inputs as unaligned strided views (``views``), and 300
  rays of 0 to 3 samples (``short_rays``: many rays a warp step, many
  warps, one-sample rays); and the kernels' step edges (a step is 32
  samples of a ray; two rays a warp in the forward, one in the backward): rays of 0, 1, 31, 32, 33, 64 and 65
  samples, each pair of a warp with an empty ray beside a one-, several-
  or step-edge ray, the last ray 64 long before a pad tail
  (``step_edges``), and overflow cutting a ray at B on a step edge, the
  rays after it dropped (``step_overflow``).
  Densities are exponential with some negative, zero, opaque (``OPAQUE``)
  and zero-width (swapped) samples; colours and backgrounds uniform.
* Chunks (``chunk``): ``dense``, the packed budget march of toy's overhead
  1080p camera over toy's 10 % grids (``hashgrid_bench.budget_march``: rows
  800–815, N = 30,720 rays, B = 983,040 slots, 32 a ray), and ``routed``,
  125,000 rays drawn from that frame marched the same way (B = 4,000,000:
  a routed chunk's size at ``chunk_points`` 4,000,000); densities and
  colours from a torch seed on the card.
* Clocks: ``ops/hashgrid_bench.py``'s (a run of calls between one pair of
  CUDA events after a spin kernel, cycling over copies of the inputs that
  span 4 × the L2; host µs apart). Timed beside the kernel: the plain
  version all in PyTorch (``composite_plain`` with the scan's plain
  version), the composition the port ran before the kernel (the same with
  the scan kernel: ``parent``), and the library chain.
* Library chain (``library_fns``): no PyTorch call computes the composite.
  The nearest chain is the elementwise ops, the scan kernel, then
  ``torch.segment_reduce`` "sum" over the six per-sample products and
  "max" over w, by the ray lengths taken from ``ray_start`` (the pad tail
  one more segment). It is a chain, not the same function, timed only.
* Bound: bytes (``composite.bytes_moved``): 24 a real sample, 8 a ray (12
  more with a background) read, 28 a ray written, over 3.35 TB/s; the
  figure over every slot of B beside it.
* Backward (``time_backward_case``): at a training episode's support and
  query march (``TRAIN_CHUNKS``, rays drawn from the frame, 32 slots a
  ray: ``configs/train_occ.json``'s 1,024 and 512, B = 32,768 and 16,384,
  and the reference scale's 4,000 and 2,000 of ``configs/train.json`` and
  the CLI's defaults, B = 128,000 and 64,000) and at the dense chunk, with random cotangents on
  rgb, depth and acc (``cotangents``): the backward kernel, its plain
  version (the formulas in PyTorch, the scans' plain versions), the
  parent's differentiated composition (``composite_plain`` with the scan
  kernel under autograd, forward and backward: what a training loss ran
  before) beside the kernels' forward and backward through
  ``composite_autograd``; no PyTorch call computes it (``library_ms``
  null). Bound ``composite.bytes_moved_backward``. ``GRAD_TOL``: rtol
  1e-5 and an atol of 1e-5 of each gradient's largest magnitude, around a
  float64 evaluation of the plain version (the plain float32 version lies
  within 7.2e-7 of it on the hand-made layouts).
"""

from __future__ import annotations

import numpy as np
import torch

from acn_tpu_torch.ops import composite as comp
from acn_tpu_torch.ops import hashgrid_bench as hb
from acn_tpu_torch.ops import segscan
from acn_tpu_torch.ops.bench_gather_scatter import HBM_BYTES_PER_S

LAYOUTS = ("empty_rays", "long_rays", "overflow", "pad_tail", "pad_after_ray0", "one_ray",
           "ragged", "views", "short_rays", "step_edges", "step_overflow")
CHUNKS = {"dense": (30_720, 983_040), "routed": (125_000, 4_000_000)}  # (N, B)
TRAIN_CHUNKS = {"support": (1_024, 32_768), "query": (512, 16_384),  # (N, B)
                "support_4000": (4_000, 128_000), "query_2000": (2_000, 64_000)}
GRAD_TOL = {"rtol": 1e-5, "atol_of_max": 1e-5}
ROUTED_RAYS = 125_000
TOL = {"rtol": 1e-5, "atol": 1e-5}  # tests/test_torch_march_render.py's
# an opaque sample's σ: σ·dt ≈ 10, α = 1 − 5e-5. At α = 1 exactly, jitted
# JAX reassociates 1 − α + 1e-10 to 0 and its scan gives NaN (−inf − −inf)
OPAQUE = 1e3


def _counts(name: str, rng) -> tuple:
    """(ray sample counts, B) of a layout."""
    if name == "empty_rays":
        c = rng.integers(1, 41, 40) * (rng.random(40) > 0.3)
        c[0] = c[-1] = 0
        return c, int(c.sum()) + 50
    if name == "long_rays":
        c = np.array([256, 33, 0, 600, 31, 64, 1])
        return c, int(c.sum()) + 7
    if name == "overflow":  # ray 12 cut at B, rays 13-19 dropped whole
        c = rng.integers(1, 65, 20)
        c[12] = 40
        return c, int(c[:12].sum()) + 17
    if name == "pad_tail":
        c = rng.integers(0, 33, 50)
        c[-1] = 5
        return c, 50 * 32
    if name == "pad_after_ray0":  # only ray 0 has samples: the pads go on with its id
        return np.array([7, 0, 0, 0, 0]), 40
    if name == "one_ray":
        return np.array([45]), 64
    if name in ("ragged", "views"):
        c = rng.integers(0, 50, 37)
        return c, 1009
    if name == "short_rays":  # many warps of rays of 0 to 3 samples, one every 7th
        c = rng.integers(0, 4, 300)
        c[::7] = 1
        return c, int(c.sum()) + 40
    if name == "step_edges":  # warps of (0, 1), (31, 0), (32, 33), (0, 64), (65, 0), (64)
        c = np.array([0, 1, 31, 0, 32, 33, 0, 64, 65, 0, 64])
        return c, int(c.sum()) + 20
    if name == "step_overflow":  # ray 2 cut at B after 64 of its 65, rays 3 and 4 dropped
        c = np.array([33, 40, 65, 10, 5])
        return c, 33 + 40 + 64
    raise ValueError(f"unknown layout {name!r}, want one of {LAYOUTS}")


def layout(name: str, seed: int = 0) -> dict:
    """A hand-made layout as numpy arrays: σ (B,), rgb (B, 3), bg (N, 3),
    samples {t0_b, t1_b, ray_id, slot_real, ray_start}, N, B, n_real."""
    rng = np.random.default_rng(seed * 100 + LAYOUTS.index(name))
    counts, B = _counts(name, rng)
    counts = counts.astype(np.int64)
    N = counts.shape[0]
    s_max = max(256, int(counts.max()) + 1)
    near = rng.uniform(0.5, 1.0, N).astype(np.float32)
    far = rng.uniform(3.0, 3.5, N).astype(np.float32)
    ray_start = np.cumsum(counts) - counts
    n_real = min(int(counts.sum()), B)
    rid = np.zeros(B, np.int64)
    sl = np.zeros(B, np.int64)  # a pad slot is ray 0's bin 0, as the marcher leaves it
    for r in range(N):
        lo, hi = int(ray_start[r]), min(int(ray_start[r] + counts[r]), B)
        if lo < hi:
            rid[lo:hi] = r
            sl[lo:hi] = np.sort(rng.choice(s_max, counts[r], replace=False))[:hi - lo]
    inv = np.float32(1.0 / s_max)
    e0 = sl.astype(np.float32) * inv
    e1 = e0 + inv
    t0 = near[rid] * (1 - e0) + far[rid] * e0
    t1 = near[rid] * (1 - e1) + far[rid] * e1
    sw = (rng.random(B) < 0.02) & (np.arange(B) < n_real)  # swapped: dt clamps to 0
    t0[sw], t1[sw] = t1[sw], t0[sw].copy()
    sigma = rng.exponential(30.0, B).astype(np.float32)
    sigma[rng.random(B) < 0.05] = -1.0
    sigma[rng.random(B) < 0.02] = OPAQUE
    sigma[rng.random(B) < 0.05] = 0.0
    return {"sigma": sigma, "rgb": rng.random((B, 3)).astype(np.float32),
            "bg": rng.random((N, 3)).astype(np.float32),
            "samples": {"t0_b": t0.astype(np.float32), "t1_b": t1.astype(np.float32),
                        "ray_id": rid, "slot_real": np.arange(B) < n_real,
                        "ray_start": ray_start},
            "N": N, "B": B, "n_real": n_real, "counts": counts}


def _offset_view(a: torch.Tensor, device) -> torch.Tensor:
    """``a`` as a view one element into a larger buffer (not 16-byte aligned)."""
    buf = torch.zeros((a.numel() + 1,), dtype=a.dtype, device=device)
    buf[1:] = a.reshape(-1).to(device)
    return buf[1:].view(a.shape)


def tensors(case: dict, device="cpu", views=None) -> tuple:
    """(σ, rgb, samples, N, bg) of a layout on ``device``. With ``views``
    (the ``views`` layout's default): σ and rgb as columns of one (B, 4)
    buffer a row in, t0 and t1 and bg at offsets of one element (bg with
    a row stride of 4)."""
    views = case.get("name") == "views" if views is None else views
    dev = torch.device(device)
    s = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in case["samples"].items()}
    sig, rgb = torch.from_numpy(case["sigma"]), torch.from_numpy(case["rgb"])
    bg = torch.from_numpy(case["bg"])
    if not views:
        return sig.to(dev), rgb.to(dev), s, case["N"], bg.to(dev)
    B, N = case["B"], case["N"]
    out = torch.zeros((B + 1, 4), dtype=torch.float32, device=dev)
    out[1:, :3], out[1:, 3] = rgb.to(dev), sig.to(dev)
    bgb = torch.zeros((N + 1, 4), dtype=torch.float32, device=dev)
    bgb[1:, :3] = bg.to(dev)
    s["t0_b"], s["t1_b"] = _offset_view(s["t0_b"], dev), _offset_view(s["t1_b"], dev)
    return out[1:, 3], out[1:, :3], s, N, bgb[1:, :3]


def cases(seed: int = 0) -> dict:
    """Every layout by name, with its name inside."""
    return {name: {**layout(name, seed), "name": name} for name in LAYOUTS}


def chunk(kind: str, seed: int = 17, device="cuda") -> tuple:
    """(σ, rgb, samples, N, bg) of a real chunk (module docstring) on the
    card: σ exponential (mean 20), rgb and bg uniform, from a seed. ``kind``
    is one of ``CHUNKS`` or ``TRAIN_CHUNKS``."""
    rays = {"dense": None, "routed": ROUTED_RAYS,
            **{k: n for k, (n, _) in TRAIN_CHUNKS.items()}}[kind]
    s, _ = hb.budget_march(rays, 0, device)
    N = int(s["ray_start"].shape[0])
    B = int(s["t0_b"].shape[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    sig = torch.empty((B,), device=device).exponential_(1 / 20.0, generator=gen)
    rgb = torch.rand((B, 3), generator=gen, device=device)
    bg = torch.rand((N, 3), generator=gen, device=device)
    keep = ("t0_b", "t1_b", "ray_id", "slot_real", "ray_start")
    return sig, rgb, {k: s[k] for k in keep}, N, bg


def n_real(samples: dict) -> int:
    return int(samples["slot_real"].sum())


def bounds_ms(samples: dict, N: int, bg: bool, with_stats: bool = True) -> dict:
    """The byte bound at this layout's real samples, and over every slot."""
    B = int(samples["t0_b"].shape[0])
    real = comp.bytes_moved(n_real(samples), N, bg, with_stats)
    every = comp.bytes_moved(B, N, bg, with_stats)
    return {"bytes": real, "bound_ms": 1e3 * real / HBM_BYTES_PER_S,
            "bound_every_slot_ms": 1e3 * every / HBM_BYTES_PER_S, "bound_by": "bytes"}


def lengths(samples: dict, N: int) -> torch.Tensor:
    """Each ray's real samples, then the rest of B as one more segment:
    the lengths ``torch.segment_reduce`` takes (they sum to B)."""
    B = int(samples["t0_b"].shape[0])
    start = samples["ray_start"].clamp(max=B)
    nr = n_real(samples)
    end = torch.cat([start[1:], start.new_tensor([nr])]).clamp(max=nr)
    return torch.cat([(end - start).clamp(min=0), start.new_tensor([B - nr])])


def library_fns(sig, rgb, samples, N, bg, alpha_thre=0.0):
    """The library chain (module docstring) as a callable, its lengths made
    here (set-up, not timed)."""
    lens = lengths(samples, N)
    t0, t1, real = samples["t0_b"], samples["t1_b"], samples["slot_real"]
    rid = samples["ray_id"]
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=rid.device),
                           rid[1:] != rid[:-1]])

    def run():
        dt = torch.clamp(t1 - t0, min=0.0)
        s = torch.where(real, torch.clamp(sig, min=0.0), 0.0)
        alpha = 1.0 - torch.exp(-s * dt)
        if alpha_thre > 0.0:
            alpha = torch.where(alpha >= alpha_thre, alpha, 0.0)
        trans = torch.exp(segscan.seg_excl_sum_kernel(torch.log(1.0 - alpha + 1e-10),
                                                       seg_start))
        w = alpha * trans
        vals = torch.cat([w[:, None] * rgb, (w * 0.5 * (t0 + t1))[:, None], w[:, None],
                          (w * torch.log(torch.clamp(w, min=1e-12)))[:, None]], dim=1)
        sums = torch.segment_reduce(vals, "sum", lengths=lens, axis=0)[:N]
        wmax = torch.segment_reduce(w, "max", lengths=lens, axis=0, initial=0.0)[:N]
        return sums, wmax

    return run


def time_case(sig, rgb, samples, N, bg, alpha_thre: float = 0.0) -> dict:
    """Card ms per call of the kernel, the plain version (all PyTorch), the
    parent's composition (the scan kernel and ``index_add_``) and the
    library chain, each over copies of the inputs that span 4 × the L2; the
    kernel's host µs per call; the bounds."""
    bounds = bounds_ms(samples, N, bg is not None)
    copies = hb.copies_for(bounds["bytes"])
    clone = lambda s: {k: v.clone() for k, v in samples.items()}
    runs = [(sig, rgb, samples, bg)] + [(sig.clone(), rgb.clone(), clone(samples),
                                         None if bg is None else bg.clone())
                                        for _ in range(copies - 1)]
    kern = lambda a: comp.composite_kernel(a[0], a[1], a[2], N, a[3], alpha_thre)
    row = {"N": N, "B": int(sig.shape[0]), "n_real": n_real(samples), "copies": copies,
           **bounds,
           "ms": hb.device_ms([lambda a=a: kern(a) for a in runs]),
           "host_us": hb.host_us(lambda: kern(runs[0]), 200)}
    for key, scan in (("plain_ms", segscan.seg_excl_sum_plain),
                      ("parent_ms", segscan.seg_excl_sum)):
        row[key] = hb.device_ms([lambda a=a, scan=scan: comp.composite_plain(
            a[0], a[1], a[2], N, a[3], alpha_thre, scan=scan) for a in runs])
    row["library_ms"] = hb.device_ms([library_fns(*a[:3], N, a[3], alpha_thre)
                                      for a in runs])
    del runs
    return row


def outputs(out: tuple) -> list:
    """A composite's outputs as one list: rgb, depth, acc, then the stats."""
    return list(out[:3]) + list(out[3].values())


def max_abs_err(got: tuple, want: tuple) -> float:
    """The largest |difference| over rgb, depth, acc and the stats."""
    return max(float((a.float().cpu() - b.float().cpu()).abs().max()) if a.numel() else 0.0
               for a, b in zip(outputs(got), outputs(want)))


def within_tol(got: tuple, want: tuple) -> bool:
    """Every output within ``TOL`` (rtol and atol 1e-5) of the reference,
    every one finite."""
    return all(bool(torch.isfinite(a).all()) and torch.allclose(
        a.float().cpu(), b.float().cpu(), **TOL) for a, b in zip(outputs(got), outputs(want)))


def cotangents(N: int, seed: int = 29, device="cuda") -> tuple:
    """(g_rgb (N, 3), g_depth (N,), g_acc (N,)): standard normal, from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((N, 3), generator=gen, device=device),
            torch.randn((N,), generator=gen, device=device),
            torch.randn((N,), generator=gen, device=device))


def backward_f64(sig, rgb, samples, N, bg, alpha_thre, acc, g) -> tuple:
    """The plain backward in float64 on the inputs' device: the reference
    both the kernel and the float32 plain version are held to."""
    d = lambda t: None if t is None else t.double()
    s64 = {k: d(v) if v.is_floating_point() else v for k, v in samples.items()}
    return comp.composite_backward_plain(d(sig), d(rgb), s64, N, d(bg), alpha_thre, d(acc),
                                         *(d(x) for x in g))


def grad_err(got: tuple, want: tuple) -> float:
    """The largest |difference| of the gradients over each one's largest
    magnitude (None where a gradient is absent)."""
    out = 0.0
    for a, b in zip(got, want):
        if a is None or b is None or not b.numel():
            continue
        scale = max(float(b.abs().max()), 1e-30)
        out = max(out, float((a.double() - b.double()).abs().max()) / scale)
    return out


def grads_within_tol(got: tuple, want: tuple) -> bool:
    """Every gradient finite and within ``GRAD_TOL`` of the reference."""
    for a, b in zip(got, want):
        if (a is None) != (b is None):
            return False
        if a is None or not b.numel():
            continue
        atol = GRAD_TOL["atol_of_max"] * float(b.abs().max())
        if not (bool(torch.isfinite(a).all()) and torch.allclose(
                a.double(), b.double(), rtol=GRAD_TOL["rtol"], atol=atol)):
            return False
    return True


def backward_bounds_ms(samples: dict, N: int, bg: bool) -> dict:
    B = int(samples["t0_b"].shape[0])
    nb = comp.bytes_moved_backward(n_real(samples), B, N, bg)
    return {"bytes": nb, "bound_ms": 1e3 * nb / HBM_BYTES_PER_S, "bound_by": "bytes"}


def floor_ms(device) -> float:
    """Card ms per call of a one-element add by ``hb.device_ms``'s clock."""
    one = torch.zeros(1, device=device)
    return hb.device_ms([lambda: one.add_(1.0)])


def time_backward_case(sig, rgb, samples, N, bg, alpha_thre: float = 0.0) -> dict:
    """Card ms per call of the backward kernel, its plain version, the
    parent's differentiated composition (forward and backward) and the
    kernels' forward and backward through autograd, each over copies of the
    inputs that span 4 × the L2; the backward kernel's host µs per call;
    the byte bound; and ``floor_ms``, a one-element add by the same clock
    (what a launch costs that moves nothing: at a support march the byte
    bound lies far below it)."""
    bounds = backward_bounds_ms(samples, N, bg is not None)
    copies = hb.copies_for(bounds["bytes"])
    clone = lambda s: {k: v.clone() for k, v in samples.items()}
    runs = [(sig, rgb, samples, bg)] + [(sig.clone(), rgb.clone(), clone(samples),
                                         None if bg is None else bg.clone())
                                        for _ in range(copies - 1)]
    g = cotangents(N, device=sig.device)
    accs = [comp.composite_kernel(a[0], a[1], a[2], N, a[3], alpha_thre, False)[2]
            for a in runs]
    bwd = lambda a, acc: comp.composite_backward_kernel(a[0], a[1], a[2], N, a[3],
                                                        alpha_thre, acc, *g)

    def through_autograd(a, fn):
        x = a[0].detach().requires_grad_()
        y = a[1].detach().requires_grad_()
        b = None if a[3] is None else a[3].detach().requires_grad_()
        out = fn(x, y, a[2], N, b, alpha_thre)
        loss = sum((o * gi).sum() for o, gi in zip(out[:3], g))
        torch.autograd.grad(loss, [t for t in (x, y, b) if t is not None])

    parent = lambda x, y, s, n, b, t: comp.composite_plain(x, y, s, n, b, t, False,
                                                           scan=segscan.seg_excl_sum)
    row = {"N": N, "B": int(sig.shape[0]), "n_real": n_real(samples), "copies": copies,
           **bounds,
           "ms": hb.device_ms([lambda a=a, c=c: bwd(a, c) for a, c in zip(runs, accs)]),
           "host_us": hb.host_us(lambda: bwd(runs[0], accs[0]), 200),
           "plain_ms": hb.device_ms([lambda a=a, c=c: comp.composite_backward_plain(
               a[0], a[1], a[2], N, a[3], alpha_thre, c, *g) for a, c in zip(runs, accs)]),
           "parent_fwd_bwd_ms": hb.device_ms([lambda a=a: through_autograd(a, parent)
                                              for a in runs]),
           "kernels_fwd_bwd_ms": hb.device_ms([lambda a=a: through_autograd(
               a, comp.composite_autograd) for a in runs]),
           "floor_ms": floor_ms(sig.device),
           "library_ms": None}
    del runs, accs
    return row
