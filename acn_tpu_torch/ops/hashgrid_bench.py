"""Inputs, clocks and bounds for timing the hash encode kernels
(``ops/hashgrid.py``) on one CUDA card: what ``scripts/bench_hashgrid.py``
and phase 14 of ``chip_smoke.py`` share.

* Configs: ``smoke``, ``toy.train_occ_config``'s (8 levels, F = 4, 2^17
  rows, dense levels: 833,403 rows of 32 values); ``l16f2``, the same with
  the parser's default 16 levels of F = 2; ``l16f8``, ``l40f3`` and ``f1``,
  the hash grids of ``toy.FLAG_SETS``; ``f16``, the smoke's grid at
  ``--hash_features 16`` (833,403 rows of 128 values: the widest row the
  kernels' templates take).
* Point sets: ``random``, P = 983,040 (one expert of a serving chunk),
  32,768 and 16,384 (a support and a query march) uniform points, the first
  on cell faces of every level and at 1 − 1e-6, a quarter of the cotangent
  rows zero (pad slots); ``rays``, the packed samples of a budget march (256
  bins, 32 a ray) of toy's overhead 1080p camera over toy's 10 % random
  grids (seed 0), in expert 0's box, ray-major as the encode gets them: the
  serving chunk of rows 800–815 (30,720 rays, 983,040 slots; the frame's
  middle chunk falls in the gap between the quadrants and marches nothing)
  and 1,024 rays drawn from the whole frame (32,768 slots), the cotangent
  zero on pad slots.
* Clocks: the card's time per call as a run of calls between one pair of
  CUDA events divided by their count, a spin kernel queued first so that
  the card runs them back to back; the calls cycle over copies of their
  inputs that together span ``COLD_BYTES`` (4 × the 50 MB L2), so that each
  call finds its rows in device memory, as a caller does whose tables were
  last touched a step or a chunk ago. The host's time per call (enqueue
  only) apart.
* Bounds: bytes, each distinct byte once, over 3.35 TB/s: x01, the distinct
  rows the points gather and the output; for the cotangent x01, g and one
  write of the tables.

It uses only the wrappers, the plain versions and the cell math of
``ops/hashgrid.py`` that every tree since the kernels' first version has,
so it times an older tree's kernels too (``scripts/bench_hashgrid.py``).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from acn_tpu_torch import toy
from acn_tpu_torch.ops import hashgrid as hg
from acn_tpu_torch.ops.bench_gather_scatter import HBM_BYTES_PER_S

H, W = 1080, 1920
RANDOM_P = (983_040, 32_768, 16_384)
RAY_SETS = (("chunk", 983_040), ("support", 32_768))  # (kind, slots)
SUPPORT_RAYS = 1_024
CHUNK_ROW0 = 800  # the chunk of rows 800-815, in expert 0's half of the frame
RUN_MS = 40.0  # card time a timed run aims at
L2_BYTES = 50 * 2**20  # H100 SXM
COLD_BYTES = 4 * L2_BYTES  # what the copies of a timed run's inputs span
MAX_COPIES = 16
EDGE = 1e-6
CONFIGS = ("smoke", "l16f2", "l16f8", "l40f3", "f1", "f16")


def hash_config(name: str = "smoke"):
    """The smoke model's hash config, or (``l16f2``) the same at 16 levels
    of F = 2, (``f16``) at F = 16, or that of a ``toy.FLAG_SETS``
    configuration."""
    cfg = toy.train_occ_config()[0]
    hcfg = cfg.expert.hash
    if name == "l16f2":
        return dataclasses.replace(hcfg, levels=16, features_per_level=2)
    if name == "f16":
        return dataclasses.replace(hcfg, features_per_level=16)
    if name in toy.FLAG_SETS:
        return toy.flag_config(cfg, **toy.FLAG_SETS[name]).expert.hash
    if name != "smoke":
        raise ValueError(f"unknown hash config {name!r}, want one of {CONFIGS}")
    return hcfg


def random_points(hcfg, P: int, gen: torch.Generator) -> torch.Tensor:
    """P points in [1e-6, 1 − 1e-6]³ on the generator's device, the first
    ones on the edges the bits hinge on: 1 − 1e-6 (1.0 in bf16), and faces
    k/res of every level."""
    dev = gen.device
    x = torch.rand((P, 3), generator=gen, device=dev).clamp_(EDGE, 1 - EDGE)
    x[:64] = 1 - EDGE
    for l, r in enumerate(hcfg.level_resolutions()):
        k = torch.randint(0, int(r) + 1, (64, 3), generator=gen, device=dev)
        x[64 * (l + 1):64 * (l + 2)] = (k.float() / float(r)).clamp_(EDGE, 1 - EDGE)
    return x


def budget_march(n_rays=None, seed: int = 0, device="cuda"):
    """(the packed budget march of toy's overhead camera over toy's random
    grids, the union of the experts' grids over the global box, as
    ``march_rays_budget`` returns it; the experts' boxes on ``device``):
    the serving chunk at ``CHUNK_ROW0`` (``n_rays`` None), or ``n_rays``
    rays drawn (numpy seed) from the whole frame."""
    from acn_tpu_torch.nerfs.render_occ import _any_expert_valid_fn
    from acn_tpu_torch.occupancy import grid as occ_grid
    from acn_tpu_torch.pipelines.renderer import Renderer, _pinhole_block_rays

    cfg, P, occ_cfg = toy.train_occ_config()
    boxes, _ = toy.quadrant_layout(cfg.num_submodules)
    occ = toy.random_occ_states(boxes, occ_cfg, fill=0.10, seed=0, device=device)
    aabbs = torch.from_numpy(boxes).to(device)
    renderer = Renderer(cfg, P, occ_cfg, device=device)
    cam = toy.overhead_camera(H, W)
    cam_t = renderer._camera(cam["c2w"], cam["intrinsics"], cam["aabb"], None)
    if n_rays is None:
        rows = renderer.chunk_rays // W
        rays = _pinhole_block_rays(rows, W, *cam_t, float(CHUNK_ROW0), 0.0)
    else:
        rays = _pinhole_block_rays(H, W, *cam_t, 0.0, 0.0)
        pick = np.random.default_rng(seed).choice(H * W, size=n_rays, replace=False)
        rays = rays[torch.from_numpy(np.sort(pick)).to(device)]
    base = {"binaries": torch.ones_like(occ["binaries"][0]),
            "aabbs": occ_grid.level_aabbs(torch.from_numpy(toy.SCENE_AABB).to(device),
                                          occ["binaries"].shape[1])}
    s = occ_grid.march_rays_budget(base, rays, occ_cfg, renderer.s_max, renderer.budget,
                                   extra_valid_fn=_any_expert_valid_fn(occ, aabbs))
    return s, aabbs


def ray_ordered_points(n_rays=None, seed: int = 0, device="cuda"):
    """(x01 (B, 3) float32, real (B,) bool): the packed samples of
    ``budget_march`` mapped into expert 0's box (``world_to_unit``), in the
    order the encode gets them; ``real`` marks the slots that hold a
    sample."""
    from acn_tpu_torch.models.ngp import world_to_unit

    s, aabbs = budget_march(n_rays, seed, device)
    return world_to_unit(s["xd"][:, :3], aabbs[0]).contiguous(), s["slot_real"]


def point_sets(hcfg, sets, gen):
    """[(set, P, x01 float32, g float32)] on the card; g zero on a quarter
    of the random points' rows and on every pad slot of a march."""
    L, F = hcfg.levels, hcfg.features_per_level
    out = []
    if "random" in sets:
        for P in RANDOM_P:
            x = random_points(hcfg, P, gen)
            g = torch.randn((P, L * F), generator=gen, device="cuda")
            g[::4] = 0.0
            out.append(("random", P, x, g))
    if "rays" in sets:
        for kind, slots in RAY_SETS:
            x, real = ray_ordered_points(None if kind == "chunk" else SUPPORT_RAYS)
            assert x.shape[0] == slots, (kind, x.shape)
            g = torch.randn((slots, L * F), generator=gen, device="cuda")
            g[~real] = 0.0
            out.append(("rays", slots, x, g))
    return out


def host_us(fn, reps: int) -> float:
    """The host's time per call, enqueue only: ``reps`` calls after a
    synchronize, by the host's clock, none waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us


def device_ms(fns, reps=None) -> float:
    """The card's time per call: ``reps`` calls between one pair of CUDA
    events, divided by ``reps``, cycling over ``fns`` (one callable each
    copy of the inputs; a single callable is one copy); a spin kernel
    queued first keeps the card busy while the host enqueues them, so they
    run back to back. ``reps`` defaults to what fills about ``RUN_MS`` of
    card time, and at least two rounds of the copies."""
    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    fns[-1]()
    b.record()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if reps is None:
        reps = int(min(200, max(5, 2 * len(fns), RUN_MS / max(a.elapsed_time(b), 1e-3))))
    # cycles at ≤ 2 GHz: twice the host's enqueue of the run, and 5 ms more
    torch.cuda._sleep(int(2e9 * (2.0 * reps * enqueue_s + 0.005)))
    a.record()
    for i in range(reps):
        fns[i % len(fns)]()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def copies_for(work_bytes: float) -> int:
    """Copies of a call's inputs whose working sets together span
    ``COLD_BYTES`` (1 where one call's already does)."""
    return int(min(MAX_COPIES, max(1, math.ceil(COLD_BYTES / max(work_bytes, 1.0)))))


def embedding_bag_fns(tables, x, hcfg, g):
    """One PyTorch call for the same gather-and-blend, for timing only (the
    port never calls it): ``embedding_bag(mode="sum", per_sample_weights=w)``
    on indices 8·h + c over the levels' tables stacked and viewed as
    (rows·8, F), and its backward to the table. (forward, backward)."""
    import torch.nn.functional as Fn

    F = hcfg.features_per_level
    offs = np.cumsum([0] + [int(t.shape[0]) for t in tables[:-1]])
    idx, psw = [], []
    for l in range(hcfg.levels):
        h, frac = hg._cell_index(x, hcfg, l)
        idx.append(8 * (h + int(offs[l]))[:, None]
                   + torch.arange(8, device=x.device)[None, :])
        psw.append(hg._corner_weights(hg._interp_frac(frac, hcfg.interpolation))
                   .to(tables[0].dtype))
    idx, psw = torch.cat(idx), torch.cat(psw)
    weight = torch.cat(tables).view(-1, F).requires_grad_(True)
    out = Fn.embedding_bag(idx, weight, mode="sum", per_sample_weights=psw)
    gout = g.view(-1, hcfg.levels, F).transpose(0, 1).reshape(-1, F)

    def fwd():
        with torch.no_grad():
            return Fn.embedding_bag(idx, weight, mode="sum", per_sample_weights=psw)

    return fwd, lambda: torch.autograd.grad(out, weight, gout, retain_graph=True)


def distinct_rows(x, hcfg) -> int:
    return sum(int(torch.unique(hg._cell_index(x, hcfg, l)[0]).numel())
               for l in range(hcfg.levels))


def work_bytes(x, g, tables, rows, hcfg) -> tuple:
    """(forward, cotangent) bytes each distinct byte once, and the distinct
    rows the points gather."""
    P, L, F = x.shape[0], hcfg.levels, hcfg.features_per_level
    sx, st = x.element_size(), tables[0].element_size()
    d = distinct_rows(x, hcfg)
    fwd = P * 3 * sx + d * 8 * F * st + P * L * F * st
    bwd = P * 3 * sx + P * L * F * g.element_size() + sum(rows) * 8 * F * st
    return fwd, bwd, d


def bounds_ms(x, g, tables, rows, hcfg) -> tuple:
    """(forward, cotangent) byte bounds in ms, and the distinct rows."""
    fwd, bwd, d = work_bytes(x, g, tables, rows, hcfg)
    return 1e3 * fwd / HBM_BYTES_PER_S, 1e3 * bwd / HBM_BYTES_PER_S, d


def time_kernels(tables, x, g, hcfg, rows, plain: bool = True) -> dict:
    """Card ms per call of both kernels (and their plain versions and the
    yardstick with ``plain``), each over ``copies_for`` its bytes copies of
    its inputs; the wrappers' host µs per call; the bounds."""
    dt = tables[0].dtype
    L = hcfg.levels
    fwd_b, bwd_b, d = work_bytes(x, g, tables, rows, hcfg)
    kf, kb = copies_for(fwd_b), copies_for(bwd_b)
    ins = [(tables, x, g)] + [([t.clone() for t in tables], x.clone(), g.clone())
                              for _ in range(max(kf, kb) - 1)]
    fwd = [lambda T=T, X=X: hg.hash_cell_fwd_kernel(T, X, hcfg) for T, X, _ in ins[:kf]]
    bwd = [lambda X=X, G=G: hg.hash_cell_bwd_tables_kernel(X, G, hcfg, rows, [dt] * L)
           for _, X, G in ins[:kb]]
    row = {"fwd_ms": device_ms(fwd), "bwd_ms": device_ms(bwd),
           "fwd_host_us": host_us(fwd[0], 200), "bwd_host_us": host_us(bwd[0], 200),
           "fwd_bound_ms": 1e3 * fwd_b / HBM_BYTES_PER_S,
           "bwd_bound_ms": 1e3 * bwd_b / HBM_BYTES_PER_S, "distinct_rows": d,
           "fwd_copies": kf, "bwd_copies": kb}
    if plain:
        lib = [embedding_bag_fns(T, X, hcfg, G) for T, X, G in ins]
        row.update(
            fwd_plain_ms=device_ms([lambda T=T, X=X: hg.hash_cell_fwd_plain(T, X, hcfg)
                                    for T, X, _ in ins[:kf]]),
            bwd_plain_ms=device_ms([lambda X=X, G=G: hg.hash_cell_bwd_tables_plain(
                X, G, hcfg, rows, [dt] * L) for _, X, G in ins[:kb]]),
            fwd_library_ms=device_ms([f for f, _ in lib[:kf]]),
            bwd_library_ms=device_ms([b for _, b in lib[:kb]]))
        del lib
    del ins
    return row
