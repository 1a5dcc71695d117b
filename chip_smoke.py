#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (acn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --profile DIR   # also profile one dense, routed
                                          # and baked frame, and one budget,
                                          # stratified and strided step each,
                                          # tables in DIR

Phases, each printing one JSON line and each fatal on failure:

1. device: the card (``nvidia-smi`` name and power limit) and the build of
   the CUDA kernel library from the sources in ``acn_tpu_torch/csrc``;
2. kernel: each kernel against its plain PyTorch version on the card, on
   edge cases and at the serving shape, forward, backward through autograd
   and the reverse kernel directly, on an unaligned view, on two streams at
   once and across the wrap of its launch epoch, with times (CUDA events)
   beside the least time the card could take, and a sweep of sizes;
3. main path: full 1080×1920 frames of the ``configs/train_occ.json`` model
   (random weights from a seed) through ``Renderer.render_image``, with the
   kernel's launch count held to chunks × frames and the host's waits for
   the card in one frame (PyTorch's sync debug mode) held below one per
   chunk;
4. main path vs CPU: ``render_rays`` on the card (kernel) against
   ``render_rays`` on the CPU (plain scan) on 2,048 rays of that frame, at
   the config's alpha threshold and at alpha threshold 0 with the σ-head
   bias raised to +2 (so the scan sees opaque samples);
5. train step: four FoMAML meta-training steps (one warm, three timed) of
   that model through ``make_meta_train_step`` in the packed-budget regime,
   bf16 compute, 3 tasks of 1,024 support and 512 query rays per expert,
   draws from a seeded generator on the card; every metric finite, every parameter
   moved, the optimizer's count at 4, and the scan's forward and reverse
   kernels each launched K·T·(inner_iter + 1) = 108 times per step; the
   host's waits for the card in one step; both kernels against their plain
   versions, and timed, on the segments of a real support and query march
   (B = 32,768 and 16,384); one episode's loss and gradient on the card
   (kernels) against the CPU (plain scans) in float32; and that episode in
   bf16, as the step runs it, on the card against the CPU and against
   float32 on the card (loss, and each parameter group's gradient as one
   vector, in length and direction);
6. the regime schedule of a run of ``configs/train_occ.json``, at full
   width (K 4, T 3, S 1,024, Q 512, 8 inner steps, bf16, 256 bins, 64 kept
   samples, 128³ grids), on a fresh model (seed 1): (a) two stratified
   steps (96 samples per ray); (b) two passes of the all-expert occupancy
   update built from that model, each checked against its own EMA and
   threshold, and one expert's update at 32³ (hash features scaled so
   that σ varies over the grid) on the card against the CPU with the same
   injected jitter; (c) five strided steps on 10 % random grids
   (``bench.py``'s "auto" regime) with ``report_budget`` 32, 2, 32, 32, 32,
   whose would-be overflows feed ``AutoRegime``: the overflowing reading
   at budget 2 restarts its count and it must fire on the fifth; one
   strided step on the updated grids, the budget step after the switch,
   and one float32 strided episode on the card against the CPU; (d) the
   budget-0 renderer (strided march, ``render_rays_occ``): ``render_rays``
   on the card against the CPU, a warm 1080p frame and a timed one. The
   stratified and strided steps and the budget-0 renderer must launch no
   scan kernel; the budget step after the switch 108 forward and 108
   reverse;
7. the training loop, ``meta_trainer``, at full width on a synthetic
   dataset: per expert 32 cameras of 192 × 256 pixels over its quadrant
   (``toy.camera_ray_stores``, 1,572,864 rays), routed to 5 × 5 micro-cells,
   sampled on the card (``make_device_batch_fn`` over the pools of
   ``build_device_pools``), grids premarked from the same cameras; a model
   whose density varies over the grid (``LOOP_*``); the schedule cut to 12
   steps (warm-up 3, update every 2, the switch after 2 readings, eval every
   4 on one test task, a step save every 6), then a resume from ``step6``
   for two steps. It fails unless the steps run stratified, strided, then
   budget after the switch, with 0 scan launches in the first two and 108 +
   108 in each budget step; the card's sampler gives the CPU's ids on the
   same draws and never a padded ray, support and query apart; ``best``,
   ``step6``, ``step12`` and ``last`` are written, and ``best``, ``step6``
   and ``last`` reload bit for bit (``last`` equal to the run's end); the
   resumed run
   starts from step 6's state (best, optimizer count, grids, regime), and
   its non-log step waits for the card no more often than phase 5's bare
   step; every metric finite;
8. the runner on a dataset on disk, at ``configs/train_occ.json``'s width:
   (a) ``toy.write_dataset_dir`` writes 32 train and 8 val views of
   192 × 256 over the 4 quadrants (PNGs, zipped masks) into
   ``logs/chip_smoke_runner/``; (b) ``runner.main`` runs ``--op train`` with
   ``configs/train_occ.json`` cut to 8 steps (warm-up 2, the switch after 1
   reading, eval and save every 4, the grids rebuilt every 2 steps: the
   runner's update interval is patched, it has no flag), building the ray
   stores and routes afresh; it fails unless the run trains stratified,
   then packed-budget after the switch, every budget step launching 108 +
   108 scans and no other step any, and ``last`` and ``step4`` carry grids
   and optimizer; (c) ``--op eval --configPath configs/eval.json --prefix
   last --tto 0,2,0 --test_batch_size 4`` on that run: the forward scan
   launched once per chunk of every frame (chunks × 8 views × 3 settings)
   and the reverse never, PSNR and SSIM finite with SSIM in [-1, 1], the
   TTO losses finite, and the two ``tto=0`` legs' scores bit-equal (the base
   weights are restored between settings); (d) card against CPU: one
   float32 TTO step of ``last`` on 1,024 rays with injected draws (loss,
   gradient, parameters), SSIM and LPIPS (fallback weights) of one
   rendered view, and SSIM of a nearly constant image against itself;
9. serving beyond the dense frame, at ``configs/train_occ.json``'s width on
   phase 3's model and grids (σ-head bias +2, as phase 4 leaves it) and
   phase 8's run (its directory removed at the end): (a) 1080p routed frames (``render_image_routed``, the 4
   quadrant experts' rects): one warm, two timed, one downloaded, the
   forward scan launched once per dispatched chunk and the reverse never;
   with every expert set to expert 0's weights, box and grid, the routed
   frame equals the dense ``render_image`` one within 0.02 in rgb and acc
   (the tolerances of ``tests/test_renderer_routed.py:50-68``); a 64 × 96
   routed frame on the card against the CPU (u8 rgb within 1/255, f16
   depth/acc rtol 1e-3); (b) ``render_image(active_module=k)`` per expert
   at budget 32 (a scan per chunk), budget 0 (none) and with
   ``occ_render_s_coarse`` 32, and the range pre-pass's mean kept share of
   each ray; (c) ``--op bake`` of phase 8's ``last`` at ``--bake_resolution
   256`` (the flag's default 512 cut for time), timed; ``load_baked`` gives
   back the table and grid bit for bit; ``bake_field`` at 24³ (chunk 24³)
   with SH 0 and SH 1 on the card against the CPU, f32 atol 1e-5 / rtol
   1e-5; (d) 1080p ``BakedRenderer`` frames at budget 24, with the range
   pre-pass of 32 bins, and at budget 0 (a scan per chunk, none at 0); a
   64 × 96 baked frame on the card against the CPU; (e) ``--op eval
   --baked_asset --tto 0,2``: finite PSNR and SSIM, the ``tto=2`` leg
   rendered without adaptation (``acn_tpu``'s log line) and scored as
   ``tto=0`` within 1e-3 dB and 1e-4 SSIM per view (atomic sums may move a
   pixel by one u8 step between two renders), scans as the merged
   ``occ_budget_per_ray`` says; (f) ``--op
   video --video_frames 8``, live and baked: a file of 8 frames, the
   encoder named, a scan per chunk per frame on budget paths;
10. the kernels line, then the card's ``nvidia-smi`` line, then the result
   line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is present.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np

H, W = 1080, 1920
SERVING_B = 983_040  # packed samples per 1080p chunk (30,720 rays × 32)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
EPS32 = float(np.finfo(np.float32).eps)
# the bf16 episode against a second computation of it: the loss within this
# relative error; a parameter group's gradient, as one vector, within this
# factor in length and this cosine in direction
BF16_LOSS_RTOL = 2e-3
BF16_NORM_FACTOR = 1.05
BF16_MIN_COS = 0.99


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2


def scan_cases(torch, segscan):
    """(name, x f32, starts bool, offset) on the CPU. Boundaries are placed
    on the kernel's own edges: tiles of ``segscan.TILE`` elements, warps of
    ``segscan.WARP``, threads of ``segscan.ITEMS``. ``offset`` > 0 asks for
    the buffers as views that many elements into larger ones."""
    T, Wp, I = segscan.TILE, segscan.WARP, segscan.ITEMS
    g = np.random.default_rng(0)

    def segs(n, mean):
        s = g.random(n) < 1.0 / mean
        s[0] = True
        return s

    def only(n, *slices):
        s = np.zeros(n, bool)
        for sl in slices:
            s[sl] = True
        s[0] = True
        return s

    cases = []
    for n in (1, 31):  # less than a warp of one tile
        cases.append((f"tiny_{n}", g.normal(size=n), segs(n, 7), 0))
    n = 3 * T + 357  # the tail tile takes the scalar path
    cases.append(("ragged_length", g.normal(size=n), segs(n, 7), 0))
    n = 7 * T + 4 * 11 + 3  # n % 4 == 3, n % 16 == 15
    cases.append(("length_not_multiple_of_4", g.normal(size=n), segs(n, 50), 0))
    # contiguous but 4 bytes (1 byte for the flags) off 16-byte alignment:
    # the wrapper takes it and every tile runs the scalar path
    n = 6 * T + 2
    cases.append(("offset_view", g.normal(size=n), segs(n, 9), 1))
    n = 5 * T + 11  # the look-back runs the whole chain of tiles
    cases.append(("one_segment", g.normal(size=n), only(n), 0))
    n = 100 * T + 11  # ... over more than one window of 32 states
    cases.append(("one_segment_long", g.normal(size=n), only(n), 0))
    n = 2 * T + 5
    cases.append(("single_samples", g.normal(size=n), np.ones(n, bool), 0))
    n = 8 * T
    cases.append(("tile_warp_thread_edges", g.normal(size=n),
                  only(n, slice(None, None, T), slice(Wp, None, 2 * Wp),
                       slice(I, None, Wp + I), slice(T - 1, None, T)), 0))
    # one boundary per tile, at its last / its first element: every
    # aggregate is closed by a boundary and the carry is a whole tile's sum
    n = 40 * T
    cases.append(("boundary_at_tile_last", g.normal(size=n),
                  only(n, slice(T - 1, None, T)), 0))
    cases.append(("boundary_at_tile_first", g.normal(size=n),
                  only(n, slice(None, None, T)), 0))
    # opaque scale: ≈ −23 per sample, segments of 1..256 samples
    n = SERVING_B
    s = only(n, np.cumsum(g.integers(1, 257, n // 64)).clip(max=n - 1))
    cases.append(("opaque_scale", -23.0 + g.normal(size=n), s, 0))
    # a grid of more blocks than the card holds at once: rays, and one
    # segment whose chain of tiles runs from wave to wave
    n = 3_000_000
    cases.append(("multi_pass_aggregates", g.normal(size=n), segs(n, 40), 0))
    cases.append(("one_segment_many_waves", g.normal(size=n + 5), only(n + 5), 0))
    # the serving shape as composite_packed makes it: per-ray segments of
    # log(1 − α) over the real slots, then a tail of pad slots (ray 0)
    n = SERVING_B
    n_real = int(0.8 * n)
    lens = g.integers(1, 64, n)
    s = only(n, np.cumsum(lens)[np.cumsum(lens) < n_real], n_real)
    alpha = np.where(np.arange(n) < n_real, g.random(n) ** 3, 0.0)
    cases.append(("serving", np.log(1.0 - alpha * 0.999 + 1e-10), s, 0))
    return [(name, torch.from_numpy(x.astype(np.float32)),
             torch.from_numpy(s), off) for name, x, s, off in cases]


def compare(got, want, x, starts) -> dict:
    """|got − want| against a tolerance per element: 32 ulp of the |x| sum
    of the element's own segment (the kernel and the plain version add in
    different orders) plus 1e-6 of |want|. A fault in short segments cannot
    hide under the tolerance of a long one."""
    got, want = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    x, starts = x.detach().cpu().numpy(), starts.cpu().numpy()
    seg = np.cumsum(starts) - 1
    tol = 32 * EPS32 * np.bincount(seg, np.abs(x))[seg] + 1e-6 * np.abs(want)
    err = np.abs(got - want)
    i = int(np.argmax(err - tol))  # the element closest to failing
    return {"err": float(err.max()), "ok": bool(np.all(err <= tol)),
            "worst_err": float(err[i]), "worst_tol": float(tol[i])}


def on_card(torch, t, offset: int):
    """``t`` on the card; with ``offset``, as a view that many elements into
    a larger buffer: contiguous, but not 16-byte aligned."""
    if not offset:
        return t.cuda()
    view = torch.cat([t.new_ones(offset), t]).cuda()[offset:]
    check(view.data_ptr() % 16 != 0, "the offset view is 16-byte aligned")
    return view


def check_two_streams(torch, segscan, a, b) -> dict:
    """Forward and reverse scans of two buffers queued on two streams at
    once (both streams held back first, so that the kernels overlap), each
    against its plain version. The streams' scratch buffers differ."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    want = [(segscan.seg_excl_sum_plain(x, s), segscan.seg_excl_rsum_plain(x, s))
            for x, s in (a, b)]
    torch.cuda.synchronize()
    got, scratch = [], []
    for st, (x, s) in zip(streams, (a, b)):
        with torch.cuda.stream(st):
            torch.cuda._sleep(100_000_000)
            got.append([(segscan.seg_excl_sum_kernel(x, s),
                         segscan.seg_excl_rsum_kernel(x, s)) for _ in range(4)])
            scratch.append(segscan.scan_scratch(x.device).data_ptr())
    torch.cuda.synchronize()
    check(scratch[0] != scratch[1], "two streams share one scratch buffer")
    ok = all(compare(f, w[0], x, s)["ok"] and compare(r, w[1], x, s)["ok"]
             for runs, w, (x, s) in zip(got, want, (a, b)) for f, r in runs)
    check(ok, "scans queued on two streams at once disagree with the plain version")
    return {"streams": 2, "scans_per_stream": 8, "ok": ok}


def check_epoch_wrap(torch, segscan, short, long) -> dict:
    """Scans across the wrap of the launch epoch kept in the scratch buffer:
    two launches of few tiles at the last two epochs, then launches of many
    tiles at epochs 0, 1, ... A state planted beyond the short launches'
    tiles, valid-looking for epoch 0, must have been zeroed by the wrap."""
    x, s = long
    scratch = segscan.scan_scratch(x.device)
    torch.cuda.synchronize()
    scratch[0] = (segscan.EPOCH_MAX - 1) << 32
    planted = 2 + 50  # the state of tile 50: epoch 0, prefix, value 1e9
    scratch[planted] = (2 << 32) | int(np.float32(1e9).view(np.uint32))
    epochs, ok = [], True
    for i, (xi, si) in enumerate((short, short, long, long, long)):
        kernel, plain = ((segscan.seg_excl_sum_kernel, segscan.seg_excl_sum_plain)
                         if i % 2 == 0 else
                         (segscan.seg_excl_rsum_kernel, segscan.seg_excl_rsum_plain))
        ok &= compare(kernel(xi, si), plain(xi, si), xi, si)["ok"]
        word = int(scratch[0])
        epochs.append(word >> 32)
        ok &= word & 0xffffffff == 0  # the ticket is back at 0
        if i == 1:  # the launch at the last epoch zeroed every state
            ok &= int(scratch[planted]) == 0
    want = [segscan.EPOCH_MAX, 0, 1, 2, 3]
    check(ok and epochs == want, f"scans across the epoch's wrap: results ok "
          f"{ok}, epochs after each launch {epochs}, want {want}")
    return {"epochs_after_each_launch": epochs, "ok": ok}


def phase_kernel(torch, segscan, bench):
    time_ms = bench.time_ms
    errs, worst = {}, 0.0
    cases = scan_cases(torch, segscan)
    on = {name: (on_card(torch, x, off), on_card(torch, s, off))
          for name, x, s, off in cases}
    for name, x, s, off in cases:
        xc = on_card(torch, x, off).requires_grad_(True)
        sc = on[name][1]
        gr = on_card(torch, torch.randn(
            x.shape, generator=torch.Generator().manual_seed(1)), off)
        counts = (segscan.seg_excl_sum_kernel.launches,
                  segscan.seg_excl_rsum_kernel.launches)
        got = segscan.seg_excl_sum(xc, sc)  # kernel, forward
        (got * gr).sum().backward()  # reverse kernel, through autograd
        rev = segscan.seg_excl_rsum_kernel(gr, sc)  # reverse kernel, directly
        check((segscan.seg_excl_sum_kernel.launches,
               segscan.seg_excl_rsum_kernel.launches)
              == (counts[0] + 1, counts[1] + 2),
              f"{name}: want one forward and two reverse launches")
        xp = on_card(torch, x, off).requires_grad_(True)
        want = segscan.seg_excl_sum_plain(xp, sc)  # plain, on the card
        (want * gr).sum().backward()
        want_rev = segscan.seg_excl_rsum_plain(gr, sc)
        torch.cuda.synchronize()
        # the reverse scan runs over the same segments
        res = {"fwd": compare(got, want, x, s),
               "bwd": compare(xc.grad, xp.grad, gr, s),
               "rev": compare(rev, want_rev, gr, s)}
        errs[name] = {"n": int(x.numel()), "offset": off, **res}
        check(all(r["ok"] and math.isfinite(r["err"]) for r in res.values()),
              f"kernel disagrees with the plain version on {name}: {errs[name]}")
        worst = max(worst, *(r["err"] for r in res.values()))

    two = check_two_streams(torch, segscan, on["multi_pass_aggregates"], on["serving"])
    wrap = check_epoch_wrap(torch, segscan, on["one_segment"], on["one_segment_long"])

    x, s = on["serving"]
    g = torch.randn(SERVING_B, generator=torch.Generator().manual_seed(2)).cuda()

    def via_flips():  # the backward as it was: three copies and a forward scan
        end = torch.cat([s[1:], s.new_ones(1)])
        return segscan.seg_excl_sum_kernel(g.flip(0), end.flip(0)).flip(0)

    def in_a_row():
        for _ in range(10):
            segscan.seg_excl_sum_kernel(x, s)

    one = torch.zeros(1, device="cuda")
    zero, y = torch.zeros((), device="cuda"), torch.empty_like(x)
    ms = time_ms(lambda: segscan.seg_excl_sum_kernel(x, s), 100)
    reverse_ms = time_ms(lambda: segscan.seg_excl_rsum_kernel(g, s), 100)
    flips_ms = time_ms(via_flips, 100)
    plain_ms = time_ms(lambda: segscan.seg_excl_sum_plain(x, s), 20)
    reverse_plain_ms = time_ms(lambda: segscan.seg_excl_rsum_plain(g, s), 20)
    bytes_moved = SERVING_B * (4 + 1 + 4)  # read x and flag, write out
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S,
                         SERVING_B / F32_OPS_PER_S)
    emit({"phase": "kernel", "name": "seg_excl_sum", "cases": errs,
          "two_streams": two, "epoch_wrap": wrap,
          "max_abs_err": worst, "B": SERVING_B, "ms": ms,
          "reverse_ms": reverse_ms, "reverse_via_flips_ms": flips_ms,
          "plain_ms": plain_ms, "reverse_plain_ms": reverse_plain_ms,
          "bound_ms": bound_ms, "bound_by": "bytes",
          "bytes_per_launch": bytes_moved,
          # what the clock costs: per launch when ten scans run between one
          # pair of events; a one-element PyTorch kernel between a pair; and
          # a PyTorch kernel without dependencies that moves the same bytes
          "ms_in_a_row": time_ms(in_a_row, 30) / 10,
          "one_element_add_ms": time_ms(lambda: one.add_(1.0), 100),
          "where_same_bytes_ms": time_ms(
              lambda: torch.where(s, x, zero, out=y), 100)})

    sweep = []
    for mult in (1, 4, 16):
        n = mult * SERVING_B
        xs, ss = bench.random_case(n, 32, seed=mult)
        check(bench.agrees(segscan.seg_excl_sum_kernel(xs, ss),
                           segscan.seg_excl_sum_plain(xs, ss), xs, ss)
              and bench.agrees(segscan.seg_excl_rsum_kernel(xs, ss),
                               segscan.seg_excl_rsum_plain(xs, ss), xs, ss),
              f"kernel disagrees with the plain version at B = {n}")
        t = time_ms(lambda: segscan.seg_excl_sum_kernel(xs, ss), 100)
        ys = torch.empty_like(xs)
        sweep.append({"B": n, "ms": t, "bound_ms": 1e3 * 9 * n / HBM_BYTES_PER_S,
                      "gb_per_s": 9 * n / (1e-3 * t) / 1e9,
                      "where_same_bytes_ms": time_ms(
                          lambda: torch.where(ss, xs, zero, out=ys), 100)})
        del xs, ss, ys
    emit({"sweep": sweep, "bytes_per_element": 9,
          "one_element_scan_ms": time_ms(
              lambda: segscan.seg_excl_sum_kernel(x[:1], s[:1]), 100)})
    rev_worst = max(c["rev"]["err"] for c in errs.values())
    return {"max_abs_err": worst, "reverse_max_abs_err": rev_worst, "ms": ms,
            "reverse_ms": reverse_ms, "plain_ms": plain_ms,
            "reverse_plain_ms": reverse_plain_ms, "bound_ms": bound_ms}


# ---------------------------------------------------------------- phase 3


def phase_main_path(torch, segscan, toy, Renderer, profile_dir):
    cfg, P, occ_cfg = toy.train_occ_config()
    # the frames start from an empty allocator, whatever the kernel phase
    # before them left cached
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = toy.serving_model(cfg, seed=0, device="cuda")
    boxes, _ = toy.quadrant_layout(cfg.num_submodules)
    occ = toy.random_occ_states(boxes, occ_cfg, fill=0.10, seed=0, device="cuda")
    renderer = Renderer(cfg, P, occ_cfg)  # the card by default
    cam = toy.overhead_camera(H, W)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rows = renderer.chunk_rays // W
    chunks = -(-H // rows)
    n_table = sum(int(p.numel()) for p in model.experts["hash_table"])

    torch.cuda.reset_peak_memory_stats()
    segscan.seg_excl_sum_kernel.launches = 0
    segscan.seg_excl_rsum_kernel.launches = 0
    t0 = time.perf_counter()
    renderer.render_image(model, occ, H=H, W=W, download=False, **cam)  # warm
    warm_ms = 1e3 * (time.perf_counter() - t0)
    frame_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        renderer.render_image(model, occ, H=H, W=W, download=False, **cam)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
    # every wait of the host for the card in one frame: the frame's inputs
    # and its end may wait, a chunk may not
    _, syncs, sites = host_syncs(torch, lambda: renderer.render_image(
        model, occ, H=H, W=W, download=False, **cam))
    check(syncs < chunks, f"{syncs} host syncs in a frame of {chunks} chunks "
          f"at {sites}")
    t0 = time.perf_counter()
    rgb, depth, acc = renderer.render_image(model, occ, H=H, W=W, **cam)
    e2e_ms = 1e3 * (time.perf_counter() - t0)
    launches = segscan.seg_excl_sum_kernel.launches
    rev_launches = segscan.seg_excl_rsum_kernel.launches
    frames = 6
    check(launches == chunks * frames,
          f"seg_excl_sum launched {launches} times, want {chunks} chunks × "
          f"{frames} frames")
    check(rev_launches == 0, f"seg_excl_rsum launched {rev_launches} times in "
          f"{frames} frames, want 0: serving takes no gradient")
    check(rgb.shape == (H, W, 3) and np.isfinite(rgb).all()
          and np.isfinite(depth).all() and np.isfinite(acc).all(),
          "the frame is not finite or has the wrong shape")
    emit({"phase": "main_path", "H": H, "W": W, "rays_per_chunk": rows * W,
          "packed_samples_per_chunk": rows * W * int(P.occ_budget_per_ray),
          "chunks_per_frame": chunks, "frames": frames,
          "seg_excl_sum_launches": launches,
          "seg_excl_rsum_launches": rev_launches,
          "host_syncs_per_frame": syncs,
          "host_sync_sites": sites,
          "setup_s": setup_s, "warm_frame_ms": warm_ms, "frame_ms": frame_ms,
          "mean_frame_ms": statistics.mean(frame_ms),
          "frame_ms_with_download": e2e_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "hash_table_mb": 4 * n_table / 1e6,
          "mean_rgb": [float(v) for v in rgb.reshape(-1, 3).mean(0)],
          "mean_acc": float(acc.mean())})

    if profile_dir:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            renderer.render_image(model, occ, H=H, W=W, download=False, **cam)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        # busy time of the card: kernels, copies and fills of this frame
        busy_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in prof.events()
                             if e.device_type == DeviceType.CUDA)
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
        (Path(profile_dir) / "frame_kernels.txt").write_text(table)
        print(table, flush=True)
        # the scan kernel in place, between the ops that make its input and
        # read its output (the table above may cut it off)
        scan = [e for e in prof.key_averages() if "seg_scan_kernel" in e.key]
        scan_us = sum(getattr(e, "device_time_total", 0)
                      or getattr(e, "cuda_time_total", 0) for e in scan)
        scan_n = sum(e.count for e in scan)
        emit({"phase": "profile", "frame_wall_ms": wall_ms,
              "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
              "scan_kernel_launches": scan_n,
              "scan_kernel_mean_us": scan_us / max(scan_n, 1)})
    return model, occ, cam, (launches, rev_launches), frame_ms


# ---------------------------------------------------------------- phase 4


def phase_vs_cpu(torch, toy, Renderer, model, occ, cam, P=None, phase="main_path_vs_cpu"):
    """``render_rays`` on the card against the CPU for the render params
    ``P`` (the config's: the packed-budget path)."""
    from acn_tpu_torch.pipelines.renderer import _pinhole_block_rays

    cfg, P_cfg, occ_cfg = toy.train_occ_config()
    P = P or P_cfg
    args = [torch.from_numpy(np.asarray(a, np.float32)) for a in
            (cam["c2w"], cam["intrinsics"], cam["aabb"])]
    rays = _pinhole_block_rays(H, W, *args, torch.tensor([-np.inf, np.inf]),
                               0.0, 0.0).numpy()
    rays = rays[np.random.default_rng(0).choice(len(rays), 2048, replace=False)]
    model_cpu = toy.serving_model(cfg, seed=0, device="cpu")
    occ_cpu = {k: v.cpu() for k, v in occ.items()}
    out = {}
    # tolerance: f32 MLP products sum in another order in cuBLAS than on the
    # CPU (~1e-6 relative per layer), exp/log differ by an ulp, and
    # index_add_ accumulates with atomics on the card
    atol, rtol = 1e-4, 1e-4
    for name, thre, bias in (("alpha_thre_cfg", occ_cfg.alpha_thre, None),
                             ("alpha_thre_0_bias_2", 0.0, 2.0)):
        if bias is not None:
            with torch.no_grad():
                model.experts["sigma_head"]["b"].fill_(bias)
                model_cpu.experts["sigma_head"]["b"].fill_(bias)
        oc = dataclasses.replace(occ_cfg, alpha_thre=thre)
        gpu = Renderer(cfg, P, oc, chunk_rays=2048).render_rays(
            model, occ, rays, with_stats=True)
        cpu = Renderer(cfg, P, oc, chunk_rays=2048, device="cpu").render_rays(
            model_cpu, occ_cpu, rays, with_stats=True)
        errs = {k: float(np.abs(g - c).max()) for k, g, c in
                zip(("rgb", "depth", "acc", "wmax", "went"), gpu, cpu)}
        ok = all(np.allclose(g, c, atol=atol, rtol=rtol) for g, c in
                 zip(gpu[:4], cpu[:4]))
        out[name] = {"max_abs_err": errs, "max_acc": float(cpu[2].max()),
                     "mean_acc": float(cpu[2].mean())}
        check(ok, f"card vs CPU render_rays disagree at {name}: {errs}")
    check(out["alpha_thre_0_bias_2"]["max_acc"] > 0.5,
          "the opaque case composited nothing opaque")
    emit({"phase": phase, "rays": 2048, "atol": atol, "rtol": rtol, **out})
    return occ_cpu


# ---------------------------------------------------------------- phase 5


def host_syncs(torch, fn):
    """Run ``fn`` with PyTorch's sync debug mode on; (its result, the count
    of host waits for the card, their sites)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(f"{Path(w.filename).name}:{w.lineno}"
                                for w in caught if "synchroniz" in str(w.message))
    return out, sum(sites.values()), dict(sites)


def scan_on_training_segments(torch, segscan, bench, samples) -> dict:
    """Both kernels against their plain versions, and timed, on the segment
    boundaries of one real training march (its packed ray ids), with the
    log-transmittance of random opacities as values."""
    rid, real = samples["ray_id"], samples["slot_real"]
    B = int(rid.numel())
    starts = torch.cat([torch.ones(1, dtype=torch.bool, device=rid.device),
                        rid[1:] != rid[:-1]])
    gen = torch.Generator(device="cuda").manual_seed(B)
    alpha = torch.where(real, torch.rand(B, generator=gen, device="cuda") ** 3, 0.0)
    x = torch.log(1.0 - 0.999 * alpha + 1e-10)
    g = torch.randn(B, generator=gen, device="cuda")
    fwd, rev = compare(segscan.seg_excl_sum_kernel(x, starts),
                       segscan.seg_excl_sum_plain(x, starts), x, starts), \
        compare(segscan.seg_excl_rsum_kernel(g, starts),
                segscan.seg_excl_rsum_plain(g, starts), g, starts)
    check(fwd["ok"] and rev["ok"], f"kernel disagrees with the plain version "
          f"on a training march of B = {B}: {fwd} {rev}")
    return {"B": B, "segments": int(starts.sum()), "real": int(real.sum()),
            "max_abs_err": fwd["err"], "reverse_max_abs_err": rev["err"],
            "ms": bench.time_ms(lambda: segscan.seg_excl_sum_kernel(x, starts), 100),
            "reverse_ms": bench.time_ms(
                lambda: segscan.seg_excl_rsum_kernel(g, starts), 100),
            "plain_ms": bench.time_ms(
                lambda: segscan.seg_excl_sum_plain(x, starts), 20),
            "reverse_plain_ms": bench.time_ms(
                lambda: segscan.seg_excl_rsum_plain(g, starts), 20),
            "bound_ms": 1e3 * 9 * B / HBM_BYTES_PER_S}


def episode_loss_grads(torch, ts, nn, cfg, P, occ_cfg, model_cpu, occ_cpu, rays,
                       rgbs, dev, rand):
    """Expert 0's episode loss on ``rays`` and its gradient (float32 leaves,
    as float64 on the CPU), with the σ-head bias at +2 so that the
    transmittance carries weight, on ``dev``; ``rand`` is the march's
    draws."""
    loss_fn, prep = ts.make_episode_loss(cfg, P, occ_cfg)
    params = model_cpu.params()
    expert = nn.tree_map(
        lambda a: a[0].detach().clone().to(dev).requires_grad_(True),
        params["experts"])
    with torch.no_grad():
        expert["sigma_head"]["b"].fill_(2.0)
    bg = nn.tree_map(lambda a: a.detach().to(dev), params["bg_mlp"])
    r = torch.from_numpy(rays).to(dev)
    if isinstance(rand, tuple):
        rand = tuple(x.to(dev) for x in rand)
    smp = prep({k: v[0].to(dev) for k, v in occ_cpu.items()}, r, rand)
    loss = loss_fn(expert, bg, model_cpu.expert_aabbs[0].to(dev), r,
                   torch.from_numpy(rgbs).to(dev), smp)
    grads = torch.autograd.grad(loss, nn.tree_leaves(expert))
    check(all(g.dtype == torch.float32 for g in grads),
          f"{dev}: a gradient of a float32 leaf is not float32")
    return float(loss.detach()), [g.double().cpu() for g in grads]


def check_card_vs_cpu_f32(torch, got, want, n_tables, what) -> dict:
    """A float32 episode's loss and gradient on the card against the CPU:
    loss rtol 1e-5, gradients atol 1e-6 with rtol 1e-3 on the tables and
    1e-4 on the MLPs (cuBLAS sums f32 products in another order than the
    CPU; the table gradient is a scatter-add with atomics, whose order is
    free)."""
    (lg, gg), (lc, gc) = got, want
    check(abs(lg - lc) <= 1e-5 * abs(lc), f"{what} loss: card {lg}, CPU {lc}")
    err = {"table": 0.0, "mlp": 0.0}
    for i, (a, b) in enumerate(zip(gg, gc)):
        kind = "table" if i < n_tables else "mlp"
        rtol = 1e-3 if kind == "table" else 1e-4
        err[kind] = max(err[kind], float((a - b).abs().max()))
        check(torch.allclose(a, b, atol=1e-6, rtol=rtol),
              f"{what} gradient leaf {i} ({kind}): card vs CPU max |diff| "
              f"{float((a - b).abs().max())}")
    check(any(float(g.abs().max()) > 0 for g in gc[:n_tables]),
          f"{what}: the table gradient is all zero")
    return {"loss_card": lg, "loss_cpu": lc, "max_abs_err_table_grad": err["table"],
            "max_abs_err_mlp_grad": err["mlp"]}


def episode_card_vs_cpu(torch, toy, ts, nn, model_cpu, occ_cpu, batch_np) -> dict:
    """One episode's loss and gradient, 256 rays, one salt, the σ-head bias at
    +2 so that the transmittance (and with it the reverse scan) carries weight:
    float32 on the card (scan kernels) against float32 on the CPU (plain
    scans); the bf16 episode (``use_amp``, the path the step runs) on the card
    against the same on the CPU, and against the float32 one on the card."""
    cfg, P, occ_cfg = toy.train_occ_config()
    rays, rgbs = batch_np["support_rays"][0, 0, :256], batch_np["support_rgbs"][0, 0, :256]
    n_tables = len(model_cpu.params()["experts"]["hash_table"])
    out = {}
    for label, dev, amp in (("card", "cuda", False), ("cpu", "cpu", False),
                            ("card_bf16", "cuda", True), ("cpu_bf16", "cpu", True)):
        P_run = types.SimpleNamespace(**{**vars(P), "use_amp": amp})
        out[label] = episode_loss_grads(torch, ts, nn, cfg, P_run, occ_cfg, model_cpu,
                                        occ_cpu, rays, rgbs, dev, 12345)
    lg, gg = out["card"]
    (lb, gb), (lbc, gbc) = out["card_bf16"], out["cpu_bf16"]
    f32 = check_card_vs_cpu_f32(torch, out["card"], out["cpu"], n_tables, "episode")

    def against(ga, gb_, sl):
        """Two gradients' leaves ``sl`` as one vector each: (ratio of their
        lengths, cosine of their angle)."""
        a = torch.cat([g.reshape(-1) for g in ga[sl]])
        b = torch.cat([g.reshape(-1) for g in gb_[sl]])
        return (float(a.norm() / b.norm()),
                float((a * b).sum() / (a.norm() * b.norm())))

    groups = (("table", slice(0, n_tables)), ("mlp", slice(n_tables, None)))
    # The bf16 episode (the path the step runs) on the card against the same
    # episode on the CPU: one arithmetic, so the same cells; the matmuls
    # round to bf16 from sums taken in another order, and the table
    # gradient's bf16 scatter-add depends on its order (atomics on the card).
    # So no entry is compared: the loss, and each group's gradient as one
    # vector, in length and in direction.
    check(all(bool(torch.isfinite(g).all()) for g in gb),
          "the bf16 episode's gradient on the card is not finite")
    same = {"loss_card": lb, "loss_cpu": lbc, "loss_rel_err": abs(lb - lbc) / abs(lbc)}
    for kind, sl in groups:
        ratio, cos = against(gb, gbc, sl)
        same[kind] = {"norm_ratio": ratio, "cos": cos}
    same["table_cos_by_level"] = [against(gb, gbc, slice(i, i + 1))[1]
                                  for i in range(n_tables)]
    check(same["loss_rel_err"] <= BF16_LOSS_RTOL and all(
        1.0 / BF16_NORM_FACTOR <= same[k]["norm_ratio"] <= BF16_NORM_FACTOR
        and same[k]["cos"] >= BF16_MIN_COS for k, _ in groups),
        f"bf16 episode, card against CPU: {same}")
    # bf16 against float32, both on the card: the loss and the MLP gradient
    # are held. The table gradient is reported level by level and not held,
    # because the two land on different entries, as in the reference: the
    # grids span the scene and an expert's box is a quadrant of it, so most
    # samples are clamped to x01 = 1 − ε, which bf16 rounds to 1.0 (cell
    # `res`, fraction 0, where float32 has cell `res − 1`, fraction ≈ 1); and
    # x·resolution in bf16 keeps 8 bits, so from a resolution of about a
    # hundred on the bf16 cell is another cell than the float32 one.
    vs32 = {"loss_rel_err": abs(lb - lg) / abs(lg)}
    ratio, cos = against(gb, gg, groups[1][1])
    vs32["mlp"] = {"norm_ratio": ratio, "cos": cos}
    vs32["table_norm_ratio"] = against(gb, gg, groups[0][1])[0]
    vs32["table_cos_by_level"] = [against(gb, gg, slice(i, i + 1))[1]
                                  for i in range(n_tables)]
    check(vs32["loss_rel_err"] <= BF16_LOSS_RTOL
          and 1.0 / BF16_NORM_FACTOR <= ratio <= BF16_NORM_FACTOR
          and cos >= BF16_MIN_COS,
          f"bf16 episode against float32, both on the card: {vs32}")
    return {"rays": 256, **f32, "bf16_card_vs_cpu": same, "bf16_vs_f32_on_card": vs32}


def profile_window(torch, fn, profile_dir, name):
    """``fn`` once under ``torch.profiler``, between two synchronizations:
    (the profile, wall ms, the card's busy ms, kernel launches). Writes the
    ops by device time and by host time to DIR/<name>_kernels.txt and
    DIR/<name>_host.txt and prints the first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
    avgs = prof.key_averages()
    table = avgs.table(sort_by="cuda_time_total", row_limit=45)
    (Path(profile_dir) / f"{name}_kernels.txt").write_text(table)
    print(table, flush=True)
    # a step waits on the host: the same events by the host's own time
    (Path(profile_dir) / f"{name}_host.txt").write_text(
        avgs.table(sort_by="self_cpu_time_total", row_limit=30))
    launches = sum(e.count for e in avgs if e.key == "cudaLaunchKernel")
    return prof, wall_ms, busy_ms, launches


def phase_train_step(torch, segscan, bench, toy, model_cpu, occ_cpu, profile_dir):
    from acn_tpu_torch.models import nn
    from acn_tpu_torch.pipelines.offline_stage import train_step as ts

    cfg, P, occ_cfg = toy.train_occ_config()
    K, T = cfg.num_submodules, int(P.batch_size)
    S, Q = int(P.support_rays), int(P.query_rays)
    per_step = K * T * (int(P.inner_iter) + 1)
    torch.cuda.empty_cache()
    model = toy.serving_model(cfg, seed=0, device="cuda")
    occ = {k: v.cuda() for k, v in occ_cpu.items()}
    batch_np = toy.training_batch(K, T, S, Q, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    opt, state = toy.init_train_state(model, P)
    step = ts.make_meta_train_step(cfg, P, opt, occ_cfg)  # the card by default
    gen = torch.Generator(device="cuda").manual_seed(0)
    start = nn.tree_map(lambda p: p.detach().clone(), model.params())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    step_ms, launches, metrics, syncs, sites = [], [], None, 0, {}
    for i in range(4):  # one warm step, three timed
        segscan.seg_excl_sum_kernel.launches = 0
        segscan.seg_excl_rsum_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 3:  # the last timed step also counts the host's waits
            (state, metrics), syncs, sites = host_syncs(
                torch, lambda: step(state, batch, occ, gen))
        else:
            state, metrics = step(state, batch, occ, gen)
        torch.cuda.synchronize()
        if i:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        launches.append((segscan.seg_excl_sum_kernel.launches,
                         segscan.seg_excl_rsum_kernel.launches))
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    check(all(l == (per_step, per_step) for l in launches),
          f"scan kernel launches per step (forward, reverse) {launches}, want "
          f"{per_step} of each")
    check(syncs < per_step, f"{syncs} host syncs in a step of {per_step} "
          f"episode losses at {sites}")
    m = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
    check(set(m) == {"loss_out", "loss_in", "psnr_out", "psnr_in", "loss_total",
                     "grad_norm", "occ_overflow"}
          and all(np.isfinite(v).all() for v in m.values()),
          f"a metric is missing or not finite: {m}")
    check(0.0 <= float(m["occ_overflow"]) <= 1.0 and float(m["grad_norm"]) > 0.0,
          f"occ_overflow {m['occ_overflow']}, grad_norm {m['grad_norm']}")
    check(int(state["opt_state"]["count"]) == 4 and state["step"] == 4
          and int(state["opt_state"]["total_notfinite"]) == 0,
          f"optimizer count {int(state['opt_state']['count'])}, step "
          f"{state['step']}, want 4; skipped updates "
          f"{int(state['opt_state']['total_notfinite'])}, want 0")
    moved = {}

    def note(a, b, label):
        changed = bool((a != b).any()) and bool(torch.isfinite(b).all())
        moved[label] = moved.get(label, True) and changed

    nn.tree_map(note, start, model.params(), opt.labels)
    check(set(moved) == {"encoding", "sigma", "color", "background"}
          and all(moved.values()), f"parameter groups that moved: {moved}")
    del start

    # the kernels on the segments of a real support and a real query march
    prep = ts.make_episode_loss(cfg, P, occ_cfg)[1]
    occ0 = {k: v[0] for k, v in occ.items()}
    shapes = [scan_on_training_segments(
        torch, segscan, bench, prep(occ0, batch[name][0, 0], 12345))
        for name in ("support_rays", "query_rays")]
    check([s["B"] for s in shapes] == [S * int(P.occ_budget_per_ray),
                                       Q * int(P.occ_budget_per_ray)],
          f"packed samples per episode {[s['B'] for s in shapes]}")
    vs_cpu = episode_card_vs_cpu(torch, toy, ts, nn, model_cpu, occ_cpu, batch_np)

    rays_per_step = K * T * (int(P.inner_iter) * S + Q)  # ray renders per step
    emit({"phase": "train_step", "K": K, "T": T, "support_rays": S,
          "query_rays": Q, "inner_iter": int(P.inner_iter), "use_amp": bool(P.use_amp),
          "step_ms": step_ms, "mean_step_ms": statistics.mean(step_ms),
          "rays_per_s": rays_per_step / (1e-3 * statistics.mean(step_ms)),
          "fwd_launches_per_step": launches[-1][0],
          "rev_launches_per_step": launches[-1][1],
          "syncs_per_step": syncs, "sync_sites": sites, "peak_mem_mb": peak_mb,
          "metrics": {k: v.tolist() for k, v in m.items()},
          "scan_on_training_segments": shapes,
          "one_element_add_ms": bench.time_ms(
              lambda: torch.zeros(1, device="cuda").add_(1.0), 100),
          "episode_card_vs_cpu": vs_cpu})

    if profile_dir:
        prof, wall_ms, busy_ms, n_launch = profile_window(
            torch, lambda: step(state, batch, occ, gen), profile_dir, "train_step")
        scan = {}
        for e in prof.key_averages():
            if "seg_scan_kernel" in e.key:
                us = (getattr(e, "device_time_total", 0)
                      or getattr(e, "cuda_time_total", 0))
                scan[e.key[:120]] = {"launches": e.count,
                                     "mean_us": us / max(e.count, 1)}
        emit({"phase": "train_step_profile", "step_wall_ms": wall_ms,
              "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
              "kernel_launches": n_launch, "scan_kernels": scan,
              "scan_share_of_busy": 1e-3 * sum(
                  v["launches"] * v["mean_us"] for v in scan.values()) / busy_ms})
    return {"launches": (sum(l[0] for l in launches), sum(l[1] for l in launches)),
            "steps": len(launches), "shapes": shapes, "syncs": syncs}


# ---------------------------------------------------------------- phase 6


# the 32³ update check scales expert 0's hash features by this: from the
# random init (U(±1e-4)) σ is all but constant over the grid, and about a
# fifth of the cells would sit in the threshold band where a cell may flip.
# Not by more: the σ MLP's sums grow with the features, and cuBLAS sums them
# in another order than the CPU (on an H100 at ×5,000 occs differ by 1.3e-6)
UPDATE_TABLE_SCALE = 1000.0
UPDATE_BAND = 1e-5  # relative distance from the threshold


def _scan_counts(segscan):
    return (segscan.seg_excl_sum_kernel.launches, segscan.seg_excl_rsum_kernel.launches)


def _zero_scan_counts(segscan) -> None:
    segscan.seg_excl_sum_kernel.launches = 0
    segscan.seg_excl_rsum_kernel.launches = 0


def update_card_vs_cpu(torch, occ_grid, nn, cfg, occ_cfg, model) -> dict:
    """Expert 0's occupancy update at 32³, its hash features scaled by
    ``UPDATE_TABLE_SCALE``, on the card and on the CPU with one injected
    jitter: occs within rtol 1e-6, binaries equal for every cell farther than
    ``UPDATE_BAND`` (relative) from the threshold, that band under 1 % of the
    cells, and the cut between 5 % and 95 % occupied."""
    occ32 = dataclasses.replace(occ_cfg, resolution=32)
    aabb_cpu = model.expert_aabbs[0].detach().cpu()
    state = occ_grid.init_occ_state(aabb_cpu, occ32)
    jitter = torch.rand((occ32.levels, 32 ** 3, 3),
                        generator=torch.Generator().manual_seed(3)) - 0.5
    params = nn.tree_map(lambda a: a.detach(), model.expert(0))
    params["hash_table"] = [t * UPDATE_TABLE_SCALE for t in params["hash_table"]]

    def update(params, aabb, on):
        return occ_grid.update_occ_grid(
            {k: v.to(on) for k, v in state.items()},
            lambda x: cfg.expert_density(params, cfg.expert, aabb, x)[..., 0],
            occ32, occ32.step_size_for_traced(aabb), jitter=jitter.to(on))

    got = update(params, model.expert_aabbs[0], "cuda")
    want = update(nn.tree_map(lambda a: a.cpu(), params), aabb_cpu, "cpu")
    occ_g, occ_w = got["occs"].cpu().double(), want["occs"].double()
    rel = float(((occ_g - occ_w).abs() / occ_w.abs().clamp(min=1e-30)).max())
    thre = max(min(occ32.occ_thre, float(occ_w.mean())), 1e-6)
    band = (occ_w - thre).abs() <= UPDATE_BAND * thre
    differ = got["binaries"].cpu() != want["binaries"]
    out = {"cells": 32 ** 3, "hash_table_scale": UPDATE_TABLE_SCALE,
           "max_rel_err_occs": rel, "cells_in_band": int(band.sum()),
           "binaries_differ_in_band": int((differ & band).sum()),
           "binaries_differ_outside_band": int((differ & ~band).sum()),
           "occupied_share": float(want["binaries"].float().mean())}
    check(rel <= 1e-6 and out["binaries_differ_outside_band"] == 0
          and out["cells_in_band"] < 0.01 * out["cells"]
          and 0.05 < out["occupied_share"] < 0.95,
          f"occupancy update, card against CPU: {out}")
    return out


def check_update_pass(torch, occ_cfg, before, after) -> list:
    """What one full-width pass must satisfy whatever the densities: the EMA
    never falls below occs · decay, and binaries is occs above the threshold
    recomputed from occs (a mean over the visible cells, floored at 1e-6).
    Returns the occupied share per expert."""
    occs = after["occs"]
    check(bool(torch.isfinite(occs).all()), "the occupancy update is not finite")
    check(bool((occs >= before["occs"] * occ_cfg.ema_decay).all()),
          "an updated cell fell below its decayed value")
    for k in range(occs.shape[0]):  # the update's own reduction, expert by expert
        flat = occs[k].reshape(occs.shape[1], -1)
        visible = flat >= 0.0
        mean = torch.sum(torch.where(visible, flat, 0.0)) / torch.clamp(
            torch.sum(visible), min=1)
        thre = torch.clamp(torch.clamp(mean, max=occ_cfg.occ_thre), min=1e-6)
        check(torch.equal(after["binaries"][k].reshape(flat.shape), flat > thre),
              f"expert {k}: binaries is not occs above the threshold")
    share = after["binaries"].float().mean(dim=(1, 2, 3, 4)).tolist()
    check(all(0.0 < x < 1.0 for x in share), f"occupied share per expert {share}")
    return share


def phase_regimes(torch, segscan, toy, Renderer, model_cpu, occ_cpu, profile_dir) -> dict:
    """The regime schedule of a run (module docstring, phase 6). Returns the
    scan's launch counts summed over the phase's steps and its frames."""
    from acn_tpu_torch.models import nn
    from acn_tpu_torch.occupancy import grid as occ_grid
    from acn_tpu_torch.pipelines.offline_stage import train_step as ts
    from acn_tpu_torch.pipelines.offline_stage import trainer as tr

    cfg, P, occ_cfg = toy.train_occ_config()
    K, T = cfg.num_submodules, int(P.batch_size)
    S, Q, I = int(P.support_rays), int(P.query_rays), int(P.inner_iter)
    rays_per_step = K * T * (I * S + Q)
    per_step = K * T * (I + 1)
    torch.cuda.empty_cache()
    model = toy.serving_model(cfg, seed=1, device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in toy.training_batch(K, T, S, Q, seed=1).items()}
    opt, state = toy.init_train_state(model, P)
    gen = torch.Generator(device="cuda").manual_seed(0)
    boxes, _ = toy.quadrant_layout(K)
    occ10 = toy.random_occ_states(boxes, occ_cfg, fill=0.10, seed=0, device="cuda")
    counted = {"fwd": 0, "rev": 0}

    def steps(step, occ, n):
        """``n`` steps of ``step`` from the running state: (ms per step,
        scan launches per step, the last metrics as numpy)."""
        nonlocal state
        ms, launches, metrics = [], [], None
        for _ in range(n):
            _zero_scan_counts(segscan)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, occ, gen)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            launches.append(_scan_counts(segscan))
            counted["fwd"] += launches[-1][0]
            counted["rev"] += launches[-1][1]
        m = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
        check(all(np.isfinite(v).all() for v in m.values()), f"a metric is not finite: {m}")
        return ms, launches, m

    def summary(ms, launches, m, peak):
        return {"step_ms": ms, "rays_per_s": [rays_per_step / (1e-3 * t) for t in ms],
                "scan_launches_per_step": launches, "peak_mem_mb": peak,
                "loss_total": float(m["loss_total"]), "occ_overflow": float(m["occ_overflow"])}

    # (a) the warm-up: stratified, no occupancy
    torch.cuda.reset_peak_memory_stats()
    step_strat = ts.make_meta_train_step(cfg, P, opt, None)
    ms, launches, m = steps(step_strat, tr.dummy_occ_states(K, "cuda"), 2)
    check(all(l == (0, 0) for l in launches),
          f"the stratified step launched scan kernels {launches}, want none")
    strat = summary(ms, launches, m, torch.cuda.max_memory_allocated() / 1e6)
    emit({"phase": "regimes_stratified", "ray_samples": int(P.ray_samples), **strat})

    # (b) the occupancy update from the model after (a), twice (the second
    # is the EMA over the first)
    update = tr.make_occ_update_fn(cfg, occ_cfg)
    occ_upd = tr.init_occ_states(model.expert_aabbs, occ_cfg)
    torch.cuda.reset_peak_memory_stats()
    update_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before, occ_upd = occ_upd, update(model, occ_upd, generator=gen)
        torch.cuda.synchronize()
        update_ms.append(1e3 * (time.perf_counter() - t0))
        share = check_update_pass(torch, occ_cfg, before, occ_upd)
    del before
    upd = {"update_ms": update_ms, "cells_per_expert": int(occ_upd["occs"][0].numel()),
           "density_queries": int(occ_upd["occs"].numel()),
           "occupied_share_per_expert": share,
           "peak_mem_mb": torch.cuda.max_memory_allocated() / 1e6,
           "expert0_32cubed_card_vs_cpu": update_card_vs_cpu(
               torch, occ_grid, nn, cfg, occ_cfg, model)}
    emit({"phase": "regimes_occ_update", **upd})

    # (c) strided with the would-be overflow measured on bench.py's 10 %
    # grids and read by the auto switch: report budget 32 (the config's),
    # then 2 (which overflows, and so restarts the switch's count), then 32
    # three times, after which the switch must fire; a strided step on the
    # updated grids; the budget step after the switch
    budget = int(P.occ_budget_per_ray)
    ctl = tr.AutoRegime(float(P.occ_auto_thresh), int(P.occ_auto_patience))
    torch.cuda.reset_peak_memory_stats()
    step_auto = {b: ts.make_meta_train_step(cfg, P, opt, occ_cfg, budget_override=0,
                                            report_budget=b)
                 for b in (budget, 2)}
    schedule = [budget, 2, budget, budget, budget]
    readings, fired = [], []
    auto_ms, auto_launches = [], []
    for b in schedule:
        ms, launches, m = steps(step_auto[b], occ10, 1)
        auto_ms += ms
        auto_launches += launches
        readings.append(float(m["occ_overflow"]))
        fired.append(ctl.observe(readings[-1]))
    auto = summary(auto_ms, auto_launches, m, torch.cuda.max_memory_allocated() / 1e6)
    check(all(l == (0, 0) for l in auto_launches),
          f"the strided step launched scan kernels {auto_launches}, want none")
    check([r > ctl.thresh for r in readings] == [b != budget for b in schedule],
          f"would-be overflow readings {readings} at report budgets {schedule}: want "
          f"above {ctl.thresh} at budget 2 only")
    check(fired == [False, False, False, False, True] and ctl.switched,
          f"AutoRegime fired {fired} on readings {readings}")
    ms, launches, m = steps(ts.make_meta_train_step(cfg, P, opt, occ_cfg, budget_override=0),
                            occ_upd, 1)
    check(launches == [(0, 0)], f"the strided step launched scan kernels {launches}")
    on_updated = summary(ms, launches, m, None)
    ms, launches, m = steps(ts.make_meta_train_step(cfg, P, opt, occ_cfg), occ10, 1)
    check(launches == [(per_step, per_step)],
          f"the budget step after the switch launched {launches}, want "
          f"{per_step} forward and {per_step} reverse")
    after_switch = summary(ms, launches, m, None)
    check(state["step"] == 2 + len(schedule) + 2, f"the schedule took {state['step']} steps")
    # one float32 strided episode on the card against the CPU
    P32 = types.SimpleNamespace(**{**vars(P), "use_amp": False, "occ_budget_per_ray": 0})
    bnp = toy.training_batch(K, T, S, Q, seed=0)
    rays, rgbs = bnp["support_rays"][0, 0, :256], bnp["support_rgbs"][0, 0, :256]
    rand = occ_grid.draw_march(rays.shape[0], int(P.occ_s_max),
                               torch.Generator().manual_seed(7))
    n_tables = len(model_cpu.params()["experts"]["hash_table"])
    episode = check_card_vs_cpu_f32(
        torch, *(episode_loss_grads(torch, ts, nn, cfg, P32, occ_cfg, model_cpu, occ_cpu,
                                    rays, rgbs, on, rand) for on in ("cuda", "cpu")),
        n_tables, "strided episode")
    emit({"phase": "regimes_strided", "s_max": int(P.occ_s_max), "s_kept": int(P.occ_s_kept),
          "report_budgets": schedule, "auto": auto, "would_overflow_readings": readings,
          "auto_regime_fired": fired, "strided_on_updated_grids": on_updated,
          "budget_step_after_switch": after_switch,
          "strided_episode_card_vs_cpu": {"rays": int(rays.shape[0]), **episode}})

    if profile_dir:
        step_plain = ts.make_meta_train_step(cfg, P, opt, occ_cfg, budget_override=0)
        for name, step, occ in (("stratified_step", step_strat,
                                 tr.dummy_occ_states(K, "cuda")),
                                ("strided_step", step_plain, occ10)):
            prof, wall_ms, busy_ms, n_launch = profile_window(
                torch, lambda: step(state, batch, occ, gen), profile_dir, name)
            top = sorted(prof.key_averages(), key=lambda e: -(
                getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)))[:10]
            emit({"phase": f"{name}_profile", "step_wall_ms": wall_ms,
                  "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
                  "kernel_launches": n_launch,
                  "top_ops_device_ms": {e.key[:60]: 1e-3 * (
                      getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0))
                      for e in top}})
    del state, opt, model, step_auto, step_strat

    # (d) the budget-0 renderer: the strided march, render_rays_occ; a warm
    # frame (downloaded and checked), then a timed frame left on the device,
    # as in phase 3
    P0 = types.SimpleNamespace(**{**vars(P), "occ_budget_per_ray": 0})
    model = toy.serving_model(cfg, seed=0, device="cuda")
    occ = toy.random_occ_states(boxes, occ_cfg, fill=0.10, seed=0, device="cuda")
    cam = toy.overhead_camera(H, W)
    _zero_scan_counts(segscan)
    phase_vs_cpu(torch, toy, Renderer, model, occ, cam, P=P0,
                 phase="budget0_render_rays_vs_cpu")
    renderer = Renderer(cfg, P0, occ_cfg)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb, depth, acc = renderer.render_image(model, occ, H=H, W=W, **cam)
    warm_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    renderer.render_image(model, occ, H=H, W=W, download=False, **cam)
    frame_ms = 1e3 * (time.perf_counter() - t0)
    check(_scan_counts(segscan) == (0, 0),
          f"the budget-0 renderer launched scan kernels {_scan_counts(segscan)}")
    check(rgb.shape == (H, W, 3) and np.isfinite(rgb).all() and np.isfinite(depth).all()
          and np.isfinite(acc).all(), "the budget-0 frame is not finite or misshapen")
    rows = renderer.chunk_rays // W
    emit({"phase": "budget0_frame", "H": H, "W": W, "rays_per_chunk": rows * W,
          "kept_samples_per_ray": renderer.s_kept, "chunks": -(-H // rows),
          "warm_frame_ms_with_download": warm_ms, "frame_ms": frame_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "mean_acc": float(acc.mean()), "sigma_head_bias": 2.0})
    return counted


# ---------------------------------------------------------------- phase 7


# the phase-7 model's density, made to vary over the grid as a trained
# field's does: hash features ×3·10⁴ (from U(±1e-4)), the σ head's weights
# ×4 and its bias −4. At the init's scale σ is all but constant, half the
# cells sit above the grid's mean and every ray keeps ≈ 120 of 256 bins, so
# the would-be overflow at 32 per ray never clears 2 % and the switch never
# fires; with these (measured on the CPU at 64³ and a smaller table) about
# 7 % of the cells stay occupied, ≈ 17 bins per ray
LOOP_HASH_SCALE = 3e4
LOOP_SIGMA_GAIN = 4.0
LOOP_SIGMA_SHIFT = -4.0
LOOP_DIR = Path(__file__).resolve().parent / "logs" / "chip_smoke_loop"
LOOP_CAMERAS, LOOP_IMAGE = 32, (192, 256)  # per expert; (H, W)
DEV = "cuda"


class _LoopProbe:
    """The loop's draws (``trainer.LoopDraws``, one generator on the card)
    with a mark at each point where the loop asks for them (a step, an
    update, an eval) and at the end: the time (after a synchronization when
    ``sync``), the scan counters and the host waits recorded so far."""

    def __init__(self, torch, tr, segscan, seed, sync, caught=None):
        self.torch, self.segscan, self.sync = torch, segscan, sync
        self.draws = tr.LoopDraws(seed, DEV)
        self.caught = caught if caught is not None else []
        self.marks = []

    def mark(self, what):
        if self.sync:
            self.torch.cuda.synchronize()
        self.marks.append((what, time.perf_counter(), _scan_counts(self.segscan),
                           sum("synchroniz" in str(w.message) for w in self.caught)))

    def step(self):
        self.mark("step")
        return self.draws.step()

    def occ_update(self):
        self.mark("occ_update")
        return self.draws.occ_update()

    def occ_refresh(self):
        self.mark("occ_refresh")
        return self.draws.occ_refresh()

    def eval(self, n):
        self.mark("eval")
        return self.draws.eval(n)

    def per_step(self):
        """Per step: (ms from its mark to the next mark, scan launches and
        host waits from its mark to the next step's)."""
        steps = [i for i, m in enumerate(self.marks) if m[0] == "step"]
        bounds = steps[1:] + [len(self.marks) - 1]
        out = []
        for i, j in zip(steps, bounds):
            (_, t0, c0, s0), (_, t1, _, _) = self.marks[i], self.marks[i + 1]
            _, _, c1, s1 = self.marks[j]
            out.append({"ms": 1e3 * (t1 - t0), "launches": (c1[0] - c0[0], c1[1] - c0[1]),
                        "syncs": s1 - s0})
        return out

    def spans(self, what):
        """ms from each ``what`` mark to the next mark."""
        return [1e3 * (self.marks[i + 1][1] - m[1]) for i, m in enumerate(self.marks[:-1])
                if m[0] == what]


def loop_model(torch, toy, cfg, seed):
    model = toy.serving_model(cfg, seed=seed, device=DEV)
    experts = model.params()["experts"]
    with torch.no_grad():
        for t in experts["hash_table"]:
            t.mul_(LOOP_HASH_SCALE)
        experts["sigma_head"]["w"].mul_(LOOP_SIGMA_GAIN)
        experts["sigma_head"]["b"].add_(LOOP_SIGMA_SHIFT)
    return model


def check_sampler(torch, ts, pools, T, S, Q) -> dict:
    """The card's episode ids against the CPU's with the same draws (drawn
    on the CPU, then moved), and on generator draws: every ray real (far >
    near), support and query disjoint in every task; the sampler's time."""
    cpu_pools = {k: v.cpu() for k, v in pools.items()}
    draws = ts.draw_episodes(cpu_pools, T, torch.Generator().manual_seed(5))
    want = ts.episode_ray_ids(cpu_pools, draws, S, Q)
    got = ts.episode_ray_ids(pools, {k: v.to(DEV) for k, v in draws.items()}, S, Q)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "the card's episode ids differ from the CPU's on the same draws")
    del cpu_pools
    sample = ts.make_device_batch_fn(T, S, Q)
    gen = torch.Generator(device=DEV).manual_seed(6)
    for _ in range(4):
        s_ids, q_ids = ts.episode_ray_ids(pools, ts.draw_episodes(pools, T, gen), S, Q)
        K = s_ids.shape[0]
        rays = pools["rays"][torch.arange(K, device=DEV)[:, None, None],
                             torch.cat([s_ids, q_ids], -1)]
        check(bool((rays[..., 7] > rays[..., 6]).all()), "a sampled ray is padding")
        inter = (s_ids[..., :, None] == q_ids[..., None, :]).any(-1).any(-1)
        check(not bool(inter.any()), "a task's support and query rays overlap")
    from acn_tpu_torch.scripts import bench_segscan
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEV == "cuda" else [])
    with profile(activities=activities) as prof:
        sample(pools, gen)
        torch.cuda.synchronize()
    # sample_ms: elapsed between events on the stream (a spin kernel queued
    # first); sample_busy_ms: the kernels' own device time in the profile
    return {"ids_card_vs_cpu": "equal",
            "sample_ms": bench_segscan.time_ms(lambda: sample(pools, gen), 20),
            "sample_busy_ms": 1e-3 * sum(e.time_range.elapsed_us() for e in prof.events()
                                         if e.device_type == DeviceType.CUDA),
            "sample_launches": sum(e.count for e in prof.key_averages()
                                   if e.key == "cudaLaunchKernel")}


def reload_exact(tck, run, tag, cfg, opt) -> None:
    """Load ``tag`` into the port and write it again: every file's bytes
    come back the same."""
    import tempfile

    payload = tck.load_checkpoint(run, tag)
    model, occ = tck.restore_model(payload, cfg, "cpu")
    optim = None
    if (run / f"{tag}.optim").exists():
        optim = tck.load_opt_state(run, tag, opt.init(model.params()), opt)
    with tempfile.TemporaryDirectory(dir=LOOP_DIR) as d:
        tck.save_checkpoint(d, tag, model, opt_state=optim, occ_states=occ,
                            step=payload["step"], best=payload["best"], optimizer=opt)
        for suffix in (".model", ".optim"):
            if (run / f"{tag}{suffix}").exists():
                check((Path(d) / f"{tag}{suffix}").read_bytes()
                      == (run / f"{tag}{suffix}").read_bytes(),
                      f"{tag}{suffix} does not reload bit for bit")


def phase_training_run(torch, segscan, toy, step_syncs) -> dict:
    """The training loop at full width (module docstring, phase 7). Returns
    the scan's launch counts over both runs."""
    import shutil

    from acn_tpu_torch.data import tasks
    from acn_tpu_torch.data.ram_rays import RamRaysDataset
    from acn_tpu_torch.models import nn
    from acn_tpu_torch.pipelines.offline_stage import train_step as ts
    from acn_tpu_torch.pipelines.offline_stage import trainer as tr
    from acn_tpu_torch.runner import premark_occ_states
    from acn_tpu_torch.utils import checkpoint as tck
    from acn_tpu_torch.utils.config import load_checkpoint_cfg
    from acn_tpu_torch.utils.logging import Logger

    cfg, P, occ_cfg = toy.train_occ_config()
    occ_cfg = dataclasses.replace(occ_cfg, warmup_steps=3, update_interval=2)
    P.occ_warmup, P.occ_auto_patience, P.print_step = 3, 2, 1
    P.eval_step, P.max_test_tasks, P.save_step, P.outer_steps = 4, 1, 6, 12
    K, T = cfg.num_submodules, int(P.batch_size)
    S, Q, I = int(P.support_rays), int(P.query_rays), int(P.inner_iter)
    per_step = K * T * (I + 1)
    rays_per_step = K * T * (I * S + Q)
    torch.cuda.empty_cache()
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    LOOP_DIR.mkdir(parents=True)

    t0 = time.perf_counter()
    H_img, W_img = LOOP_IMAGE
    data = toy.camera_ray_stores(K, cams=LOOP_CAMERAS, H=H_img, W=W_img, seed=0, device=DEV)
    boxes, _ = toy.quadrant_layout(K)
    stores = [RamRaysDataset.from_arrays(*st) for st in data["stores"]]
    train = [tasks.TaskSampler(ds, boxes[k], int(P.cell_dim), S, Q, seed=int(P.seed) + k,
                               route_cache=None) for k, ds in enumerate(stores)]
    test = tasks.MultiTaskSampler([
        tasks.TaskSampler(ds, boxes[k], int(P.cell_dim), S, Q, seed=int(P.seed) + 1000 + k,
                          route_cache=None) for k, ds in enumerate(stores)])
    pools_np = tasks.build_device_pools(train, seed=int(P.seed))
    pools = ts.pools_to_device(pools_np, DEV)
    del pools_np
    occ0 = premark_occ_states(occ_cfg, boxes, data["intrinsics"], data["c2w"], data["W"],
                              data["H"], float(P.near), device=DEV)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    n_rays = [len(ds) for ds in stores]
    check(n_rays == [LOOP_CAMERAS * H_img * W_img] * K, f"rays per expert {n_rays}")
    check(all(bool((ds.rays[:, 7] > ds.rays[:, 6]).all()) for ds in stores),
          "a camera ray misses its expert's box")
    premarked = float((occ0["occs"] < 0).float().mean())
    sampler = check_sampler(torch, ts, pools, T, S, Q)
    del data, stores

    # the run: 12 steps from step 0
    model = loop_model(torch, toy, cfg, seed=2)
    opt, state = toy.init_train_state(model, P)
    logger = Logger("run", logs_root=str(LOOP_DIR))
    probe = _LoopProbe(torch, tr, segscan, int(P.seed), sync=True)
    _zero_scan_counts(segscan)
    torch.cuda.reset_peak_memory_stats()
    out = tr.meta_trainer(P, cfg, state, opt, None, test, logger, occ_cfg=occ_cfg,
                          occ_states=occ0, device_pools=pools, draws=probe, device=DEV)
    probe.mark("end")
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    logger.close()
    launches = _scan_counts(segscan)
    rec = out["loop"]
    steps = probe.per_step()
    regimes = [s["regime"] for s in rec["steps"]]
    check(len(steps) == len(regimes) == 12, f"{len(steps)} steps, want 12")
    first = {r: regimes.index(r) for r in ("stratified", "strided", "budget") if r in regimes}
    check(regimes[:3] == ["stratified"] * 3 and "strided" in first and "budget" in first
          and first["strided"] < first["budget"] == rec["switched_at"]
          and regimes[first["budget"]:] == ["budget"] * (12 - first["budget"]),
          f"regimes {regimes}, switched after step {rec['switched_at']}")
    for r, s in zip(regimes, steps):
        want = (per_step, per_step) if r == "budget" else (0, 0)
        check(s["launches"] == want, f"a {r} step launched scan kernels {s['launches']}, "
              f"want {want}")
    overflow = [float(x["metrics"]["occ_overflow"]) for x in rec["steps"]]
    for x in rec["steps"]:
        check(all(np.isfinite(v).all() for v in x["metrics"].values()),
              f"a metric of step {x['step']} is not finite")
    run = logger.logdir
    for tag in ("best", "step6", "step12", "last"):
        check((run / f"{tag}.model").exists(), f"{tag}.model was not written")
    # each save of the port read back and written again gives its bytes
    for tag in ("best", "step6", "last"):
        reload_exact(tck, run, tag, cfg, opt)
    got, occ_last = tck.restore_model(tck.load_checkpoint(run, "last"), cfg, "cpu")
    nn.tree_map(lambda a, b: check(torch.equal(a, b.cpu()), "last.model differs from the run"),
                got.params(), model.params())
    check(all(torch.equal(occ_last[k], out["occ_states"][k].cpu()) for k in occ_last),
          "last.model's grids differ from the run's")
    share = out["occ_states"]["binaries"].float().mean(dim=(1, 2, 3, 4)).tolist()
    by_regime = {}
    for r, s in zip(regimes, steps):
        by_regime.setdefault(r, []).append(s["ms"])
    emit({"phase": "training_run", "K": K, "T": T, "support_rays": S, "query_rays": Q,
          "inner_iter": I, "rays_per_expert": n_rays[0], "cameras_per_expert": LOOP_CAMERAS,
          "pool_shape": list(pools["pool_idx"].shape), "premarked_invisible": premarked,
          "data_s": data_s, **sampler, "regimes": regimes,
          "switched_after_step": rec["switched_at"], "occ_overflow": overflow,
          "step_ms": by_regime,
          "rays_per_s": {r: [rays_per_step / (1e-3 * t) for t in v] for r, v in by_regime.items()},
          "update_ms": probe.spans("occ_update"), "eval_ms": probe.spans("eval"),
          "eval_psnr": rec["eval_psnr"], "save_hold_ms": rec["save_ms"],
          "peak_mem_mb": peak_mb, "occupied_share": share,
          "scan_launches": {"forward": launches[0], "reverse": launches[1]},
          "loss_total": [float(x["metrics"]["loss_total"]) for x in rec["steps"]]})
    del out, state, model, probe

    # the resume from step6: the saved state exactly, then two steps; every
    # second step logs, so step 7 reads nothing back and waits for the card
    # no more than a bare budget step does (phase 5)
    payload = tck.load_checkpoint(run, "step6")
    model, occ = tck.restore_model(payload, cfg, DEV)
    P2 = types.SimpleNamespace(**load_checkpoint_cfg(str(run / "step6.P.json")))
    P2.outer_steps, P2.print_step = 8, 2
    opt2, state2 = toy.init_train_state(model, P2)
    state2["opt_state"] = tck.load_opt_state(run, "step6", state2["opt_state"], opt2)
    state2["step"] = payload["step"]
    switched = rec["switched_at"] is not None and rec["switched_at"] <= 6
    check(payload["step"] == 6 and payload["best"] == rec["eval_psnr"][0][1]
          and int(state2["opt_state"]["count"]) == 6
          and (P2.occ_regime == "budget") == switched,
          f"the resume state: step {payload['step']}, best {payload['best']}, count "
          f"{int(state2['opt_state']['count'])}, occ_regime {P2.occ_regime}")
    logger = Logger("run", logs_root=str(LOOP_DIR))
    _zero_scan_counts(segscan)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            probe = _LoopProbe(torch, tr, segscan, 1, sync=False, caught=caught)
            out = tr.meta_trainer(P2, cfg, state2, opt2, None, test, logger, occ_cfg=occ_cfg,
                                  occ_states=occ, start_step=payload["step"],
                                  best=payload["best"], device_pools=pools, draws=probe,
                                  device=DEV)
            probe.mark("end")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    logger.close()
    resumed = probe.per_step()
    rec2 = out["loop"]
    check([x["step"] for x in rec2["steps"]] == [7, 8]
          and all(x["regime"] == ("budget" if switched else x["regime"]) for x in rec2["steps"]),
          f"the resumed run's steps {rec2['steps']}")
    if switched:
        check(all(s["launches"] == (per_step, per_step) for s in resumed),
              f"resumed budget steps launched {[s['launches'] for s in resumed]}")
    check(resumed[0]["syncs"] <= step_syncs,
          f"the non-log step 7 waited for the card {resumed[0]['syncs']} times, a bare "
          f"step {step_syncs}")
    check((logger.logdir / "last.model").exists(), "the resumed run wrote no last.model")
    emit({"phase": "training_resume", "from": "step6", "start_step": payload["step"],
          "best": payload["best"], "opt_count": 6, "occ_regime": P2.occ_regime,
          "steps": [x["step"] for x in rec2["steps"]],
          "step_ms_no_sync": [s["ms"] for s in resumed],
          "host_syncs_non_log_step": resumed[0]["syncs"], "host_syncs_bare_step": step_syncs,
          "scan_launches_per_step": [s["launches"] for s in resumed]})
    total = _scan_counts(segscan)
    del out, state2, model, pools
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    return {"fwd": launches[0] + total[0], "rev": launches[1] + total[1]}


# ---------------------------------------------------------------- phase 8


RUNNER_DIR = Path(__file__).resolve().parent / "logs" / "chip_smoke_runner"
RUNNER_CAMERAS, RUNNER_IMAGE = (32, 8), (192, 256)  # (train, val) cameras; (H, W)
RUNNER_STEPS = 8
RUNNER_TTO = "0,2,0"
TTO_CHECK_RAYS = 1024


def _run_flags(config, *flags):
    return ["--configPath", str(Path(__file__).resolve().parent / "configs" / config),
            "--data_path", str(RUNNER_DIR / "data"), *flags]


def tto_step_card_vs_cpu(torch, trt, tck, nn, toptim, tcont, cfg, occ_cfg, P, run, md,
                         gaabb) -> dict:
    """One float32 TTO step of the run's ``last`` state on 1,024 rays of a
    validation view, with one set of injected draws, on the card against
    the CPU: the loss rtol 1e-5; the clipped gradient (the optimizer's first
    moment over 1 − β1) atol 1e-6 with rtol 1e-3 on the tables and 1e-4 on
    the MLPs (cuBLAS sums in another order; the table gradient is a
    scatter-add with atomics); the parameters after the step atol 1e-6 /
    rtol 1e-4 where the gradient is at least 1e-6 (the first Adam step is
    lr·g/(|g| + 1e-8), so below that the gradient's rounding is most of
    the update, and the gradient alone is held there)."""
    from acn_tpu_torch.data.ram_rays import RamRaysDataset

    store = RamRaysDataset([md], aabb=gaabb, near_far_override=(P.near, P.far), num_workers=1)
    rays, rgbs, _ = store.sample(np.random.default_rng(0), TTO_CHECK_RAYS)
    gen = torch.Generator().manual_seed(9)
    rand = (torch.rand((TTO_CHECK_RAYS, int(P.occ_s_max)), generator=gen),
            torch.randint(0, 1 << 30, (TTO_CHECK_RAYS,), generator=gen))
    out = {}
    for dev in ("cuda", "cpu"):
        model, occ = tck.restore_model(tck.load_checkpoint(run, "last"), cfg, dev)
        opt = toptim.build_optimizer(P, tcont.param_group_labels(model.params()), grad_clip=1.0)
        step = trt.make_tto_step(cfg, P, opt, occ_cfg, use_occ=True)
        t0 = time.perf_counter()
        state, loss = step(model, opt.init(model.params()), occ,
                           torch.from_numpy(rays).to(dev), torch.from_numpy(rgbs).to(dev),
                           tuple(x.to(dev) for x in rand))
        loss = float(loss)
        out[dev] = (loss, nn.tree_leaves(model.params()), nn.tree_leaves(state["mu"]),
                    1e3 * (time.perf_counter() - t0))
        del model, occ, state
    (lg, pg, mg, ms), (lc, pc, mc, cpu_ms) = out["cuda"], out["cpu"]
    check(np.isfinite(lg) and abs(lg - lc) <= 1e-5 * abs(lc),
          f"TTO step loss: card {lg}, CPU {lc}")
    n_tables = cfg.expert.hash.levels
    err = {"grad_table": 0.0, "grad_mlp": 0.0, "param": 0.0}
    for i, (a, b, ma, mb) in enumerate(zip(pg, pc, mg, mc)):
        kind = "table" if i < n_tables else "mlp"
        ga, gb = ma.cpu() / 0.1, mb / 0.1
        err[f"grad_{kind}"] = max(err[f"grad_{kind}"], float((ga - gb).abs().max()))
        check(torch.allclose(ga, gb, atol=1e-6, rtol=1e-3 if kind == "table" else 1e-4),
              f"TTO step gradient leaf {i} ({kind}): card vs CPU max |diff| "
              f"{float((ga - gb).abs().max())}")
        big = gb.abs() >= 1e-6
        if not bool(big.any()):
            continue
        a, b = a.detach().cpu()[big], b.detach()[big]
        err["param"] = max(err["param"], float((a - b).abs().max()))
        check(torch.allclose(a, b, atol=1e-6, rtol=1e-4),
              f"TTO step parameter leaf {i}: card vs CPU max |diff| {float((a - b).abs().max())}")
    return {"rays": TTO_CHECK_RAYS, "loss_card": lg, "loss_cpu": lc, "step_ms_card": ms,
            "step_ms_cpu": cpu_ms, **{f"max_abs_err_{k}": v for k, v in err.items()}}


def metrics_card_vs_cpu(torch, tlosses, LPIPS, pred, gt) -> dict:
    """SSIM and LPIPS (fallback weights) of one rendered view and its gt, on
    the card against the CPU: SSIM atol 1e-4 and inside [-1, 1] to a float32
    ulp, LPIPS rtol 1e-4. cuDNN sums its convolutions in another order (TF32
    is off), and SSIM's variances E[x²] − μ² cancel terms of ≈ 0.1–0.3 down
    to ≈ 1e-3, so a float32 rounding of the blurred terms shows at ≈ 1e-5
    in SSIM. Also SSIM on the card of a nearly constant image against
    itself, the case that leaves [-1, 1] where the blur's sums lose their
    precision: 1 to a float32 ulp (a mean of window ratios that are all 1
    may round an ulp past it)."""
    out = {}
    for dev in ("cuda", "cpu"):
        p, g = torch.from_numpy(pred).to(dev), torch.from_numpy(gt).to(dev)
        out[dev] = (float(tlosses.ssim(p, g)), LPIPS(device=dev)(pred, gt))
    (sg, lg), (sc, lc) = out["cuda"], out["cpu"]
    check(abs(sg) <= 1.0 + 1e-6 and abs(sg - sc) <= 1e-4, f"SSIM: card {sg}, CPU {sc}")
    check(np.isfinite(lg) and abs(lg - lc) <= 1e-4 * abs(lc), f"LPIPS: card {lg}, CPU {lc}")
    flat = torch.from_numpy(
        (0.5 + 1e-4 * np.random.default_rng(0).random(pred.shape)).astype(np.float32)).cuda()
    sf = float(tlosses.ssim(flat, flat))
    check(abs(sf - 1.0) <= 1e-6, f"SSIM of a nearly constant image against itself: {sf}")
    return {"ssim_card": sg, "ssim_cpu": sc, "ssim_flat_self_card": sf,
            "lpips_fallback_card": lg, "lpips_fallback_cpu": lc}


def phase_runner(torch, segscan, toy) -> dict:
    """The runner at full width on a dataset on disk (module docstring,
    phase 8). Returns the scan's launch counts of the train and eval runs,
    and the train run's directory, which phase 9 reads and then removes."""
    import shutil

    from acn_tpu_torch import runner
    from acn_tpu_torch.data import dataset, tasks
    from acn_tpu_torch.models import container as tcont
    from acn_tpu_torch.models import nn
    from acn_tpu_torch.models.lpips import LPIPS
    from acn_tpu_torch.nerfs import losses as tlosses
    from acn_tpu_torch.pipelines.offline_stage import trainer as tr
    from acn_tpu_torch.pipelines.online_stage import runtime_adapt as trt
    from acn_tpu_torch.pipelines.renderer import Renderer
    from acn_tpu_torch.utils import checkpoint as tck
    from acn_tpu_torch.utils import optim as toptim
    from acn_tpu_torch.utils.config import parse_args

    torch.cuda.empty_cache()
    shutil.rmtree(RUNNER_DIR, ignore_errors=True)
    # (a) the dataset; the run builds its ray stores and routes afresh
    t0 = time.perf_counter()
    n_train, n_val = RUNNER_CAMERAS
    toy.write_dataset_dir(RUNNER_DIR / "data", K=4, train_cams=n_train, val_cams=n_val,
                          H=RUNNER_IMAGE[0], W=RUNNER_IMAGE[1])
    write_s = time.perf_counter() - t0
    saved = (dataset.RAY_CACHE, tasks.ROUTE_CACHE, runner.build_occ_config, tr.LoopDraws)
    dataset.RAY_CACHE, tasks.ROUTE_CACHE = RUNNER_DIR / "rays", RUNNER_DIR / "routes"
    # the grids rebuilt every 2 steps (a constant of the runner, no flag)
    runner.build_occ_config = lambda P, psf: dataclasses.replace(
        saved[2](P, psf), update_interval=2)
    probes = []

    def probe(seed, device):
        probes.append(_LoopProbe(torch, types.SimpleNamespace(LoopDraws=saved[3]), segscan,
                                 seed, sync=True))
        return probes[-1]

    tr.LoopDraws = probe
    run = RUNNER_DIR / "train"
    try:
        # (b) --op train: configs/train_occ.json cut to 8 steps
        _zero_scan_counts(segscan)
        t0 = time.perf_counter()
        out = runner.main(_run_flags(
            "train_occ.json", "--fname", str(run),
            "--outer_steps", str(RUNNER_STEPS), "--occ_warmup", "2", "--occ_auto_patience", "1",
            "--eval_step", "4", "--save_step", "4", "--print_step", "1"))
        probes[-1].mark("end")
        train_s = time.perf_counter() - t0
        train_launches = _scan_counts(segscan)
        # (c) --op eval on its last save, TTO 0, 2, 0
        _zero_scan_counts(segscan)
        t0 = time.perf_counter()
        res = runner.main(_run_flags(
            "eval.json", "--checkpoint_path", str(run), "--prefix", "last", "--tto",
            RUNNER_TTO, "--test_batch_size", "4", "--fname", str(RUNNER_DIR / "eval")))
        eval_s = time.perf_counter() - t0
        eval_launches = _scan_counts(segscan)
    finally:
        dataset.RAY_CACHE, tasks.ROUTE_CACHE, runner.build_occ_config, tr.LoopDraws = saved
    steps = probes[-1].per_step()
    rec = out["loop"]
    regimes = [x["regime"] for x in rec["steps"]]
    K, T, I = 4, 3, 8
    per_step = K * T * (I + 1)
    check(len(steps) == len(regimes) == RUNNER_STEPS,
          f"the runner's probe saw {len(steps)} steps and the loop logged {len(regimes)}, "
          f"want {RUNNER_STEPS}")
    check(regimes[:2] == ["stratified"] * 2 and "budget" in regimes
          and regimes[regimes.index("budget"):] == ["budget"] * (
              RUNNER_STEPS - regimes.index("budget")),
          f"runner regimes {regimes}, switched after step {rec['switched_at']}")
    for r, st in zip(regimes, steps):
        want = (per_step, per_step) if r == "budget" else (0, 0)
        check(st["launches"] == want, f"a {r} step of the runner launched {st['launches']}, "
              f"want {want}")
    for x in rec["steps"]:
        check(all(np.isfinite(v).all() for v in x.get("metrics", {}).values()),
              f"a metric of runner step {x['step']} is not finite")
    for tag in ("last", "step4"):
        payload = tck.load_checkpoint(run, tag)
        check(payload["occ_states"] is not None and (run / f"{tag}.optim").exists(),
              f"{tag} was saved without its grids or optimizer")
    by_regime = {}
    for r, st in zip(regimes, steps):
        by_regime.setdefault(r, []).append(st["ms"])
    emit({"phase": "runner_train", "images": {"train": n_train, "val": n_val},
          "image_hw": list(RUNNER_IMAGE), "write_dataset_s": write_s,
          "rays_s": out["setup_s"]["rays"], "route_s": out["setup_s"]["route"],
          "train_rays_per_expert": out["setup_s"]["train_rays"],
          "main_s": train_s, "regimes": regimes, "switched_after_step": rec["switched_at"],
          "step_ms": by_regime, "update_ms": probes[-1].spans("occ_update"),
          "eval_psnr": rec["eval_psnr"],
          "scan_launches_per_step": [st["launches"] for st in steps],
          "scan_launches": {"forward": train_launches[0], "reverse": train_launches[1]}})

    # the eval: scan launches, scores, the reset between settings
    # the eval's config; near and far need no normalizing (pose scale 1)
    P = parse_args(_run_flags("eval.json", "--checkpoint_path", str(run),
                              "--prefix", "last"))
    masks = RUNNER_DIR / "data" / "out" / "example" / "masks" / P.mask_dirname
    cfg = runner.build_model_configs(P, dataset.load_clustering_meta(masks))
    occ_cfg = runner.build_occ_config(P, 1.0)
    gaabb = dataset.load_scene_boxes(masks)[0]
    rows = max(Renderer(cfg, P, occ_cfg, device="cuda").chunk_rays // RUNNER_IMAGE[1], 1)
    chunks = -(-RUNNER_IMAGE[0] // rows)
    ttos = [int(t) for t in RUNNER_TTO.split(",")]
    check(eval_launches == (chunks * n_val * len(ttos), 0),
          f"the eval launched the scan {eval_launches}, want {chunks} chunks × {n_val} "
          f"views × {len(ttos)} settings forward and 0 reverse")
    for r in res:
        for v in r["views"]:
            check(np.isfinite(v["psnr"]) and abs(v["ssim"]) <= 1.0 + 1e-6,
                  f"tto={r['tto']}: PSNR {v['psnr']}, SSIM {v['ssim']}")
        check(np.isfinite(r["tto_losses"]).all(), f"tto={r['tto']}: losses {r['tto_losses']}")
    scores = lambda r: [(v["psnr"], v["ssim"]) for v in r["views"]]
    check(scores(res[0]) == scores(res[2]), "the two tto=0 legs differ: the base weights "
          "were not restored")
    batches = -(-n_val // 4)
    tto_steps = sum(t * batches for t in ttos)
    emit({"phase": "runner_eval", "tto": ttos, "views": n_val, "chunks_per_frame": chunks,
          "main_s": eval_s, "psnr": [r["psnr"] for r in res], "ssim": [r["ssim"] for r in res],
          "tto_losses": [r["tto_losses"] for r in res],
          "frame_ms": [v["frame_ms"] for r in res for v in r["views"]],
          "ssim_ms": [v["ssim_ms"] for r in res for v in r["views"]],
          "tto_step_ms": 1e3 * sum(r["adapt_s"] for r in res) / max(tto_steps, 1),
          "scan_launches": {"forward": eval_launches[0], "reverse": eval_launches[1]},
          "tto0_legs_equal": True})

    # (d) card against CPU: a TTO step, and SSIM and LPIPS of one view
    md = dataset.get_image_metadata(RUNNER_DIR / "data" / "out" / "example", P.downscale)[1][0]
    tto = tto_step_card_vs_cpu(torch, trt, tck, nn, toptim, tcont, cfg, occ_cfg, P, run, md,
                               gaabb)
    model, occ = tck.restore_model(tck.load_checkpoint(run, "last"), cfg, "cuda")
    rgb, _, _ = Renderer(cfg, P, occ_cfg, device="cuda").render_image(
        model, occ, H=md.H, W=md.W, intrinsics=md.intrinsics, c2w=md.c2w, aabb=gaabb,
        near_far_override=(P.near, P.far))
    met = metrics_card_vs_cpu(torch, tlosses, LPIPS, rgb, md.load_image().astype(np.float32)
                              / 255.0)
    del model, occ
    emit({"phase": "runner_vs_cpu", "tto_step": tto, **met})
    return {"train": train_launches, "eval": eval_launches, "run": run}


# ---------------------------------------------------------------- phase 9


SERVE_SMALL = (64, 96)  # the card-against-CPU frames
BAKE_RES = 256  # --bake_resolution's default of 512, cut for the smoke's time
BAKE_CHECK_RES = 24
VIDEO_FRAMES = 8
ROUTED_ATOL = 0.02  # tests/test_renderer_routed.py:50-68, rgb and acc


def _frames_vs_cpu(got, want, what) -> dict:
    """u8 rgb within one step, f16 depth and acc within rtol 1e-3 (atol
    1e-3): card against CPU."""
    errs = {k: float(np.abs(np.asarray(g) - np.asarray(w)).max())
            for k, g, w in zip(("rgb", "depth", "acc"), got, want)}
    check(np.isfinite(got[0]).all() and errs["rgb"] <= 1.0 / 255 + 1e-6
          and all(np.allclose(g, w, rtol=1e-3, atol=1e-3) for g, w in zip(got[1:], want[1:])),
          f"{what}: card vs CPU frames disagree {errs}")
    return errs


def _timed(torch, fn, n: int) -> list:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def _gif_or_mp4_frames(path: str, fps: int = 30) -> int:
    """Frames in a written video: a GIF's total duration over one frame's
    (Pillow merges identical neighbours), an MP4's frames through imageio."""
    if path.endswith(".gif"):
        from PIL import Image

        # a merged frame lasts k frames' time, stored in whole centiseconds
        d = max(int(1000 / fps), 20)
        with Image.open(path) as im:
            n = 0
            for i in range(im.n_frames):
                im.seek(i)
                n += round(im.info["duration"] / d)
        return n
    import imageio.v3 as iio

    return int(iio.imread(path).shape[0])


def _profile_frame(torch, fn, profile_dir, name) -> None:
    """One frame under the profiler: its busy and idle share and the ops
    that took most of the card's time."""
    prof, wall_ms, busy_ms, launches = profile_window(torch, fn, profile_dir, name)
    top = sorted(prof.key_averages(), key=lambda e: -(
        getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)))[:12]
    emit({"phase": f"{name}_profile", "frame_wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "idle_share": 1.0 - busy_ms / wall_ms, "kernel_launches": launches,
          "top_ops_device_ms": {e.key[:60]: 1e-3 * (
              getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0))
              for e in top}})


def phase_serving(torch, segscan, toy, model, occ, dense_ms, run, profile_dir) -> dict:
    """Routed, single-expert and baked serving, the bake, and the runner's
    baked eval and video (module docstring, phase 9), on phase 3's model and
    grids (with phase 4's σ-head bias of +2) and phase 8's run. Returns the
    scan's launch counts of each path. With ``profile_dir``, a routed and a
    baked frame are profiled too."""
    import shutil

    from acn_tpu_torch import runner
    from acn_tpu_torch.occupancy import grid as occ_grid
    from acn_tpu_torch.pipelines import baking
    from acn_tpu_torch.pipelines.renderer import Renderer, _pinhole_block_rays

    t_phase = time.perf_counter()
    cfg, P, occ_cfg = toy.train_occ_config()
    boxes, _ = toy.quadrant_layout(cfg.num_submodules)
    cam = toy.overhead_camera(H, W)
    renderer = Renderer(cfg, P, occ_cfg)
    counted = {}
    torch.cuda.empty_cache()

    # (a) routed frames: one warm, two timed, one downloaded
    rects = renderer.routed_rects(boxes, cam["c2w"], cam["intrinsics"], H, W, 32)
    plan = renderer.routed_dispatch(rects, W, True)
    routed = lambda **kw: renderer.render_image_routed(model, occ, H=H, W=W, **cam, **kw)
    _zero_scan_counts(segscan)
    torch.cuda.synchronize()
    warm = _timed(torch, lambda: routed(download=False), 1)
    frame_ms = _timed(torch, lambda: routed(download=False), 2)
    t0 = time.perf_counter()
    rgb, depth, acc = routed()
    e2e_ms = 1e3 * (time.perf_counter() - t0)
    counted["routed_frames"] = _scan_counts(segscan)
    check(counted["routed_frames"] == (4 * len(plan), 0),
          f"4 routed frames launched the scan {counted['routed_frames']}, want "
          f"{len(plan)} chunks × 4 forward and 0 reverse")
    check(rgb.shape == (H, W, 3) and np.isfinite(rgb).all() and np.isfinite(depth).all()
          and np.isfinite(acc).all(), "the routed frame is not finite or misshapen")
    if profile_dir:
        _profile_frame(torch, lambda: routed(download=False), profile_dir, "serving_routed")
    # identical experts: the routed frame reproduces the dense one
    tied, tied_occ = toy.identical_experts(model), toy.identical_occ(occ)
    dense = renderer.render_image(tied, tied_occ, H=H, W=W, **cam)
    rt = renderer.render_image_routed(tied, tied_occ, H=H, W=W, expert_aabbs=boxes, **cam)
    tie_err = {k: float(np.abs(a - b).max()) for k, a, b in
               zip(("rgb", "depth", "acc"), rt, dense)}
    check(tie_err["rgb"] <= ROUTED_ATOL and tie_err["acc"] <= ROUTED_ATOL,
          f"routed vs dense with identical experts: {tie_err}")
    del tied, tied_occ, dense, rt
    h, w = SERVE_SMALL
    cam_s = toy.overhead_camera(h, w)
    # the CPU twin of the model as phase 4 left it (σ-head bias +2)
    model_cpu = toy.serving_model(cfg, seed=0, device="cpu")
    model_cpu.load_state_dict(model.state_dict())
    occ_cpu = {k: v.cpu() for k, v in occ.items()}
    small = _frames_vs_cpu(
        renderer.render_image_routed(model, occ, H=h, W=w, **cam_s),
        Renderer(cfg, P, occ_cfg, device="cpu").render_image_routed(
            model_cpu, occ_cpu, H=h, W=w, **cam_s), "routed 64×96")
    emit({"phase": "serving_routed", "H": H, "W": W,
          "rects": [[int(v) for v in r] for r in rects],
          "chunks_per_frame": len(plan),
          "rays_per_chunk": [p[4] * p[5] for p in plan[:1]][0],
          "warm_frame_ms": warm[0], "frame_ms": frame_ms,
          "mean_frame_ms": statistics.mean(frame_ms), "frame_ms_with_download": e2e_ms,
          "dense_frame_ms_phase3": dense_ms,
          "routed_over_dense": statistics.mean(frame_ms) / statistics.mean(dense_ms),
          "scan_launches": {"forward": counted["routed_frames"][0],
                            "reverse": counted["routed_frames"][1]},
          "identical_experts_vs_dense_max_err": tie_err, "atol": ROUTED_ATOL,
          "card_vs_cpu_64x96_max_err": small, "mean_acc": float(acc.mean())})

    # (b) single-expert frames: budget 32, budget 0, and the range pre-pass
    rows = max(renderer.chunk_rays // W, 1)
    P0 = types.SimpleNamespace(**{**vars(P), "occ_budget_per_ray": 0})
    Pc = types.SimpleNamespace(**{**vars(P), "occ_render_s_coarse": 32})
    single = {}
    for name, Pk in (("budget", P), ("budget0", P0), ("coarse32", Pc)):
        r = Renderer(cfg, Pk, occ_cfg)
        chunks = -(-H // max(r.chunk_rays // W, 1))
        _zero_scan_counts(segscan)
        ms = [_timed(torch, lambda k=k: r.render_image(model, occ, H=H, W=W, active_module=k,
                                                      download=False, **cam), 1)[0]
              for k in range(cfg.num_submodules)]
        counted[f"single_expert_{name}"] = got = _scan_counts(segscan)
        want = (0 if name == "budget0" else chunks * cfg.num_submodules, 0)
        check(got == want, f"single-expert {name} frames launched the scan {got}, want {want}")
        single[name] = {"frame_ms_by_expert": ms, "chunks_per_frame": chunks,
                        "scan_launches": {"forward": got[0], "reverse": got[1]}}
    rays = _pinhole_block_rays(H, W, *(torch.as_tensor(np.asarray(cam[k], np.float32),
                                                       device="cuda")
                                       for k in ("c2w", "intrinsics", "aabb")),
                               torch.tensor([-np.inf, np.inf], device="cuda"), 0.0, 0.0)
    near, far = occ_grid.clamped_near_far(rays, occ_cfg)
    ok = far > near
    tight = []
    for k in range(cfg.num_submodules):
        n2, f2 = occ_grid.coarse_ray_range({n: v[k] for n, v in occ.items()}, rays[:, :3],
                                           rays[:, 3:6], near, far, 32)
        tight.append(float(((f2 - n2)[ok] / (far - near)[ok]).mean()))
    emit({"phase": "serving_single_expert", **single,
          "coarse_range_mean_kept_fraction_by_expert": tight})

    # (c) the bake of phase 8's last through the runner, timed
    saved, save_s = [], []
    save_baked = baking.save_baked

    def recording_save(path, baked):
        saved.append(baked)
        t0 = time.perf_counter()
        save_baked(path, baked)
        save_s.append(time.perf_counter() - t0)

    baking.save_baked = recording_save
    try:
        t0 = time.perf_counter()
        path = runner.main(_run_flags(
            "eval.json", "--op", "bake", "--checkpoint_path", str(run), "--prefix", "last",
            "--bake_resolution", str(BAKE_RES), "--fname", str(RUNNER_DIR / "bake")))
        bake_s = time.perf_counter() - t0
    finally:
        baking.save_baked = save_baked
    asset = baking.load_baked(path)
    for name in ("table", "aabb"):
        check(torch.equal(asset[name], saved[0][name]), f"load_baked's {name} differs")
    check(torch.equal(asset["occ_state"]["binaries"], saved[0]["occ_state"]["binaries"]),
          "load_baked's grid differs")
    occupied = float(asset["occ_state"]["binaries"].float().mean())
    del saved
    from acn_tpu_torch.utils import checkpoint as tck

    bake_err = {}
    models = {dev: tck.restore_model(tck.load_checkpoint(run, "last"),
                                     runner.build_model_configs(
                                         *_runner_cfg_args(runner)), dev)[0]
              for dev in ("cuda", "cpu")}
    for sh in (0, 1):
        a, b = (baking.bake_container(models[dev], resolution=BAKE_CHECK_RES,
                                      chunk=BAKE_CHECK_RES ** 3, sh_degree=sh)["table"].cpu()
                for dev in ("cuda", "cpu"))
        bake_err[f"sh{sh}"] = float((a - b).abs().max())
        check(torch.allclose(a, b, atol=1e-5, rtol=1e-5),
              f"bake_field SH {sh} at {BAKE_CHECK_RES}³: card vs CPU max |diff| "
              f"{bake_err[f'sh{sh}']}")
    del models
    emit({"phase": "serving_bake", "resolution": BAKE_RES,
          "cut": "--bake_resolution 512 (the flag's default) cut to 256 for the smoke's time",
          "bake_s": bake_s, "save_baked_s": save_s[0],
          "table_mb": asset["table"].numel() * 4 / 2**20,
          "occupied": occupied, "occ_resolution": asset["occ_cfg"].resolution,
          "load_baked_bit_equal": True,
          f"card_vs_cpu_{BAKE_CHECK_RES}^3_max_abs_err": bake_err, "atol": 1e-5, "rtol": 1e-5})

    # (d) baked 1080p frames: budget 24 (the video's), with the pre-pass, budget 0
    baked = {}
    for name, kw in (("budget24", dict(budget_per_ray=24)),
                     ("budget24_coarse32", dict(budget_per_ray=24, s_coarse=32)),
                     ("budget0", dict(budget_per_ray=0))):
        br = baking.BakedRenderer(asset, chunk_points=int(P.chunk_points), **kw)
        chunks = -(-H // br.rows(W))
        frame = lambda br=br, **k: br.render_image(H=H, W=W, intrinsics=cam["intrinsics"],
                                                   c2w=cam["c2w"], **k)
        _zero_scan_counts(segscan)
        warm = _timed(torch, lambda: frame(download=False), 1)
        ms = _timed(torch, lambda: frame(download=False), 1 if name == "budget0" else 2)
        counted[f"baked_{name}"] = got = _scan_counts(segscan)
        n = 1 + len(ms)
        want = (0 if name == "budget0" else chunks * n, 0)
        check(got == want, f"baked {name} frames launched the scan {got}, want {want}")
        rgb, _, acc = frame()
        check(np.isfinite(rgb).all() and np.isfinite(acc).all(), f"baked {name} frame")
        baked[name] = {"warm_frame_ms": warm[0], "frame_ms": ms, "chunks_per_frame": chunks,
                       "rays_per_chunk": br.rows(W) * W,
                       "scan_launches": {"forward": got[0], "reverse": got[1]},
                       "mean_acc": float(acc.mean())}
    if profile_dir:
        br = baking.BakedRenderer(asset, chunk_points=int(P.chunk_points), budget_per_ray=24)
        _profile_frame(torch, lambda: br.render_image(
            H=H, W=W, intrinsics=cam["intrinsics"], c2w=cam["c2w"], download=False),
            profile_dir, "serving_baked")
    asset_cpu = baking.load_baked(path, device="cpu")
    view = dict(H=h, W=w, intrinsics=cam_s["intrinsics"], c2w=cam_s["c2w"])
    baked["card_vs_cpu_64x96_max_err"] = _frames_vs_cpu(
        baking.BakedRenderer(asset, budget_per_ray=24).render_image(**view),
        baking.BakedRenderer(asset_cpu, budget_per_ray=24).render_image(**view), "baked 64×96")
    del asset_cpu
    emit({"phase": "serving_baked_frames", "H": H, "W": W, **baked,
          "dense_frame_ms_phase3": dense_ms})

    # (e) --op eval --baked_asset, TTO 0 and 2
    _zero_scan_counts(segscan)
    res = runner.main(_run_flags("eval.json", "--checkpoint_path", str(run), "--prefix", "last",
                                 "--baked_asset", path, "--tto", "0,2",
                                 "--fname", str(RUNNER_DIR / "eval_baked")))
    counted["runner_eval_baked"] = got = _scan_counts(segscan)
    Pe = runner.parse_args(_run_flags("eval.json", "--checkpoint_path", str(run),
                                      "--prefix", "last"))
    budget = int(getattr(Pe, "occ_budget_per_ray", 0) or 0)
    br = baking.BakedRenderer(asset, budget_per_ray=budget, chunk_points=int(Pe.chunk_points))
    n_val = RUNNER_CAMERAS[1]
    chunks = -(-RUNNER_IMAGE[0] // br.rows(RUNNER_IMAGE[1]))
    want = (chunks * n_val * 2 if budget else 0, 0)
    check(got == want, f"the baked eval launched the scan {got}, want {want} (budget {budget})")
    for r in res:
        check(np.isfinite(r["psnr"]) and np.isfinite(r["ssim"]), f"baked eval tto={r['tto']}")
    # the tto=2 leg is the tto=0 leg rendered again: on the card the packed
    # composite's index_add_ adds with atomics, so a frame may differ in its
    # last bits (and a pixel on a u8 rounding edge by one step) between renders
    d_psnr, d_ssim = (max(abs(a[key] - b[key]) for a, b in zip(res[0]["views"], res[1]["views"]))
                      for key in ("psnr", "ssim"))
    check(res[1]["tto_losses"] == [] and d_psnr <= 1e-3 and d_ssim <= 1e-4,
          f"the baked tto=2 leg adapted, or scored other than tto=0 (PSNR by {d_psnr} dB, "
          f"SSIM by {d_ssim})")
    log = (RUNNER_DIR / "eval_baked" / "log.txt").read_text()
    line = "TTO does not apply to a baked table; rendering tto=2 leg without adaptation"
    check(line in log, "the baked eval did not log that TTO does not apply")
    emit({"phase": "serving_eval_baked", "tto": [0, 2], "views": n_val,
          "occ_budget_per_ray": budget,
          "march": "packed budget" if budget else "strided (budget 0)",
          "psnr": [r["psnr"] for r in res], "ssim": [r["ssim"] for r in res],
          "frame_ms": [v["frame_ms"] for r in res for v in r["views"]],
          "scan_launches": {"forward": got[0], "reverse": got[1]},
          "tto2_minus_tto0_max_abs": {"psnr": d_psnr, "ssim": d_ssim},
          "tto2_adapted": False, "logged": line})

    # (f) --op video, live and baked
    video = {}
    for name, extra in (("live", []), ("baked", ["--baked_asset", path])):
        _zero_scan_counts(segscan)
        t0 = time.perf_counter()
        out = runner.main(_run_flags("eval.json", "--op", "video", "--checkpoint_path",
                                     str(run), "--prefix", "last", "--video_frames",
                                     str(VIDEO_FRAMES), *extra,
                                     "--fname", str(RUNNER_DIR / f"video_{name}")))
        wall = time.perf_counter() - t0
        counted[f"runner_video_{name}"] = got = _scan_counts(segscan)
        n = _gif_or_mp4_frames(out)
        check(Path(out).exists() and n == VIDEO_FRAMES,
              f"--op video ({name}) wrote {out} with {n} frames, want {VIDEO_FRAMES}")
        hw = RUNNER_IMAGE[0] * RUNNER_IMAGE[1]
        if name == "live":
            chunks = -(-hw // Renderer(runner.build_model_configs(*_runner_cfg_args(runner)),
                                       Pe, runner.build_occ_config(Pe, 1.0)).chunk_rays)
        else:
            chunks = -(-RUNNER_IMAGE[0] // baking.BakedRenderer(
                asset, budget_per_ray=budget or 24,
                chunk_points=int(Pe.chunk_points)).rows(RUNNER_IMAGE[1]))
        want = (chunks * VIDEO_FRAMES if budget or name == "baked" else 0, 0)
        check(got == want, f"--op video ({name}) launched the scan {got}, want {want}")
        video[name] = {"path": Path(out).name, "frames": n, "wall_s": wall,
                       "encoder": "imageio libx264 (MP4)" if out.endswith(".mp4")
                       else "Pillow (GIF)", "chunks_per_frame": chunks,
                       "scan_launches": {"forward": got[0], "reverse": got[1]}}
    emit({"phase": "serving_video", **video, "phase9_s": time.perf_counter() - t_phase})
    del asset
    shutil.rmtree(RUNNER_DIR, ignore_errors=True)
    return counted


def _runner_cfg_args(runner):
    """(P, clustering meta) of phase 8's run for ``build_model_configs``."""
    from acn_tpu_torch.data import dataset

    P = runner.parse_args(_run_flags("eval.json", "--checkpoint_path",
                                     str(RUNNER_DIR / "train"), "--prefix", "last"))
    masks = RUNNER_DIR / "data" / "out" / "example" / "masks" / P.mask_dirname
    return P, dataset.load_clustering_meta(masks)


# ---------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="", metavar="DIR")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    # the reference's f32 products are full f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from acn_tpu_torch import toy
    from acn_tpu_torch.ops import cuda_lib, segscan
    from acn_tpu_torch.scripts import bench_segscan
    from acn_tpu_torch.pipelines.renderer import Renderer

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    build_s = cuda_lib.build()
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "build_wall_s": time.perf_counter() - t0,
          "ptxas": cuda_lib.build_log()})

    k = phase_kernel(torch, segscan, bench_segscan)
    model, occ, cam, (fwd_render, rev_render), dense_ms = phase_main_path(
        torch, segscan, toy, Renderer, args.profile)
    occ_cpu = phase_vs_cpu(torch, toy, Renderer, model, occ, cam)
    cfg = toy.train_occ_config()[0]
    model_cpu = toy.serving_model(cfg, seed=0, device="cpu")
    train = phase_train_step(torch, segscan, bench_segscan, toy, model_cpu,
                             occ_cpu, args.profile)
    regimes = phase_regimes(torch, segscan, toy, Renderer, model_cpu, occ_cpu,
                            args.profile)
    del model_cpu, occ_cpu
    loop = phase_training_run(torch, segscan, toy, train["syncs"])
    run8 = phase_runner(torch, segscan, toy)
    serve = phase_serving(torch, segscan, toy, model, occ, dense_ms, run8["run"], args.profile)
    del model, occ

    # launches: the counters as read after the main paths' runs (6 frames;
    # the sum over the 4 training steps; the sum over phase 6's steps and
    # frames, where only the budget step after the switch launches; the sum
    # over phase 7's two loop runs, where the budget steps launch; phase 8's
    # --op train and --op eval; phase 9's routed, single-expert and baked
    # frames, baked eval and videos), each counted from 0 just before its
    # path was driven. ms, plain_ms and
    # bound_ms at the serving chunk (B = 983,040); "train_shapes" holds the
    # same at the training step's B = 32,768 and 16,384.
    fwd_train, rev_train = train["launches"]
    fwd_reg, rev_reg = regimes["fwd"], regimes["rev"]
    fwd_loop, rev_loop = loop["fwd"], loop["rev"]
    (fwd_rtrain, rev_rtrain), (fwd_reval, rev_reval) = run8["train"], run8["eval"]
    by_path = lambda i: {name: c[i] for name, c in serve.items()}
    common = {"route": "cuda", "source": "acn_tpu_torch/csrc/segscan.cu",
              "bound_ms": k["bound_ms"], "bound_by": "bytes", "library_ms": None,
              "library_note": "no single PyTorch call computes a segmented scan"}
    emit({"kernels": [
        {"name": "seg_excl_sum", "replaces": "acn_tpu/ops/segscan.py:180",
         "launches": (fwd_render + fwd_train + fwd_reg + fwd_loop + fwd_rtrain + fwd_reval
                      + sum(c[0] for c in serve.values())),
         "launches_by_path": {"render_image": fwd_render, "train_step": fwd_train,
                              "regime_schedule": fwd_reg, "meta_trainer": fwd_loop,
                              "runner_train": fwd_rtrain, "runner_eval": fwd_reval,
                              **by_path(0)},
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "reverse_ms": k["reverse_ms"], "plain_ms": k["plain_ms"],
         "train_shapes": [{key: sh[key] for key in (
             "B", "ms", "plain_ms", "bound_ms", "max_abs_err")}
             for sh in train["shapes"]], **common},
        {"name": "seg_excl_rsum", "replaces": "acn_tpu/ops/segscan.py:251",
         "launches": (rev_render + rev_train + rev_reg + rev_loop + rev_rtrain + rev_reval
                      + sum(c[1] for c in serve.values())),
         "launches_by_path": {"render_image": rev_render, "train_step": rev_train,
                              "regime_schedule": rev_reg, "meta_trainer": rev_loop,
                              "runner_train": rev_rtrain, "runner_eval": rev_reval,
                              **by_path(1)},
         "max_abs_err": k["reverse_max_abs_err"], "ms": k["reverse_ms"],
         "plain_ms": k["reverse_plain_ms"],
         "train_shapes": [{"B": sh["B"], "ms": sh["reverse_ms"],
                           "plain_ms": sh["reverse_plain_ms"],
                           "bound_ms": sh["bound_ms"],
                           "max_abs_err": sh["reverse_max_abs_err"]}
                          for sh in train["shapes"]], **common},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
