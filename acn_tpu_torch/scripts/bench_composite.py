"""Time the packed composite kernels (``csrc/composite.cu``) and the frames
they serve, on one CUDA card.

    python -m acn_tpu_torch.scripts.bench_composite
        [--what kernel,backward,inplace,frames] [--frames 3] [--profile DIR]
    PYTHONPATH=<tree> python acn_tpu_torch/scripts/bench_composite.py --what frames

``kernel``: at the two chunks of ``ops/composite_bench.py`` (the dense
frame's budget march, N = 30,720 rays and B = 983,040 slots; a routed chunk
of 125,000 rays, B = 4,000,000), at the config's alpha threshold, with a
background and the stats (as serving calls it): one JSON line with the
kernel's largest difference from its plain version, and the card time per
call of the kernel, of the plain version all in PyTorch, of the composition
the port ran before the kernel (the scan kernel and ``index_add_``) and of
the library chain (the scan kernel and ``torch.segment_reduce``; timed
only), each a run of calls between one pair of CUDA events over copies of
the inputs that exceed the L2; the kernel's host µs per call; the byte
bound of the real samples, and over every slot.

``backward``: the backward kernel at a training episode's support and
query march (``configs/train_occ.json``'s 1,024 and 512 rays, and the
reference scale's 4,000 and 2,000 of ``configs/train.json`` and the CLI's
defaults) and at the dense chunk (``composite_bench.time_backward_case``):
one JSON line each with its largest difference from the plain version in
float64 (over each gradient's largest magnitude), the card ms of the
kernel, its plain version, the parent's differentiated composition and the
kernels' forward and backward through autograd, the byte bound, and a
one-element add by the same clock (``floor_ms``: at a support march the
byte bound lies far below a launch's own cost).

``inplace``: one FoMAML budget step of ``bench.py``'s problem (K 4, T 3,
S 1,024, Q 512, 8 inner steps) under ``torch.profiler``
(``scripts/profile_step.py``'s ``run``): each launch's device time of the
composite kernels in place (median, min, max, count) beside 64
one-element adds profiled on their own after the step (the floor). To
time another tree's kernels in place, run this tree's
``scripts/profile_step.py --scale 4,3,1024,512,8 --regimes budget`` with
that tree first on ``PYTHONPATH`` (its ``kernel_us``).

``frames``: the smoke's scene (``configs/train_occ.json``'s model from seed
0, toy's 10 % grids, its overhead camera) at 1080 × 1920: a warm and
``--frames`` timed dense frames (``render_image``), then with the σ-head
bias set to +2 (as ``chip_smoke.py`` phase 4 leaves it) routed frames
(``render_image_routed``) and baked frames at budget 24
(``BakedRenderer`` over the model baked at 256³ with ``bake_container``);
ms per frame, the composite and scan launches per frame. With ``--profile
DIR`` one more frame of each under ``torch.profiler``: busy and idle
share, kernel launches, the composite and scan kernels in place, the
device time of the top ops; the tables in DIR.

With another tree first on ``PYTHONPATH`` (the parent commit), ``--what
frames`` times that tree's frames (its composition where it has no
``ops/composite.py``). To compare two trees, run it from each in turns in
one call (parent, this, this, parent). Every line carries the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

H, W = 1080, 1920
BAKE_RES = 256
BAKED_BUDGET = 24
TOP_OPS = 16


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def _composite():
    """The tree's ``ops/composite`` module, or None (a tree before it)."""
    try:
        from acn_tpu_torch.ops import composite
    except ImportError:
        return None
    return composite


def bench_kernel(smi: str) -> None:
    from acn_tpu_torch import toy
    from acn_tpu_torch.ops import composite_bench as cb
    from acn_tpu_torch.ops import segscan

    comp = _composite()
    thre = float(toy.train_occ_config()[2].alpha_thre)
    for kind in cb.CHUNKS:
        sig, rgb, s, N, bg = cb.chunk(kind)
        got = comp.composite_kernel(sig, rgb, s, N, bg, thre)
        want = comp.composite_plain(sig, rgb, s, N, bg, thre, scan=segscan.seg_excl_sum_plain)
        row = {"chunk": kind, "alpha_thre": thre, "max_abs_err": cb.max_abs_err(got, want),
               "within_tol": cb.within_tol(got, want), "tol": cb.TOL,
               **cb.time_case(sig, rgb, s, N, bg, alpha_thre=thre)}
        print(json.dumps({**row, "nvidia_smi": smi}), flush=True)
        del sig, rgb, s, bg, got, want
        torch.cuda.empty_cache()


def bench_backward(smi: str) -> None:
    from acn_tpu_torch.ops import composite_bench as cb

    comp = _composite()
    if not hasattr(comp, "composite_backward_kernel"):
        print(json.dumps({"backward": None, "note": "this tree has no backward kernel",
                          "nvidia_smi": smi}), flush=True)
        return
    for kind in (*cb.TRAIN_CHUNKS, "dense"):
        sig, rgb, s, N, bg = cb.chunk(kind)
        acc = comp.composite_kernel(sig, rgb, s, N, bg, 0.0, False)[2]
        g = cb.cotangents(N)
        got = comp.composite_backward_kernel(sig, rgb, s, N, bg, 0.0, acc, *g)
        want = cb.backward_f64(sig, rgb, s, N, bg, 0.0, acc, g)
        row = {"shape": kind, "alpha_thre": 0.0, "grad_err": cb.grad_err(got, want),
               "within_tol": cb.grads_within_tol(got, want), "tol": cb.GRAD_TOL,
               **cb.time_backward_case(sig, rgb, s, N, bg)}
        print(json.dumps({**row, "nvidia_smi": smi}), flush=True)
        del sig, rgb, s, bg, got, want
        torch.cuda.empty_cache()


def bench_inplace(smi: str) -> None:
    from acn_tpu_torch.scripts import profile_step

    got = profile_step.run((4, 3, 1024, 512, 8), ("budget",), "cuda")
    print(json.dumps({"inplace": "budget", "kernel_us": got["kernel_us"]["budget"],
                      "composite_launches": got["composite_launches"]["budget"],
                      "busy_ms": got["busy_ms"]["budget"], "nvidia_smi": smi}), flush=True)


def _dev_us(e) -> float:
    return getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)


def _profile(fn, profile_dir: str, name: str) -> dict:
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
    (Path(profile_dir) / f"{name}_kernels.txt").write_text(
        avgs.table(sort_by="cuda_time_total", row_limit=45))

    def in_place(key):
        ev = [e for e in avgs if key in e.key]
        n = sum(e.count for e in ev)
        return {"launches": n, "mean_us": sum(_dev_us(e) for e in ev) / max(n, 1),
                "device_ms": 1e-3 * sum(_dev_us(e) for e in ev)}

    top = sorted((e for e in avgs if e.key != "cudaLaunchKernel"), key=lambda e: -_dev_us(e))
    return {"frame_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": sum(e.count for e in avgs if e.key == "cudaLaunchKernel"),
            "composite_kernel": in_place("composite_"),
            "scan_kernel": in_place("seg_scan_kernel"),
            "top_ops_device_ms": {e.key[:70]: 1e-3 * _dev_us(e) for e in top[:TOP_OPS]}}


def bench_frames(args, smi: str) -> None:
    from acn_tpu_torch import toy
    from acn_tpu_torch.ops import segscan
    from acn_tpu_torch.pipelines import baking
    from acn_tpu_torch.pipelines.renderer import Renderer

    comp = _composite()
    cfg, P, occ_cfg = toy.train_occ_config()
    torch.cuda.empty_cache()
    model = toy.serving_model(cfg, seed=0, device="cuda")
    boxes, _ = toy.quadrant_layout(cfg.num_submodules)
    occ = toy.random_occ_states(boxes, occ_cfg, fill=0.10, seed=0, device="cuda")
    renderer = Renderer(cfg, P, occ_cfg)
    cam = toy.overhead_camera(H, W)
    baked = {}

    def baked_frame(**kw):
        if "renderer" not in baked:
            t0 = time.perf_counter()
            asset = baking.bake_container(model, resolution=BAKE_RES)
            torch.cuda.synchronize()
            baked["bake_s"] = time.perf_counter() - t0
            baked["renderer"] = baking.BakedRenderer(
                asset, chunk_points=int(P.chunk_points), budget_per_ray=BAKED_BUDGET)
        return baked["renderer"].render_image(H=H, W=W, intrinsics=cam["intrinsics"],
                                              c2w=cam["c2w"], **kw)

    frames = {
        "dense": lambda: renderer.render_image(model, occ, H=H, W=W, download=False, **cam),
        "routed": lambda: renderer.render_image_routed(model, occ, H=H, W=W, download=False,
                                                       **cam),
        "baked_budget24": lambda: baked_frame(download=False),
    }
    for name, fn in frames.items():
        if name == "routed":
            with torch.no_grad():
                model.experts["sigma_head"]["b"].fill_(2.0)
        fn()  # warm
        torch.cuda.synchronize()
        segscan.seg_excl_sum_kernel.launches = 0
        if comp is not None:
            comp.zero_launch_counts()
        ms = []
        for _ in range(args.frames):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        row = {"frame": name, "H": H, "W": W, "frame_ms": ms,
               "mean_frame_ms": statistics.mean(ms),
               "composite_launches_per_frame": (None if comp is None
                                                else comp.launch_counts() / args.frames),
               "scan_launches_per_frame": segscan.seg_excl_sum_kernel.launches / args.frames,
               "tree": str(Path(sys.modules["acn_tpu_torch"].__file__).parent.parent)}
        if name.startswith("baked"):
            row.update(bake_resolution=BAKE_RES, bake_s=baked["bake_s"], budget=BAKED_BUDGET)
        if args.profile:
            row["profile"] = _profile(fn, args.profile, f"{name}_frame")
        print(json.dumps({**row, "nvidia_smi": smi}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", default="kernel,backward,frames")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--profile", default="", metavar="DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_composite: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    what = set(args.what.split(","))
    if "kernel" in what:
        bench_kernel(smi)
    if "backward" in what:
        bench_backward(smi)
    if "inplace" in what:
        bench_inplace(smi)
    if "frames" in what:
        bench_frames(args, smi)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
