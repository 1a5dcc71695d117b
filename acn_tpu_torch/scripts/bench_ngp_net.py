"""Time the NGP network kernel (``csrc/ngp_net.cu``) and the frames it
serves, on one CUDA card.

    python -m acn_tpu_torch.scripts.bench_ngp_net [--what kernel,frames]
        [--config NAME[,NAME]] [--no-plain] [--frames 3] [--profile DIR]
    PYTHONPATH=<tree> python acn_tpu_torch/scripts/bench_ngp_net.py

``kernel``: for each mode (``single``, ``sigma_blend``, ``linear_blend``,
``density``), point set (``random``, ``rays``) and P (983,040, a dense
serving chunk; 32,768, a support march) of ``ops/ngp_net_bench.py``, and
``single`` at 4,000,000 (a routed chunk): one JSON line with the card time
per call of the kernel, of the plain network (unless ``--no-plain``) and
of the chain of cuBLAS ``mm`` calls the plain network issues (the nearest
library figure: no single PyTorch call computes the network), each a run
of calls between one pair of CUDA events (the ``mm`` chain also with TF32
allowed, then restored); the kernel's host µs per call; the bounds (the
kernel's 3xTF32 operations at 495 TFLOP/s, the same flops at 67 TFLOP/s
f32 beside them, bytes at 3.35 TB/s). With ``--config`` (names of
``toy.FLAG_SETS``, as phase 15 of ``chip_smoke.py`` takes them): each named
configuration's experts instead, every mode on the random points of a
dense chunk (983,040), the lines carrying ``config``; ``wide`` takes the
kernel's wide path.

``frames``: the smoke's scene (``configs/train_occ.json``'s model from
seed 0, toy's 10 % grids, its overhead camera) at 1080 × 1920: a warm and
``--frames`` timed dense frames (``render_image``, the packed budget march
of 32 samples a ray, the soft-MoE blend), then the σ-head bias set to +2
(as ``chip_smoke.py`` phase 4 leaves it) and a warm and ``--frames`` timed
routed frames (``render_image_routed``: each expert its own rectangle);
ms per frame, the kernel's launches per frame. With ``--config``: each
named configuration's dense frame as phase 16 of ``chip_smoke.py`` renders
it (``toy.flag_config``, seed 16, ``toy.expert_layout``; 480 × 853 for
``wide``, 270 × 1920 for ``k25``, else 1080 × 1920). With ``--profile DIR`` one
more frame of each under ``torch.profiler``: its busy and idle share, its
kernel launches, the device time of the top ops and of the network
kernel, the tables in DIR.

With another tree first on ``PYTHONPATH`` (the parent commit), this file
times that tree: its plain network, and its frames; the kernel only where
the tree has ``ops/ngp_net.py``. To compare two trees, run ``--what
frames`` from each in turns in one call (parent, this, this, parent).
Every line carries the card's ``nvidia-smi`` name and power limit.
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


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def _net():
    """The tree's ``ops/ngp_net`` module, or None (a tree before it)."""
    try:
        from acn_tpu_torch.ops import ngp_net
    except ImportError:
        return None
    return ngp_net


def bench_kernel(args, smi: str) -> None:
    from acn_tpu_torch.ops import ngp_net_bench as nb

    net = _net()
    gen = torch.Generator(device="cuda").manual_seed(15)
    kernel = None if net is None else net.ngp_net_kernel
    if args.config:
        for name in args.config.split(","):
            cfg, ecfg = nb.config(name)
            experts = nb.net_params(ecfg, cfg.num_submodules, seed=15)
            ins = nb.inputs("random", nb.SIZES[0], cfg.num_submodules, gen, name)
            for mode in nb.MODES:
                row = nb.time_case(mode, "random", nb.SIZES[0], gen, experts,
                                   plain=not args.no_plain, kernel=kernel, ins=ins, name=name)
                print(json.dumps({**row, "config": name, "nvidia_smi": smi}), flush=True)
            del ins, experts
            torch.cuda.empty_cache()
        return
    _, ecfg = nb.config()
    experts = nb.net_params(ecfg, 4, seed=15)
    cases = [(m, s, P) for m in nb.MODES for s in nb.SETS for P in nb.SIZES]
    cases.append(("single", "random", nb.ROUTED_P))
    for mode, set_name, P in cases:
        row = nb.time_case(mode, set_name, P, gen, experts, plain=not args.no_plain,
                           kernel=kernel)
        print(json.dumps({**row, "nvidia_smi": smi}), flush=True)
        torch.cuda.empty_cache()


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
    dev_us = lambda e: getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
    net = [e for e in avgs if "ngp_net_kernel" in e.key]
    net_us, net_n = sum(dev_us(e) for e in net), sum(e.count for e in net)
    top = sorted(avgs, key=lambda e: -dev_us(e))[:14]
    return {"frame_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": sum(e.count for e in avgs if e.key == "cudaLaunchKernel"),
            "ngp_net_kernel": {"launches": net_n, "mean_us": net_us / max(net_n, 1),
                               "share_of_busy": 1e-3 * net_us / max(busy_ms, 1e-9)},
            "top_ops_device_ms": {e.key[:60]: 1e-3 * dev_us(e) for e in top}}


def bench_frames(args, smi: str) -> None:
    from acn_tpu_torch import toy
    from acn_tpu_torch.pipelines.renderer import Renderer

    net = _net()
    H, W = 1080, 1920
    cfg, P, occ_cfg = toy.train_occ_config()
    torch.cuda.empty_cache()
    if args.config:  # one named configuration's dense frame, as phase 16 renders it
        name = args.config.split(",")[0]
        cfg = toy.flag_config(cfg, **toy.FLAG_SETS[name])
        H, W = toy.FLAG_FRAMES.get(name, (H, W))
        model = toy.serving_model(cfg, seed=16, device="cuda")
        boxes, _ = toy.expert_layout(cfg.num_submodules)
    else:
        model = toy.serving_model(cfg, seed=0, device="cuda")
        boxes, _ = toy.quadrant_layout(cfg.num_submodules)
    occ = toy.random_occ_states(boxes, occ_cfg, fill=0.10, seed=0, device="cuda")
    renderer = Renderer(cfg, P, occ_cfg)
    cam = toy.overhead_camera(H, W)
    frames = {
        "dense": lambda: renderer.render_image(model, occ, H=H, W=W, download=False, **cam),
        "routed": lambda: renderer.render_image_routed(model, occ, H=H, W=W, download=False,
                                                       **cam),
    }
    if args.config:
        del frames["routed"]
    for name, fn in frames.items():
        if name == "routed":
            with torch.no_grad():
                model.experts["sigma_head"]["b"].fill_(2.0)
        fn()  # warm
        torch.cuda.synchronize()
        if net is not None:
            net.zero_launch_counts()
        ms = []
        for _ in range(args.frames):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        row = {"frame": name, "config": args.config.split(",")[0] or "smoke", "H": H, "W": W,
               "frame_ms": ms,
               "mean_frame_ms": statistics.mean(ms),
               "ngp_net_launches_per_frame": (None if net is None
                                              else net.launch_counts() / args.frames),
               "tree": str(Path(sys.modules["acn_tpu_torch"].__file__).parent.parent)}
        if args.profile:
            row["profile"] = _profile(fn, args.profile, f"{name}_frame")
        print(json.dumps({**row, "nvidia_smi": smi}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", default="kernel,frames")
    ap.add_argument("--no-plain", action="store_true",
                    help="time the kernel alone (no plain network, no mm chain)")
    ap.add_argument("--config", default="", help="names of toy.FLAG_SETS (module docstring)")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--profile", default="", metavar="DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_ngp_net: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    what = set(args.what.split(","))
    if "kernel" in what:
        bench_kernel(args, smi)
    if "frames" in what:
        bench_frames(args, smi)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
