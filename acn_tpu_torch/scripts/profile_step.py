"""What one meta-training step asks of the host and the card, by regime,
under ``torch.profiler``: the step is bound by the host's dispatch, so the
counts decide where timings between runs drift too much to compare.

    python -m acn_tpu_torch.scripts.profile_step
        [--scale K,T,S,Q,INNER] [--regimes stratified,occ,budget] [--device cuda]

Builds the step as ``bench_train`` does (``toy.bench_problem``, FoMAML,
the same regimes and grids; its own copy of that set-up, so that the
script also profiles an older tree's package, put first on
``PYTHONPATH``), runs one warm step, then profiles one more, forward and
backward. Prints one JSON line with, by regime:

* ``aten_events``: ATen ops the profiler recorded, nested calls included;
* ``kernel_launches``: ``cudaLaunchKernel`` calls (null on the CPU);
* ``busy_ms``: the card's kernel and copy time (null on the CPU).

The profiler observes the dispatcher without changing it (a
``TorchDispatchMode`` would: under one, torch's composite backward
formulas, cumprod's among them, take their slow general paths). The counts
depend on K, T, INNER, the regime and the device, and hardly on the ray
counts S and Q (every op covers all rays of a loss). ``device`` is the
card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from acn_tpu_torch import toy
from acn_tpu_torch.pipelines.offline_stage.train_step import make_meta_train_step
from acn_tpu_torch.pipelines.offline_stage.trainer import dummy_occ_states
from acn_tpu_torch.pipelines.renderer import resolve_device
from acn_tpu_torch.scripts.bench_train import _card, _sync

REGIMES = ("stratified", "occ", "budget")


def run(scale=(4, 3, 64, 32, 8), regimes=REGIMES, device=None) -> dict:
    device = resolve_device(device)
    K, T, S, Q, inner = scale
    unknown = set(regimes) - set(REGIMES)
    if unknown:
        raise ValueError(f"unknown regimes {sorted(unknown)}; known: {REGIMES}")
    occ_cfg = toy.bench_occ_config()
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in toy.training_batch(K, T, S, Q, seed=0).items()}
    occ10 = toy.random_occ_states(np.stack([toy.SCENE_AABB] * K), occ_cfg, fill=0.10,
                                  seed=0, device=device)
    setups = {  # regime → (P overrides, occ_cfg, occ states), as bench_train's
        "stratified": ({}, None, dummy_occ_states(K, device)),
        "occ": ({}, occ_cfg, occ10),
        "budget": ({"occ_budget_per_ray": 32}, occ_cfg, occ10),
    }
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = {"aten_events": {}, "kernel_launches": {}, "busy_ms": {}}
    for name in REGIMES:
        if name not in regimes:
            continue
        over, oc, occ = setups[name]
        P_r = toy.bench_params(inner_iter=inner, **over)
        model = toy.bench_problem(K, device=device)
        opt, state = toy.init_train_state(model, P_r)
        step_fn = make_meta_train_step(model.cfg, P_r, opt, oc, device=device)
        gen = torch.Generator(device=device).manual_seed(0)
        state, metrics = step_fn(state, batch, occ, gen)  # warm
        float(metrics["loss_total"])
        _sync(device)
        with profile(activities=activities) as prof:
            state, metrics = step_fn(state, batch, occ, gen)
            float(metrics["loss_total"])
            _sync(device)
        avgs = prof.key_averages()
        out["aten_events"][name] = sum(e.count for e in avgs if e.key.startswith("aten::"))
        out["kernel_launches"][name] = (
            sum(e.count for e in avgs if e.key == "cudaLaunchKernel") if cuda else None)
        out["busy_ms"][name] = (
            1e-3 * sum(e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == DeviceType.CUDA) if cuda else None)
        del model, opt, state, step_fn, prof
    return {**out, "scale": list(scale), "device": _card(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", default="4,3,64,32,8", help="K,T,S,Q,INNER")
    ap.add_argument("--regimes", default=",".join(REGIMES))
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    scale = tuple(int(v) for v in args.scale.split(","))
    if len(scale) != 5:
        ap.error("--scale takes five integers K,T,S,Q,INNER")
    out = run(scale, tuple(r for r in args.regimes.split(",") if r), args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
