"""Meta-training throughput of the port, the counterpart of ``bench.py``.

    python -m acn_tpu_torch.scripts.bench_train
        [--scale K,T,S,Q,INNER,ITERS] [--regimes stratified,occ,budget,auto]
        [--device cuda]

Runs the FoMAML meta-train step (``make_meta_train_step``) of
``toy.bench_problem`` (K experts, 8 × 4 cell-layout hash grid of 2^16 rows)
on ``toy.training_batch``, at ``bench.py``'s scale unless ``--scale`` cuts
it: K 4, T 3, S 4,000, Q 2,000, 8 inner steps; one warm step, then ITERS
(5) timed steps, the card synchronized before and after. The regimes:

* ``stratified``: 96 samples per ray (the warm-up);
* ``occ``: the strided per-ray march, 256 bins → 64 kept, on 10 % random
  128³ grids;
* ``budget``: the packed march with 32 samples per ray on those grids;
* ``auto``: strided with ``report_budget`` 32 (the steps before the auto
  switch).

Prints one JSON line with ``bench.py``'s keys (a ray render is one ray
sampled and composited, forward and backward, inner and query passes
counted: K·T·(INNER·S + Q) per step). A regime not asked for is ``null``;
a regime that fails raises. ``device`` is the card's ``nvidia-smi`` name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from acn_tpu_torch import toy
from acn_tpu_torch.pipelines.offline_stage.train_step import make_meta_train_step
from acn_tpu_torch.pipelines.offline_stage.trainer import dummy_occ_states
from acn_tpu_torch.pipelines.renderer import resolve_device

REFERENCE_RAYS_PER_SEC_ESTIMATE = 300_000.0  # bench.py's provisional baseline
REGIMES = ("stratified", "occ", "budget", "auto")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_step(step_fn, state, batch, occ, iters: int, device) -> float:
    """Seconds per step: one warm step, then ``iters`` timed."""
    gen = torch.Generator(device=device).manual_seed(0)
    state, metrics = step_fn(state, batch, occ, gen)
    float(metrics["loss_total"])
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step_fn(state, batch, occ, gen)
    float(metrics["loss_total"])
    _sync(device)
    return (time.perf_counter() - t0) / iters


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return (out.stdout.strip().splitlines() or [torch.cuda.get_device_name(device)])[0]


def run(scale=(4, 3, 4000, 2000, 8, 5), regimes=REGIMES, device=None) -> dict:
    device = resolve_device(device)
    K, T, S, Q, inner, iters = scale
    unknown = set(regimes) - set(REGIMES)
    if unknown:
        raise ValueError(f"unknown regimes {sorted(unknown)}; known: {REGIMES}")
    occ_cfg = toy.bench_occ_config()
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in toy.training_batch(K, T, S, Q, seed=0).items()}
    occ10 = toy.random_occ_states(np.stack([toy.SCENE_AABB] * K), occ_cfg, fill=0.10,
                                  seed=0, device=device)
    rays_per_step = K * T * (inner * S + Q)
    setups = {  # regime → (P overrides, occ_cfg, report budget, occ states)
        "stratified": ({}, None, 0, dummy_occ_states(K, device)),
        "occ": ({}, occ_cfg, 0, occ10),
        "budget": ({"occ_budget_per_ray": 32}, occ_cfg, 0, occ10),
        "auto": ({}, occ_cfg, 32, occ10),
    }
    step_s = {}
    for name in REGIMES:
        if name not in regimes:
            continue
        over, oc, report, occ = setups[name]
        P_r = toy.bench_params(inner_iter=inner, **over)
        model = toy.bench_problem(K, device=device)
        opt, state = toy.init_train_state(model, P_r)
        step_fn = make_meta_train_step(model.cfg, P_r, opt, oc, report_budget=report,
                                       device=device)
        step_s[name] = bench_step(step_fn, state, batch, occ, iters, device)
        del model, opt, state, step_fn
    rps = {k: rays_per_step / v for k, v in step_s.items()}
    measured = [rps[k] for k in ("occ", "budget") if k in rps]
    best = max(measured) if measured else None
    return {
        "metric": "meta_train_ray_renders_per_sec_occ",
        "value": best,
        "unit": "rays/s",
        "vs_baseline": None if best is None else best / REFERENCE_RAYS_PER_SEC_ESTIMATE,
        "stratified_rays_per_sec": rps.get("stratified"),
        "occ_per_ray_rays_per_sec": rps.get("occ"),
        "occ_budget_rays_per_sec": rps.get("budget"),
        "occ_auto_premeasure_rays_per_sec": rps.get("auto"),
        "occ_step_s": step_s.get("occ"),
        "occ_budget_step_s": step_s.get("budget"),
        "occ_auto_premeasure_step_s": step_s.get("auto"),
        "stratified_step_s": step_s.get("stratified"),
        "device": _card(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", default="4,3,4000,2000,8,5", help="K,T,S,Q,INNER,ITERS")
    ap.add_argument("--regimes", default=",".join(REGIMES))
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    scale = tuple(int(v) for v in args.scale.split(","))
    if len(scale) != 6:
        ap.error("--scale takes six integers K,T,S,Q,INNER,ITERS")
    out = run(scale, tuple(r for r in args.regimes.split(",") if r), args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
