"""Where the time of one FoMAML meta-training step goes.

    python -m acn_tpu_torch.ops.bench_step_breakdown [--scale K,T,S,Q,INNER]
        [--iters 4] [--profile DIR] [--device cuda]

Port of ``acn_tpu/ops/bench_step_breakdown.py``. On ``toy.bench_problem``
(``bench.py``'s model: K experts, a cell-layout hash grid of 8 × 4 with
2^16 rows, 64-wide MLPs) at ``bench.py``'s scale (K 4, T 3, S 4,000, Q
2,000, 8 inner steps, bf16, 256 bins → 64 kept samples, strided on 10 %
random 128³ grids, the "occ" regime) it times the step and its parts:

  full_step       the whole step (``make_meta_train_step``)
  march           the strided march of one episode's support rays
  episode_fwd     one episode loss, forward (S rays on those samples)
  episode_grad    one episode loss, forward and backward (the inner unit)
  episode_grad_K  K experts' marches and episode gradients, one after
                  another (the step runs its experts in turn)
  hash_fwd        the hash encode alone at the episode's point count (bf16)
  hash_grad       the hash encode forward and backward
  expert_grad     one expert's network (hash + MLPs) forward and backward
  opt_update      one outer Adam update over the whole parameter tree

and prints the predicted step (units × ``episode_grad_K`` + ``opt_update``,
with T·(INNER + 1) units) against the measured one, and the hash encode's
rows per second. Every time is wall time per call with the card synchronized
after the calls, not device time: the step is bound by the host's dispatch
of small kernels, so a part's device time alone would understate it.
``--profile DIR`` writes a ``torch.profiler`` Chrome trace of one full step
to ``DIR/full_step.trace.json`` (read it with ``ops/analyze_trace.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from acn_tpu_torch import toy
from acn_tpu_torch.models.encodings import hash_encode
from acn_tpu_torch.models.ngp import ngp_forward
from acn_tpu_torch.models.nn import tree_cast, tree_leaves, tree_map
from acn_tpu_torch.occupancy import grid as occ_grid
from acn_tpu_torch.pipelines.offline_stage.train_step import (
    make_episode_loss,
    make_meta_train_step,
)
from acn_tpu_torch.pipelines.renderer import resolve_device
from acn_tpu_torch.scripts.bench_train import _card, _sync

PARTS = ("full_step", "march", "episode_fwd", "episode_grad", "episode_grad_K",
         "hash_fwd", "hash_grad", "expert_grad", "opt_update")


def _time(fn, iters: int, device) -> float:
    """Seconds per call: one warm call, then ``iters`` calls, the card
    synchronized before and after them."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def _grads(loss, params) -> list:
    return torch.autograd.grad(loss, tree_leaves(params))


def run(scale=(4, 3, 4000, 2000, 8), iters: int = 4, device=None, profile=None) -> dict:
    device = resolve_device(device)
    K, T, S, Q, inner = scale
    P = toy.bench_params(inner_iter=inner)
    occ_cfg = toy.bench_occ_config()
    model = toy.bench_problem(K, device=device)
    opt, state = toy.init_train_state(model, P)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in toy.training_batch(K, T, S, Q, seed=0).items()}
    occ = toy.random_occ_states(np.stack([toy.SCENE_AABB] * K), occ_cfg, fill=0.10,
                                seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    res = {}

    step_fn = make_meta_train_step(model.cfg, P, opt, occ_cfg, device=device)

    def full_step():
        nonlocal state
        state, metrics = step_fn(state, batch, occ, gen)
        return float(metrics["loss_total"])

    res["full_step"] = _time(full_step, iters, device)
    trace = None
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with torch_profile(activities=acts) as prof:
            full_step()
            _sync(device)
        Path(profile).mkdir(parents=True, exist_ok=True)
        trace = Path(profile) / "full_step.trace.json"
        prof.export_chrome_trace(str(trace))

    # the parts, on expert 0 and the first task
    loss_fn, prepare = make_episode_loss(model.cfg, P, occ_cfg)
    e0, bg = model.expert(0), model.params().get("bg_mlp")
    aabbs = model.expert_aabbs
    occ_k = lambda k: {n: v[k] for n, v in occ.items()}
    sr, sg = batch["support_rays"][0, 0], batch["support_rgbs"][0, 0]
    draws = occ_grid.draw_march(S, int(P.occ_s_max), gen)
    res["march"] = _time(lambda: prepare(occ_k(0), sr, draws)["positions"], iters, device)
    smp = prepare(occ_k(0), sr, draws)
    with torch.no_grad():
        res["episode_fwd"] = _time(lambda: loss_fn(e0, bg, aabbs[0], sr, sg, smp),
                                   iters, device)
    res["episode_grad"] = _time(
        lambda: _grads(loss_fn(e0, bg, aabbs[0], sr, sg, smp), [e0, bg]), iters, device)

    def grad_K():
        for k in range(K):
            r, g = batch["support_rays"][k, 0], batch["support_rgbs"][k, 0]
            s = prepare(occ_k(k), r, occ_grid.draw_march(S, int(P.occ_s_max), gen))
            ek = model.expert(k)
            _grads(loss_fn(ek, bg, aabbs[k], r, g, s), [ek, bg])

    res["episode_grad_K"] = _time(grad_K, iters, device)

    hash_cfg = model.cfg.expert.hash
    n_pts = S * int(P.occ_s_kept)
    rng = np.random.default_rng(0)
    x01 = torch.from_numpy(rng.uniform(0, 1, (n_pts, 3)).astype(np.float32)).to(device)
    tables = tree_cast(e0["hash_table"], torch.bfloat16)
    with torch.no_grad():
        res["hash_fwd"] = _time(lambda: hash_encode(tables, x01, hash_cfg).sum(), iters,
                                device)
    tables_g = tree_map(lambda t: t.detach().requires_grad_(True), tables)
    res["hash_grad"] = _time(
        lambda: _grads(hash_encode(tables_g, x01, hash_cfg).float().sum(), tables_g),
        iters, device)
    xd = torch.cat([x01 * 2.0 - 1.0,
                    torch.tensor([0.0, 0.0, -1.0], device=device).expand(n_pts, 3)], -1)
    res["expert_grad"] = _time(
        lambda: _grads(ngp_forward(e0, model.cfg.expert, aabbs[0], xd).sum(), e0),
        iters, device)

    params = model.params()
    zeros = tree_map(torch.zeros_like, params)
    res["opt_update"] = _time(lambda: opt.update(zeros, state["opt_state"], params),
                              iters, device)

    n_units = T * inner + T
    predicted = n_units * res["episode_grad_K"] + res["opt_update"]
    rows = n_pts * hash_cfg.levels
    return {"ms": {k: res[k] * 1e3 for k in PARTS},
            "units": n_units, "predicted_step_ms": predicted * 1e3,
            "measured_step_ms": res["full_step"] * 1e3,
            "slack": res["full_step"] / predicted,
            "hash_rows_per_episode": rows,
            "hash_fwd_Mrows_per_s": rows / res["hash_fwd"] / 1e6,
            "hash_grad_Mrows_per_s": 3 * rows / res["hash_grad"] / 1e6,
            "timing": "wall time per call, card synchronized after the calls",
            "trace": None if trace is None else str(trace),
            "scale": list(scale), "iters": iters, "device": _card(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", default="4,3,4000,2000,8", help="K,T,S,Q,INNER")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a Chrome trace of one full step here")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    scale = tuple(int(v) for v in args.scale.split(","))
    if len(scale) != 5:
        ap.error("--scale takes five integers K,T,S,Q,INNER")
    out = run(scale, args.iters, args.device, args.profile)
    print(f"\n=== occ meta-step decomposition ({out['device']}; {out['timing']}) ===")
    for k in PARTS:
        print(f"{k:>14}: {out['ms'][k]:10.1f} ms")
    print(f"\nper-episode hash rows (S·s_kept·L): {out['hash_rows_per_episode'] / 1e6:.1f} M")
    print(f"hash_fwd gather rate: {out['hash_fwd_Mrows_per_s']:8.1f} M rows/s")
    print(f"hash_grad row rate (3× rows: fwd + re-gather + scatter): "
          f"{out['hash_grad_Mrows_per_s']:8.1f} M rows/s")
    print(f"\npredicted step ({out['units']} units × episode_grad_K + opt_update): "
          f"{out['predicted_step_ms'] / 1e3:.2f} s")
    print(f"measured  step: {out['measured_step_ms'] / 1e3:.2f} s (slack ×{out['slack']:.2f})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
