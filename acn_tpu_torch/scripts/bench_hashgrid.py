"""Time the hash encode kernels (``csrc/hashgrid.cu``) on one CUDA card.

    python -m acn_tpu_torch.scripts.bench_hashgrid [--config smoke,l16f2]
    PYTHONPATH=<tree> python acn_tpu_torch/scripts/bench_hashgrid.py --no-plain

For each config (``smoke``: the smoke model's 8 levels of F = 4, 2^17 rows,
dense levels; ``l16f2``: the same at the parser's default 16 levels of
F = 2; ``f16``: the same at F = 16; ``l16f8``, ``l40f3`` and ``f1``: the
hash grids of ``toy.FLAG_SETS``, ``l40f3`` and ``f1`` the general and the
F = 1 forward), tables U(±1e-3) from seed 14, and each point set of
``ops/hashgrid_bench.py`` (random points at 983,040, 32,768 and 16,384;
the ray-ordered packed samples of a budget march at 983,040 and 32,768) in
float32 and bfloat16: one JSON line with the card time per call of the
forward and the cotangent kernels, their plain versions (unless
``--no-plain``) and the ``F.embedding_bag(mode="sum",
per_sample_weights=w)`` yardstick on indices 8·h + c (forward, and its
backward to the table), each a run of calls over copies of the inputs that
exceed the L2, between one pair of CUDA events; the wrappers' host time
per call (enqueue only); the byte bound. Then the card's ``nvidia-smi``
line.

To time another tree's kernels (an older commit, or this one with an
edited ``csrc/hashgrid.cu``), put that tree first on ``PYTHONPATH`` and run
this file; copy ``ops/hashgrid_bench.py`` into it if it has none.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from acn_tpu_torch.ops import hashgrid_bench as hb


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="smoke", help=f"comma-separated, of {hb.CONFIGS}")
    ap.add_argument("--sets", default="random,rays")
    ap.add_argument("--no-plain", action="store_true",
                    help="time the kernels alone (no plain versions, no yardstick)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_hashgrid: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    for name in args.config.split(","):
        hcfg = hb.hash_config(name)
        L, F = hcfg.levels, hcfg.features_per_level
        rows = [hcfg.level_rows(l) for l in range(L)]
        gen = torch.Generator(device="cuda").manual_seed(14)
        tables32 = [(torch.rand((r, 8 * F), generator=gen, device="cuda") * 2 - 1) * 1e-3
                    for r in rows]
        for set_name, P, x32, g32 in hb.point_sets(hcfg, args.sets.split(","), gen):
            for dt in (torch.float32, torch.bfloat16):
                x, g = x32.to(dt), g32.to(dt)
                tables = [t.to(dt) for t in tables32]
                row = {"config": name, "set": set_name, "P": P,
                       "dtype": str(dt).split(".")[-1],
                       "zero_cotangent_rows": int((g32 == 0).all(dim=1).sum()),
                       **hb.time_kernels(tables, x, g, hcfg, rows, plain=not args.no_plain),
                       "nvidia_smi": smi}
                print(json.dumps(row), flush=True)
                del tables
                torch.cuda.empty_cache()
        del tables32
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
