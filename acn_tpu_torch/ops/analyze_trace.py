"""Sum a ``torch.profiler`` Chrome trace's device time by op category.

    python -m acn_tpu_torch.ops.analyze_trace <trace dir or file> [--top 30]

The counterpart of ``acn_tpu/ops/analyze_trace.py``, which reads an XPlane
trace: this reads the Chrome trace that ``torch.profiler``'s
``export_chrome_trace`` writes (``ops/bench_step_breakdown.py --profile
DIR`` writes ``DIR/full_step.trace.json``; ``.json.gz`` is read too), the
newest under the directory. It keeps the device's events (kernels, copies
and memsets: categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``), sums
their durations by category (``CATEGORY_RULES``: ``acn_tpu``'s rules for XLA
op names, then the names CUDA kernels carry; the first rule that matches
decides, else "other") and by op group (a kernel's name without its
template and argument lists), and prints both. It also gives the device's
busy time, the union of the events' intervals: on one stream it equals the
sum of the categories. Host work only; no card needed.
"""

from __future__ import annotations

import argparse
import gzip
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

CATEGORY_RULES = [
    # acn_tpu's rules (XLA op names)
    (r"gather", "gather"),
    (r"scatter", "scatter"),
    (r"dot|conv", "matmul"),
    (r"all-reduce|all-gather|reduce-scatter|collective", "collective"),
    (r"copy|transpose|bitcast|reshape", "copy/layout"),
    (r"sort", "sort"),
    (r"cumsum|reduce-window|scan", "scan/cumsum"),
    (r"rng|random", "rng"),
    (r"fusion", "fusion(elementwise)"),
    (r"infeed|outfeed|host", "host-transfer"),
    # the names of CUDA kernels
    (r"index_add|indexfunc", "scatter"),
    (r"index_select|indexselect", "gather"),
    (r"gemm|sm90", "matmul"),
    (r"memcpy", "copy/layout"),
    (r"nccl", "collective"),
    (r"seg_excl", "scan/cumsum"),
    (r"elementwise|vectorized", "fusion(elementwise)"),
]


def categorize(name: str) -> str:
    low = name.lower()
    for pat, cat in CATEGORY_RULES:
        if re.search(pat, low):
            return cat
    return "other"


def op_group(name: str) -> str:
    """A kernel's name without ``void``, its template and its arguments."""
    base = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return base[5:] if base.startswith("void ") else base


def find_trace(path) -> Path:
    p = Path(path)
    if p.is_file():
        return p
    found = sorted((q for q in p.rglob("*") if q.name.endswith((".json", ".json.gz"))),
                   key=lambda q: q.stat().st_mtime)
    if not found:
        raise FileNotFoundError(f"no Chrome trace (*.json, *.json.gz) under {path}")
    return found[-1]


def load_events(path: Path) -> list:
    opener = gzip.open if path.name.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def summarize(path) -> Dict:
    """{"trace", "events", "device_s" (summed durations), "busy_s" (union of
    the intervals), "by_category" and "by_group" (seconds)} of the trace's
    device events. Raises when the trace holds none (a CPU-only profile)."""
    trace = find_trace(path)
    events = [e for e in load_events(trace)
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    if not events:
        raise ValueError(f"{trace} holds no device events (kernels, copies, memsets)")
    by_cat, by_group = defaultdict(float), defaultdict(float)
    for e in events:
        dur = float(e.get("dur", 0.0)) * 1e-6  # µs → s
        by_cat[categorize(e["name"])] += dur
        by_group[op_group(e["name"])] += dur
    busy, end = 0.0, float("-inf")
    for ts, dur in sorted((float(e["ts"]), float(e.get("dur", 0.0))) for e in events):
        if ts + dur > end:
            busy += ts + dur - max(ts, end)
            end = ts + dur
    return {"trace": str(trace), "events": len(events),
            "device_s": sum(by_cat.values()), "busy_s": busy * 1e-6,
            "by_category": dict(by_cat), "by_group": dict(by_group)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)

    s = summarize(args.trace_dir)
    total = s["device_s"]
    print(f"trace: {s['trace']}")
    print(f"device events: {s['events']}; busy {s['busy_s']:.6f} s")
    print(f"\n=== time by category (total {total:.6f} s of device op time) ===")
    for cat, t in sorted(s["by_category"].items(), key=lambda kv: -kv[1]):
        print(f"{cat:>22}: {t:10.6f} s  ({100 * t / max(total, 1e-12):5.1f}%)")
    print(f"\n=== top {args.top} op groups ===")
    for name, t in sorted(s["by_group"].items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"{t:10.6f} s  {name}")
    return s


if __name__ == "__main__":
    main()
