"""Summarize a training/eval run directory from its log.txt.

    python -m acn_tpu_torch.scripts.summarize_run logs/<run> [more dirs...]
    python -m acn_tpu_torch.scripts.summarize_run --json logs/<run>

Port of ``acn_tpu/scripts/summarize_run.py``, copied (standard library
only): the step trajectory (loss, psnr_in/out, s/it, rays/s), the eval-PSNR
trajectory, the final and best numbers, and the eval op's TTO summary rows.
The parsed line formats are the loop's (``pipelines/offline_stage/
trainer.py`` step lines, ``[eval] step N query PSNR x``) and
``runner.op_eval``'s summary rows, the same in both packages.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

STEP_RE = re.compile(
    r"step (\d+)/(\d+) loss: ([\d.eE+-]+) \(([\d.eE+-]+)\)\s+"
    r"psnr_in: ([\d.eE+-]+) \(([\d.eE+-]+)\)\s+"
    r"psnr_out: ([\d.eE+-]+) \(([\d.eE+-]+)\) \| ([\d.]+)s/it "
    r"\(([\d,]+) rays/s\)"
)
EVAL_RE = re.compile(r"\[eval\] step (\d+) query PSNR ([\d.eE+-]+)")
TTO_ROW_RE = re.compile(
    r"^\s*(\d+)\s+([\d.]+|nan)\s+([\d.]+|nan)\s+([\d.]+|nan)\s+([\d.]+)\s*$"
)
DONE_RE = re.compile(r"training complete at step (\d+); best eval PSNR (\S+)")


def parse_log(path: Path) -> dict:
    steps, evals, tto_rows, done = [], [], [], None
    for raw in path.read_text(errors="replace").splitlines():
        # strip the "[yy-mm-dd hh:mm:ss] " prefix if present
        line = raw[raw.index("] ") + 2:] if raw.startswith("[") and "] " in raw else raw
        if m := STEP_RE.search(line):
            steps.append({
                "step": int(m[1]), "of": int(m[2]),
                "loss": float(m[3]), "loss_avg": float(m[4]),
                "psnr_in": float(m[5]), "psnr_in_avg": float(m[6]),
                "psnr_out": float(m[7]), "psnr_out_avg": float(m[8]),
                "s_per_it": float(m[9]),
                "rays_per_s": int(m[10].replace(",", "")),
            })
        elif m := EVAL_RE.search(line):
            evals.append({"step": int(m[1]), "psnr": float(m[2])})
        elif m := TTO_ROW_RE.match(line):
            tto_rows.append({
                "tto": int(m[1]), "psnr": float(m[2]), "ssim": float(m[3]),
                "lpips": float(m[4]), "duration": float(m[5]),
            })
        elif m := DONE_RE.search(line):
            done = {"final_step": int(m[1]), "best_eval_psnr": m[2]}
    out = {"steps": steps, "evals": evals, "tto": tto_rows, "done": done}
    if steps:
        mid = steps[len(steps) // 2:]  # skip compile-skewed early s/it
        out["median_s_per_it"] = sorted(s["s_per_it"] for s in mid)[len(mid) // 2]
        out["last"] = steps[-1]
    if evals:
        out["best_eval"] = max(evals, key=lambda e: e["psnr"])
        out["last_eval"] = evals[-1]
    return out


def render_text(name: str, s: dict) -> str:
    lines = [f"== {name} =="]
    if s.get("last"):
        l = s["last"]
        lines.append(
            f"  steps: {l['step']}/{l['of']}  loss {l['loss_avg']:.4f}  "
            f"psnr_out {l['psnr_out_avg']:.2f}  "
            f"median {s['median_s_per_it']:.2f} s/it "
            f"({l['rays_per_s']:,} rays/s last)"
        )
    if s.get("evals"):
        traj = "  ".join(f"{e['step']}:{e['psnr']:.2f}" for e in s["evals"][-8:])
        lines.append(f"  eval PSNR (last 8): {traj}")
        lines.append(
            f"  best eval: {s['best_eval']['psnr']:.3f} @ step "
            f"{s['best_eval']['step']}"
        )
    for r in s.get("tto", []):
        lines.append(
            f"  tto {r['tto']:>4}: psnr {r['psnr']:.3f}  ssim {r['ssim']:.4f}"
            f"  lpips {r['lpips']}  ({r['duration']:.0f}s)"
        )
    if s.get("done"):
        lines.append(f"  {s['done']}")
    if len(lines) == 1:
        lines.append("  (no recognized lines)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", nargs="+", help="run dirs (or log.txt paths)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    blob = {}
    for r in args.runs:
        p = Path(r)
        log = p if p.is_file() else p / "log.txt"
        if not log.exists():
            print(f"== {r} ==\n  (no log.txt)", file=sys.stderr)
            continue
        s = parse_log(log)
        blob[str(r)] = s
        if not args.json:
            print(render_text(str(r), s))
    if args.json:
        print(json.dumps(blob))
    return 0


if __name__ == "__main__":
    sys.exit(main())
