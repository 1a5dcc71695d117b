"""Choose the scan kernel's tile by measurement, on one CUDA card.

    python -m acn_tpu_torch.scripts.bench_segscan
    python -m acn_tpu_torch.scripts.bench_segscan --variants 256x16,512x8 --acq_rel

Builds ``csrc/segscan.cu`` once per variant (threads × elements per thread,
``-DSEGSCAN_THREADS`` / ``-DSEGSCAN_ITEMS``; with ``--acq_rel`` also each
variant with release/acquire accesses to the tile states), checks every
build against the plain version, forward and reverse, on a ragged buffer, on
one segment over many tiles and at the serving shape, and times it at
1×, 4× and 16× the serving chunk (CUDA events, median of 100 launches with
the card kept busy, warm L2; [forward, reverse] µs per layout of segments;
``forward_in_a_row_us`` is the time per launch
when ten launches run between one pair of events, which leaves the events'
own cost out). Prints ptxas's registers and spills and one JSON line per
variant, then the card's ``nvidia-smi`` line. The port itself
always runs the source's default variant.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys

import torch

from acn_tpu_torch.ops import cuda_lib, segscan

SERVING_B = 983_040  # packed samples per 1080p chunk (30,720 rays × 32)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
EPS32 = float(torch.finfo(torch.float32).eps)


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` calls, by CUDA events.
    A spin kernel queued first keeps the card busy while the host enqueues
    every call, so host overhead between calls is not counted."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def random_case(n: int, mean_len: float, seed: int, pad_tail: float = 0.0):
    """x f32 (n,), starts bool (n,) on the card: segments of about
    ``mean_len`` elements (one segment when it is 0); the last ``pad_tail``
    share of the buffer is one more segment, as the pad slots that end a
    serving chunk are."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=g, device="cuda")
    if mean_len:
        s = torch.rand(n, generator=g, device="cuda") < 1.0 / mean_len
    else:
        s = torch.zeros(n, dtype=torch.bool, device="cuda")
    if pad_tail:
        s[n - int(pad_tail * n):] = False
        s[n - int(pad_tail * n)] = True
    s[0] = True
    return x, s


def agrees(got, want, x, starts) -> bool:
    """Every element within 32 ulp of its own segment's |x| sum plus 1e-6
    of |want| (the kernel and the plain version add in different orders)."""
    seg = torch.cumsum(starts, 0) - 1
    mass = torch.zeros(int(seg[-1]) + 1, device=x.device).index_add_(0, seg, x.abs())
    tol = 32 * EPS32 * mass[seg] + 1e-6 * want.abs()
    return bool(((got - want).abs() <= tol).all())


def bench_variant(threads: int, items: int, acq_rel: bool, sizes) -> dict:
    defines = [f"SEGSCAN_THREADS={threads}", f"SEGSCAN_ITEMS={items}",
               f"SEGSCAN_ACQ_REL={int(acq_rel)}"]
    lib = segscan.bind(cuda_lib.load_variant(defines))
    tile = lib.seg_excl_sum_tile()
    assert tile == threads * items
    ptxas = re.findall(r"Used (\d+) registers|(\d+) bytes spill stores",
                       cuda_lib.build_log(defines))
    ok = True
    for n, mean_len in ((3 * tile + 357, 7), (40 * tile + 11, 0), (SERVING_B, 32)):
        x, s = random_case(n, mean_len, seed=n)
        ok &= agrees(segscan.launch(x, s, False, lib),
                     segscan.seg_excl_sum_plain(x, s), x, s)
        ok &= agrees(segscan.launch(x, s, True, lib),
                     segscan.seg_excl_rsum_plain(x, s), x, s)
    times = {}
    for n in sizes:
        x, s = random_case(n, 32, seed=1)

        def ten():
            for _ in range(10):
                segscan.launch(x, s, False, lib)

        # a PyTorch kernel without dependencies that moves the same 9 bytes
        # per element: what a streaming pass costs by this clock
        y, zero = torch.empty_like(x), torch.zeros((), device=x.device)
        times[n] = {"bound_us": 1e6 * 9 * n / HBM_BYTES_PER_S,
                    "forward_in_a_row_us": 1e2 * time_ms(ten, 30),
                    "where_same_bytes_us": 1e3 * time_ms(
                        lambda: torch.where(s, x, zero, out=y), 100)}
        # rays of about 32 samples; the same with the last 20 % or 60 % of
        # the buffer one segment (a chunk's pad slots); one segment
        layouts = [("rays", 32, 0.0)]
        if n == SERVING_B:
            layouts += [("pad_tail_20", 32, 0.2), ("pad_tail_60", 32, 0.6),
                        ("one_segment", 0, 0.0)]
        for name, mean_len, pad_tail in layouts:
            xc, sc = random_case(n, mean_len, 1, pad_tail)
            times[n][name] = [
                1e3 * time_ms(lambda: segscan.launch(xc, sc, False, lib), 100),
                1e3 * time_ms(lambda: segscan.launch(xc, sc, True, lib), 100)]
    return {"threads": threads, "items": items, "tile": tile,
            "acq_rel": acq_rel, "agrees_with_plain": ok,
            "registers": [int(r) for r, _ in ptxas if r],
            "spill_stores": [int(b) for _, b in ptxas if b], "times": times}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="128x16,256x4,256x8,256x16,512x4,"
                    "512x8,512x16,1024x4,1024x8")
    ap.add_argument("--acq_rel", action="store_true")
    ap.add_argument("--sizes", default=f"{SERVING_B},{4 * SERVING_B},{16 * SERVING_B}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_segscan: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sizes = [int(v) for v in args.sizes.split(",")]
    # what the clock itself costs: a one-element PyTorch kernel between the
    # same pair of events, and per launch when ten run between one pair
    one = torch.zeros(1, device="cuda")

    def ten():
        for _ in range(10):
            one.add_(1.0)

    print(json.dumps({"one_element_add_us": 1e3 * time_ms(lambda: one.add_(1.0), 100),
                      "one_element_add_in_a_row_us": 1e2 * time_ms(ten, 30)}),
          flush=True)
    ok = True
    for variant in args.variants.split(","):
        threads, items = (int(v) for v in variant.split("x"))
        for acq_rel in ((False, True) if args.acq_rel else (False,)):
            res = bench_variant(threads, items, acq_rel, sizes)
            ok &= res["agrees_with_plain"]
            print(json.dumps(res), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
