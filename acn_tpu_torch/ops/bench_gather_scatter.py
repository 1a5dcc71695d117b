"""Gather and scatter-add rates of the card at the hash tables' sizes.

    python -m acn_tpu_torch.ops.bench_gather_scatter [--rows 4000000]
        [--iters 10] [--device cuda]

Port of ``acn_tpu/ops/bench_gather_scatter.py``: the bound that a
hand-written hash-encode kernel (forward: a row gather; backward: an atomic
row scatter-add) is held to. Measured, each as millions of rows per second
over N = ``--rows`` random row indices per op:

* ``gather`` (``table[idx]``, the indexing the hash encode's lookup uses)
  and ``scatter_add`` (``zeros`` then ``index_add_``, its backward's) on
  tables of 2^13, 2^17 and 2^20 rows × 16 float32, the sizes ``acn_tpu``
  measured;
* the one-hot product on the 2^13-row table, the alternative that a matrix
  unit offers (``torch.matmul`` of a bf16 one-hot block by the table, and
  its transpose for the scatter), in blocks of ``ONE_HOT_BLOCK`` rows, each
  block's one-hot written once in bf16;
* the streaming ceiling: one elementwise kernel that reads and writes N × 16
  float32;
* the port's own hash table of ``configs/train_occ.json``, 833,403 rows ×
  32, gather and scatter-add in bf16 and in float32.

Each figure is the time of ``--iters`` calls between two CUDA events after
one warm call, on fixed inputs, beside ``bound_ms``: the least time the card
could take, the larger of the bytes the op must move (each input read once:
the table or the rows added, the indices; the output written once) over
3.35 TB/s and, for the one-hot products, their 2·N·rows·F operations over
989 TFLOP/s in bf16 (the H100 SXM data sheet's dense rates). It prints one
JSON line per figure, each with the card's ``nvidia-smi`` name and power
limit. On the CPU (``--device cpu``,
the tests' small sizes) the same calls are timed by the host's clock and the
line says ``"device": "cpu"``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List

import torch

TABLE_LOG2_ROWS = (13, 17, 20)
TABLE_F = 16
HASH_TABLE = (833_403, 32)  # configs/train_occ.json: a cell-layout expert table
ONE_HOT_MAX_LOG2 = 13  # the one-hot product only competes for small tables
ONE_HOT_BLOCK = 65_536
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx]


def scatter_add(table: torch.Tensor, idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(table).index_add_(0, idx, g)


def _one_hot(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(len(idx), n_rows) bf16 one-hot rows, written once."""
    oh = torch.zeros((len(idx), n_rows), dtype=torch.bfloat16, device=idx.device)
    return oh.scatter_(1, idx[:, None], 1.0)


def onehot_gather(table: torch.Tensor, idx: torch.Tensor, block: int = ONE_HOT_BLOCK):
    """``one_hot(idx) @ table`` in bf16, block by block."""
    t = table.to(torch.bfloat16)
    return torch.cat([_one_hot(idx[s:s + block], table.shape[0]) @ t
                      for s in range(0, len(idx), block)])


def onehot_scatter(n_rows: int, idx: torch.Tensor, g: torch.Tensor,
                   block: int = ONE_HOT_BLOCK) -> torch.Tensor:
    """``one_hot(idx)ᵀ @ g`` in bf16 products, summed over blocks in float32."""
    out = torch.zeros((n_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    for s in range(0, len(idx), block):
        out += (_one_hot(idx[s:s + block], n_rows).T @ g[s:s + block].to(torch.bfloat16)
                ).float()
    return out


def stream(x: torch.Tensor) -> torch.Tensor:
    return x * 1.0001


def seconds_per_call(fn: Callable[[], torch.Tensor], iters: int,
                     device: torch.device) -> float:
    """One warm call, then ``iters`` calls between two CUDA events (the
    host's clock on the CPU)."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def run(device=None, rows: int = 4_000_000, iters: int = 10,
        log2_rows=TABLE_LOG2_ROWS, hash_table=HASH_TABLE, seed: int = 0) -> List[Dict]:
    """The figures as dicts {"op", "table", "dtype", "rows", "ms",
    "Mrows_per_s" (and "GB_per_s" for the stream), "bytes", "bound_ms",
    "bound_by", "device"}."""
    from acn_tpu_torch.pipelines.renderer import resolve_device
    from acn_tpu_torch.scripts.bench_train import _card

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    card = _card(device)
    out = []

    def add(op, table, dtype, fn, n_bytes, n_ops=0, n_iters=iters):
        s = seconds_per_call(fn, n_iters, device)
        bound = max(n_bytes / HBM_BYTES_PER_S, n_ops / BF16_OPS_PER_S)
        out.append({"op": op, "table": list(table), "dtype": str(dtype).split(".")[-1],
                    "rows": rows, "ms": s * 1e3, "Mrows_per_s": rows / s / 1e6,
                    "bytes": n_bytes, "bound_ms": bound * 1e3,
                    "bound_by": "operations" if n_ops / BF16_OPS_PER_S > n_bytes /
                    HBM_BYTES_PER_S else "bytes", "device": card})

    tables = [(2 ** l, TABLE_F, torch.float32, l <= ONE_HOT_MAX_LOG2) for l in log2_rows]
    tables += [(*hash_table, dt, False) for dt in (torch.bfloat16, torch.float32)]
    for n_rows, F, dtype, one_hot in tables:
        table = torch.randn((n_rows, F), generator=gen, device=device).to(dtype)
        idx = torch.randint(0, n_rows, (rows,), generator=gen, device=device)
        g = torch.randn((rows, F), generator=gen, device=device).to(dtype)
        tb, ib, rb = table.nbytes, idx.nbytes, g.nbytes  # table, indices, rows
        add("gather", (n_rows, F), dtype, lambda: gather(table, idx), tb + ib + rb)
        add("scatter_add", (n_rows, F), dtype, lambda: scatter_add(table, idx, g),
            rb + ib + tb)
        if one_hot:
            n_iters, ops = max(1, iters // 3), 2 * rows * n_rows * F
            add("onehot_gather", (n_rows, F), torch.bfloat16,
                lambda: onehot_gather(table, idx), (tb + rb) // 2 + ib, ops, n_iters)
            add("onehot_scatter", (n_rows, F), torch.bfloat16,
                lambda: onehot_scatter(n_rows, idx, g), (tb + rb) // 2 + ib, ops, n_iters)
        del table, idx, g
    x = torch.randn((rows, TABLE_F), generator=gen, device=device)
    s = seconds_per_call(lambda: stream(x), iters, device)
    out.append({"op": "stream", "table": [rows, TABLE_F], "dtype": "float32", "rows": rows,
                "ms": s * 1e3, "Mrows_per_s": rows / s / 1e6,
                "GB_per_s": 2 * x.nbytes / s / 1e9, "bytes": 2 * x.nbytes,
                "bound_ms": 2 * x.nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "device": card})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4_000_000, help="row indices per op")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    for row in run(args.device, args.rows, args.iters):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
