"""Run a function on n ranks, each a fresh Python process.

    results = launch.spawn("acn_tpu_torch.parallel.dryrun:sharded_step", n,
                           args, workdir, device_type="cpu")

Each rank is started as ``python -m acn_tpu_torch.parallel.launch`` (a new
interpreter: nothing of the parent, and no fork of a process whose threads
have started), joins the process group through a ``FileStore`` in
``workdir`` (no TCP port to race for) with the backend rule of
``mesh.init_distributed`` and a bounded timeout, calls ``fn(rank, n,
args)`` (which may leave the process group itself, as ``runner.main``
does), and writes what it returns to ``workdir/out{rank}.pt``; ``args``
travel in ``workdir/args.pt``. The parent waits at most ``timeout_s``; on
the deadline, or when a rank fails, it kills every rank and raises with
their output. A rank fails, too, if it imported JAX or ``acn_tpu``.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, List

import torch

ROOT = Path(__file__).resolve().parents[2]  # the checkout: the ranks' import root


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def spawn(target: str, n: int, args: Any, workdir, *, device_type: str = "cpu",
          timeout_s: float = 300.0, init_timeout_s: float = 60.0,
          threads: int = 1) -> List[Any]:
    """``target`` ("module:function") on ``n`` ranks; returns each rank's
    result, in rank order."""
    workdir = Path(workdir).resolve()
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "rendezvous"
    if store.exists():
        store.unlink()
    torch.save(args, workdir / "args.pt")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]),
        "OMP_NUM_THREADS": str(threads)}
    procs = []
    for r in range(n):
        log = open(workdir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "acn_tpu_torch.parallel.launch", str(workdir), str(r),
             str(n), target, device_type, str(init_timeout_s), str(threads)],
            cwd=str(ROOT), env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            if any(c not in (None, 0) for c in codes):
                failed = f"rank {codes.index(next(c for c in codes if c not in (None, 0)))} " \
                         f"exited with {[c for c in codes]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = f"ranks still running after {timeout_s:.0f} s (exit codes {codes})"
                break
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if failed:
        logs = "\n".join(f"--- rank {r} ---\n{_tail(workdir / f'rank{r}.log')}"
                         for r in range(n))
        raise RuntimeError(f"{target} on {n} ranks: {failed}\n{logs}")
    return [torch.load(workdir / f"out{r}.pt", weights_only=False) for r in range(n)]


def _child(argv: List[str]) -> int:
    from acn_tpu_torch.parallel import mesh

    workdir, rank, n, target, device_type, init_timeout_s, threads = argv
    workdir, rank, n = Path(workdir), int(rank), int(n)
    torch.set_num_threads(int(threads))
    mesh.init_distributed(f"file://{workdir / 'rendezvous'}", n, rank, device_type,
                          float(init_timeout_s))
    try:
        module, fn = target.split(":")
        out = getattr(importlib.import_module(module), fn)(
            rank, n, torch.load(workdir / "args.pt", weights_only=False))
        if device_type == "cuda":
            torch.cuda.synchronize()
        if mesh.backend() is not None:  # fn may have left the group itself
            mesh.host_barrier()
    finally:
        mesh.shutdown()
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "acn_tpu"))
    if leaked:
        raise RuntimeError(f"rank {rank} imported {leaked[:5]}")
    torch.save(out, workdir / f"out{rank}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1:]))
