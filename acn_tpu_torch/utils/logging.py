"""Logging: a versioned run directory with ``log.txt``, optional
TensorBoard scalars, smoothed console metrics and phase timers.

Port of ``acn_tpu/utils/logging.py``: ``Logger`` (``logs_root/fname``, or
``fname_v1``, ``fname_v2``, … when that directory already holds files),
``SmoothedValue``, ``MetricLogger`` and ``PhaseTimer``. TensorBoard is used
when ``torch.utils.tensorboard`` imports, else the log is file-only.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from datetime import datetime
from pathlib import Path
from typing import Dict


def _rank0s(logdir: Path) -> Path:
    """Rank 0's choice of the run directory, on every rank of a process
    group (every rank builds its logger; only rank 0 writes)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return logdir
    from acn_tpu_torch.parallel.mesh import host_group

    box = [str(logdir)]
    dist.broadcast_object_list(box, src=0, group=host_group())
    return Path(box[0])


class Logger:
    """The run's log; a process of rank above 0 (a mesh's) neither prints
    nor writes; all ranks of a process group build it together and share
    rank 0's run directory. ``tensorboard=False`` keeps the log file-only (where
    TensorFlow is installed, TensorBoard's import loads it, and with it
    whatever it loads)."""

    def __init__(self, fname: str, logs_root: str = "logs", rank: int = 0,
                 tensorboard: bool = True):
        self.rank = int(rank)
        logdir = Path(logs_root) / fname
        if logdir.exists() and any(logdir.iterdir()):
            v = 1
            while (Path(logs_root) / f"{fname}_v{v}").exists():
                v += 1
            logdir = Path(logs_root) / f"{fname}_v{v}"
        self.logdir = _rank0s(logdir)
        logdir = self.logdir
        self._logfile = self._writer = None
        if self.rank != 0:
            return
        logdir.mkdir(parents=True, exist_ok=True)
        self._logfile = open(logdir / "log.txt", "a")
        if not tensorboard:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=str(logdir))
        except Exception:
            self._writer = None

    def log(self, msg: str) -> None:
        if self.rank != 0:
            return
        line = f"[{datetime.now().strftime('%y-%m-%d %H:%M:%S')}] {msg}"
        print(line, flush=True)
        if self._logfile:
            self._logfile.write(line + "\n")
            self._logfile.flush()

    def scalar(self, name: str, value, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(name, float(value), step)

    def add_region_layout(self, num_regions: int) -> None:
        """TensorBoard custom-scalars layout: the per-region curves of each
        metric in one chart."""
        if self._writer is None:
            return
        try:
            self._writer.add_custom_scalars({"per-region": {
                metric: ["Multiline",
                         [f"train/{metric}/region_{r}" for r in range(num_regions)]]
                for metric in ("psnr_out", "loss_out")}})
        except Exception:
            pass

    def close(self) -> None:
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()
        if self._logfile:
            self._logfile.close()
            self._logfile = None


class SmoothedValue:
    """Windowed median / average tracker."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    def __str__(self):
        return f"{self.median:.4f} ({self.global_avg:.4f})"


class MetricLogger:
    """Console metric aggregator."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def synchronize_between_processes(self) -> None:
        """Sum each meter's count and total over the processes, so that
        ``global_avg`` is the mean over all of them (a host ``all_reduce``
        over the world's gloo group; nothing without a process group)."""
        import torch
        import torch.distributed as dist

        from acn_tpu_torch.parallel.mesh import host_group

        if not dist.is_initialized() or dist.get_world_size() <= 1:
            return
        for m in self.meters.values():
            t = torch.tensor([float(m.count), float(m.total)], dtype=torch.float64)
            dist.all_reduce(t, group=host_group())
            m.count = int(t[0])
            m.total = float(t[1])


class PhaseTimer:
    """Wall-clock time per named host phase: ``tic(name)`` / ``toc(name)``
    around a phase, ``reset()`` returns the sums since the last reset."""

    def __init__(self):
        self.acc = defaultdict(float)
        self._t0 = {}

    def tic(self, name: str):
        self._t0[name] = time.perf_counter()

    def toc(self, name: str):
        self.acc[name] += time.perf_counter() - self._t0.pop(name)

    def reset(self) -> Dict[str, float]:
        out = dict(self.acc)
        self.acc.clear()
        return out
