"""Thread-based training controller for the viewer.

Port of ``acn_tpu/viewer/engine/controller.py``: builds the per-mode runner
(View / Runtime-Adapt / Meta-Train), provides Start / extend-target / Pause /
Resume / Stop / step-once semantics, and runs a daemon loop thread that steps
the runner; a runner's exception ends the loop, its traceback kept in
``last_error``, and the viewer stays up. ``get_render_params`` is the
runner's lease of its published snapshot (``runners/base.py``).
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, Dict, Optional

from acn_tpu_torch.viewer.engine.runners.base import BaseRunner, ViewRunner


class Controller:
    MODES = ("view", "runtime_adapt", "meta_train")

    def __init__(self, ctx: Dict[str, Any], on_update: Optional[Callable] = None):
        self.ctx = ctx
        self.on_update = on_update or (lambda metrics: None)
        self.mode = "view"
        self.runner: BaseRunner = ViewRunner(ctx)
        self._thread: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._paused = threading.Event()
        self._target_steps = 0
        self._lock = threading.Lock()
        self.last_metrics: Dict[str, float] = {}
        self.last_error: Optional[str] = None

    def set_mode(self, mode: str, **runner_kwargs) -> None:
        assert mode in self.MODES, mode
        self.stop()
        self.mode = mode
        if mode == "view":
            self.runner = ViewRunner(self.ctx)
        elif mode == "runtime_adapt":
            from acn_tpu_torch.viewer.engine.runners.runtime_adapt import RuntimeAdaptRunner

            self.runner = RuntimeAdaptRunner(self.ctx, **runner_kwargs)
        else:
            from acn_tpu_torch.viewer.engine.runners.meta_train import MetaTrainRunner

            self.runner = MetaTrainRunner(self.ctx)

    def start(self, target_steps: int = 0) -> None:
        with self._lock:
            self._target_steps = (
                self.runner.steps + target_steps if target_steps > 0 else -1
            )
            if self._thread is not None and self._thread.is_alive():
                self._paused.clear()
                return
            self._running.set()
            self._paused.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def extend(self, extra_steps: int) -> None:
        with self._lock:
            if self._target_steps >= 0:
                self._target_steps += extra_steps

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def stop(self) -> None:
        self._running.clear()
        self._paused.clear()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def step_once(self) -> Dict[str, float]:
        m = self.runner.step()
        self.last_metrics = m
        self.on_update(m)
        return m

    @property
    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def is_paused(self) -> bool:
        return self._paused.is_set()

    def get_render_params(self):
        """A context manager: (the published model, the occupancy states)
        for one frame."""
        return self.runner.get_render_params()

    def _loop(self) -> None:
        import time

        while self._running.is_set():
            if self._paused.is_set():
                time.sleep(0.1)
                continue
            if 0 <= self._target_steps <= self.runner.steps:
                break
            try:
                m = self.runner.step()
                self.last_metrics = m
                self.on_update(m)
            except Exception:
                # the loop's boundary: keep the traceback, stop the loop,
                # keep the viewer alive
                self.last_error = traceback.format_exc()
                break
        self._running.clear()
