"""Viewer training runners: base machinery.

Port of ``acn_tpu/viewer/engine/runners/base.py``. In ``acn_tpu`` a step
returns new immutable arrays and the runner swaps one reference, so the
render thread reads whichever snapshot is current without a lock. Here a
step updates its model in place (``utils/optim.apply_updates``), so a frame
rendered from the model a step is writing would mix two states. A runner
therefore trains a working copy of the context's model and, after every
change of its weights, publishes it: a device-to-device copy into one of
``Snapshots``' buffers, which nothing else writes. A frame leases the
current buffer for its whole length (``get_render_params``), and a publish
only writes a buffer that no frame holds; a lease or a publish holds the
buffers' lock only to pick a buffer, never for a frame or a step.

Both threads issue their work on the device's current stream, the default
stream that host threads share: a copy enqueued after a frame's kernels runs
after them, and a frame's kernels enqueued after a publish read its copy.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Tuple

import torch

from acn_tpu_torch.models.container import Container

io_lock = threading.Lock()

N_SNAPSHOTS = 3  # the current one, one to write, one for a second frame in flight


class Snapshots:
    """Immutable published copies of a model, leased by frames."""

    def __init__(self, model: Container):
        self._bufs = [copy.deepcopy(model).requires_grad_(False) for _ in range(N_SNAPSHOTS)]
        self._readers = [0] * N_SNAPSHOTS
        self._steps = [0] * N_SNAPSHOTS
        self._current = 0
        self._cond = threading.Condition()

    @contextlib.contextmanager
    def lease(self) -> Iterator[Tuple[Container, int]]:
        """(the current snapshot, the step it was published at), held from
        entry to exit: no publish writes it meanwhile."""
        with self._cond:
            i = self._current
            self._readers[i] += 1
        try:
            yield self._bufs[i], self._steps[i]
        finally:
            with self._cond:
                self._readers[i] -= 1
                self._cond.notify_all()

    @torch.no_grad()
    def publish(self, model: Container, step: int) -> None:
        """Copy ``model``'s state into a buffer that no frame holds and make
        it the current one. Waits while every other buffer is leased."""
        with self._cond:
            while True:
                free = [i for i in range(N_SNAPSHOTS)
                        if i != self._current and self._readers[i] == 0]
                if free:
                    break
                self._cond.wait()
            i = free[0]
            self._readers[i] += 1  # held while it is written: no second publisher takes it
        try:
            dst = self._bufs[i].state_dict()
            for k, v in model.state_dict().items():
                dst[k].copy_(v)
        finally:
            with self._cond:
                self._readers[i] -= 1
                self._steps[i] = int(step)
                self._current = i
                self._cond.notify_all()


class BaseRunner:
    """A working copy of the context's model, its published snapshots, and
    the runtime knobs: reset to the initial weights, runtime checkpoint save
    and load, live lr / ray / downscale updates."""

    def __init__(self, ctx: Dict[str, Any]):
        self.ctx = ctx
        self.P = ctx["P"]
        self.cfg = ctx["cfg"]
        self.device = ctx["model"].global_aabb.device
        # steps write the working copy in place: the context's model stays
        # the checkpoint's, as acn_tpu's context variables do
        self.model: Container = copy.deepcopy(ctx["model"])
        self.occ_states = ctx.get("occ_states")
        # acn_tpu keeps an alias of its immutable initial arrays; an alias
        # of tensors that steps update in place would restore nothing
        self._initial = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self._weights = threading.Lock()  # a step against a reset or a load
        self._snapshots = Snapshots(self.model)
        self.steps = 0
        self.psnr_history = []
        # live knobs
        self.support_rays = int(self.P.support_rays)
        self.ray_samples = int(self.P.ray_samples)
        self.downscale = float(self.P.downscale)
        self.lrs = {
            "encoding": float(self.P.encoding_lr),
            "sigma": float(self.P.sigma_lr),
            "color": float(self.P.color_lr),
            "background": float(self.P.bg_lr),
        }

    def _publish(self) -> None:
        self._snapshots.publish(self.model, self.steps)

    def reset_fast(self) -> None:
        """Restore the initial weights and clear the step count."""
        with self._weights, torch.no_grad():
            for k, v in self.model.state_dict().items():
                v.copy_(self._initial[k])
            self.steps = 0
            self.psnr_history.clear()
            self._publish()

    @contextlib.contextmanager
    def get_render_params(self) -> Iterator[Tuple[Container, Any]]:
        """(the published model, the occupancy states) for one frame: the
        snapshot is leased until the block exits."""
        with self._snapshots.lease() as (model, _):
            yield model, self.occ_states

    def save_runtime_checkpoint(self, path) -> None:
        """The checkpoint ``runtime`` in ``path`` (variables, occupancy
        states, P, step) of the published snapshot, in ``acn_tpu``'s layout."""
        from acn_tpu_torch.utils.checkpoint import save_checkpoint

        with self._snapshots.lease() as (model, step), io_lock:
            save_checkpoint(Path(path), "runtime", model, occ_states=self.occ_states,
                            P=self.P, step=step)

    def load_runtime_checkpoint(self, path) -> None:
        """Load ``runtime`` from ``path`` (this package's or ``acn_tpu``'s)
        into the working model, and publish it."""
        from acn_tpu_torch.utils.checkpoint import load_checkpoint, restore_model

        with io_lock:
            loaded = load_checkpoint(Path(path), "runtime")
        restored, occ = restore_model(loaded, self.cfg, self.device)
        with self._weights:
            self.model.load_state_dict(restored.state_dict())
            if occ is not None and self.occ_states is not None:
                if {k: v.shape for k, v in occ.items()} != {
                        k: v.shape for k, v in self.occ_states.items()}:
                    raise ValueError("the runtime checkpoint's occupancy grids do not "
                                     "match the runner's")
                self.occ_states = occ
            self.steps = loaded["step"]
            self._publish()

    def update_lr(self, group: str, value: float) -> None:
        self.lrs[group] = float(value)
        self._on_hparams_changed()

    def _on_hparams_changed(self) -> None:
        pass  # subclasses rebuild optimizers lazily

    def step(self) -> Dict[str, float]:
        raise NotImplementedError


class ViewRunner(BaseRunner):
    """Render-only mode: no training work, but steps still count so that a
    start with a target ends."""

    def step(self) -> Dict[str, float]:
        time.sleep(0.05)
        self.steps += 1
        return {"step": float(self.steps)}
