"""The viewer's headless engine (acn_tpu_torch.viewer.engine) against
acn_tpu's, on the micro run of ``test_torch_viewer_util``.

* The ``Controller``'s life cycle with a ``ViewRunner`` (a 50 ms sleep per
  step), the same in both packages: a start with a target stops at it; an
  extension moves the target; pause holds the step count, resume goes on,
  stop ends the thread; step once adds one step; a runner that raises ends
  the loop with its traceback in ``last_error`` and leaves the controller
  usable. Every wait is bounded (5 s).
* ``reset_fast`` after runtime-adapt steps, which write the working model in
  place, gives back the checkpoint's weights bit for bit, in the working
  model and in the published snapshot.
* The runtime checkpoint: each package loads the other's, bit for bit, with
  its step and grids. After a load of a checkpoint with other (empty) grids,
  frames read the loaded grids while TTO still steps on the context's
  (ROADMAP Queue C, ``acn_tpu/viewer/engine/runners/runtime_adapt.py:92-93``):
  in both packages the step's loss equals a fresh runner's on the context's
  grids, bit for bit, and differs from a step on the empty grids.
* ``Snapshots`` under contention: more reader threads than cores lease and
  re-read snapshots while a publisher writes new versions as fast as it can
  (the interpreter's switch interval cut to 1 µs); no lease ever sees a
  tensor change or two versions mixed. Bounded to 2 s.
"""

import contextlib
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from acn_tpu.viewer.engine.controller import Controller as JController
from acn_tpu.viewer.engine.runners.base import ViewRunner as JView
from acn_tpu.viewer.engine.runners.runtime_adapt import RuntimeAdaptRunner as JAdapt
from acn_tpu_torch import convert
from acn_tpu_torch.viewer.engine.controller import Controller as TController
from acn_tpu_torch.viewer.engine.runners.base import Snapshots
from acn_tpu_torch.viewer.engine.runners.base import ViewRunner as TView
from acn_tpu_torch.viewer.engine.runners.runtime_adapt import RuntimeAdaptRunner as TAdapt
from test_torch_viewer_util import (  # noqa: F401 (fixtures)
    assert_state_equal,
    assert_tree_equal,
    contexts,
    isolated,
    jax_params,
    runner_draws,
    state_clone,
    viewer_run,
)

WAIT_S = 5.0


def _until(cond, what):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < WAIT_S, f"timed out waiting for {what}"
        time.sleep(0.01)


def _join(c):
    if c._thread is not None:
        c._thread.join(timeout=WAIT_S)
        assert not c._thread.is_alive()


def _life_cycle(c):
    """The step counts a controller goes through; each phase waits for its
    own end, with a bound."""
    seen = {}
    c.start(target_steps=3)
    _join(c)
    seen["target"] = (c.runner.steps, c.is_running)
    c.start(target_steps=2)
    c.extend(3)  # the loop needs 100 ms for 2 steps: the extension lands first
    _join(c)
    seen["extended"] = c.runner.steps
    c.start()  # no target: runs until stopped
    _until(lambda: c.runner.steps >= 6, "a step past the target")
    c.pause()
    time.sleep(0.12)  # a step in flight ends; the loop then idles
    held = c.runner.steps
    time.sleep(0.25)
    seen["paused"] = (c.is_paused, c.runner.steps == held)
    c.resume()
    _until(lambda: c.runner.steps > held, "a step after resume")
    c.stop()
    seen["stopped"] = c.is_running
    n = c.runner.steps
    m = c.step_once()
    seen["step_once"] = (c.runner.steps - n, m == {"step": float(c.runner.steps)},
                         c.last_metrics == m)
    return seen


def test_controller_life_cycle_matches_jax(viewer_run):
    jctx, tctx = contexts(viewer_run)
    got, want = _life_cycle(TController(tctx)), _life_cycle(JController(jctx))
    assert got == want
    assert got["target"] == (3, False) and got["extended"] == 8
    assert got["paused"] == (True, True) and got["stopped"] is False


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_runner_error_ends_the_loop_and_keeps_the_controller(viewer_run, package):
    jctx, tctx = contexts(viewer_run)
    ctrl_cls, view_cls, ctx = ((TController, TView, tctx) if package == "port"
                               else (JController, JView, jctx))

    class Failing(view_cls):
        def step(self):
            if self.steps == 2:
                raise RuntimeError("the runner broke")
            return super().step()

    c = ctrl_cls(ctx)
    c.runner = Failing(ctx)
    c.start(target_steps=5)
    _join(c)
    assert not c.is_running and c.runner.steps == 2
    assert "RuntimeError: the runner broke" in c.last_error
    c.set_mode("view")  # the viewer goes on
    assert c.step_once() == {"step": 1.0}


def test_reset_fast_gives_back_the_checkpoint_bit_for_bit(viewer_run):
    _, tctx = contexts(viewer_run)
    ckpt = state_clone(tctx["model"])
    r = TAdapt(tctx)
    for _ in range(3):
        r.step()
    assert any(not torch.equal(v, ckpt[k]) for k, v in r.model.state_dict().items())
    r.reset_fast()
    assert r.steps == 0 and r.psnr_history == []
    assert_state_equal(r.model, ckpt)
    with r.get_render_params() as (model, _):
        assert_state_equal(model, ckpt)
    assert_state_equal(tctx["model"], ckpt)  # the context's model was never written
    r.step()  # and training goes on from there
    assert r.steps == 1


def test_each_package_loads_the_others_runtime_checkpoint(viewer_run, tmp_path):
    jctx, tctx = contexts(viewer_run)
    tr = TAdapt(tctx, draws=runner_draws(tctx["P"]))
    jr = JAdapt(jctx)
    tr.step(), tr.step()
    tr.save_runtime_checkpoint(tmp_path / "port")
    jr.load_runtime_checkpoint(tmp_path / "port")
    assert jr.steps == 2
    assert_tree_equal(tr.model.params(), jax_params(jr))
    np.testing.assert_array_equal(np.asarray(jr.occ_states["binaries"]),
                                  tctx["occ_states"]["binaries"].numpy())

    jr.step()
    jr.save_runtime_checkpoint(tmp_path / "jax")
    fresh = TAdapt(tctx)
    fresh.load_runtime_checkpoint(tmp_path / "jax")
    assert fresh.steps == 3
    assert_tree_equal(fresh.model.params(), jax_params(jr))
    with fresh.get_render_params() as (model, occ):
        assert_tree_equal(model.params(), jax_params(jr))
        for k, v in occ.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jr.occ_states[k]))
    want = convert.from_jax_variables(jax.device_get(jr.variables), tctx["cfg"], "cpu")
    assert_state_equal(fresh.model, state_clone(want))


def _empty(occ_states, to_port):
    """The grids with no occupied cell."""
    if to_port:
        return {**occ_states, "binaries": torch.zeros_like(occ_states["binaries"])}
    return {**occ_states, "binaries": jax.numpy.zeros_like(occ_states["binaries"])}


@pytest.mark.parametrize("package", ["port", "jax"])
def test_tto_steps_on_the_contexts_grids_after_loading_others(viewer_run, tmp_path,
                                                              package):
    jctx, tctx = contexts(viewer_run)
    port = package == "port"
    ctx = tctx if port else jctx
    make = ((lambda c: TAdapt(c, draws=runner_draws(tctx["P"]))) if port
            else (lambda c: JAdapt(c)))
    saver = make(ctx)
    saver.occ_states = _empty(ctx["occ_states"], port)
    saver.save_runtime_checkpoint(tmp_path)
    loaded = make(ctx)
    loaded.load_runtime_checkpoint(tmp_path)
    lease = loaded.get_render_params()  # the port's is a lease, acn_tpu's a tuple
    with (lease if port else contextlib.nullcontext(lease)) as (_, frame_occ):
        assert not np.asarray(frame_occ["binaries"]).any()  # frames: the loaded grids
    assert np.asarray(ctx["occ_states"]["binaries"]).any()
    got = loaded.step()["loss"]
    assert got == make(ctx).step()["loss"]  # the context's grids
    assert got != make({**ctx, "occ_states": _empty(ctx["occ_states"], port)}).step()["loss"]


def test_snapshots_never_tear_under_contention():
    model = torch.nn.Sequential(*[torch.nn.Linear(64, 64) for _ in range(4)])
    snaps = Snapshots(model)
    stop = threading.Event()
    bad, seen, published = [], set(), [0]

    def publisher():
        v = 0
        while not stop.is_set():
            v += 1
            with torch.no_grad():
                for t in model.state_dict().values():
                    t.fill_(float(v))
            snaps.publish(model, v)
            published[0] = v

    def reader():
        while not stop.is_set():
            with snaps.lease() as (m, step):
                first = [t.clone() for t in m.state_dict().values()]
                time.sleep(0)
                for a, b in zip(first, m.state_dict().values()):
                    if not (torch.equal(a, b) and bool((a == float(step)).all())
                            or step == 0):
                        bad.append(step)
                seen.add(step)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=publisher)] + [
        threading.Thread(target=reader) for _ in range((os.cpu_count() or 1) + 2)]
    try:
        for t in threads:
            t.start()
        time.sleep(2.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=WAIT_S)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad, bad[:5]
    assert published[0] > 10 and len(seen) > 3, (published[0], len(seen))
