"""The viewer's GUI wiring (acn_tpu_torch.viewer.viewer.launch_viewer)
against acn_tpu's, with a stub ``viser`` module that records the server's
folders and widgets, on the micro run of ``test_torch_viewer_util``.

* With ``--viewer_timeout 0`` each package's ``launch_viewer`` builds the
  same folders and widgets, with the same labels, options and initial
  values, and returns (stopping its controller and server).
* Firing the same callbacks (every widget of the Visuals, Sampling,
  Postprocessing and Crop folders, the hyperparameters, the mode, the
  buttons, the batch scan) leaves equal ``ViewerState``s and makes the same
  calls on a recording controller and its runner.
* Without viser both raise the same ``ImportError``, from ``launch_viewer``
  and through each package's ``main`` (``--op view``).
"""

import sys
import types

import pytest

from acn_tpu import runner as jrunner
from acn_tpu.viewer import viewer as jviewer
from acn_tpu_torch import runner as trunner
from acn_tpu_torch.viewer import viewer as tviewer
from test_torch_viewer_util import contexts, isolated, view_argv, viewer_run  # noqa: F401


class _Handle:
    def __init__(self, log, folder, kind, args, kwargs):
        self.kind, self.label = kind, args[0]
        self.value = kwargs.get("initial_value", args[-1] if len(args) > 1 else None)
        self.callbacks = []
        log.append((folder, kind, args, tuple(sorted(kwargs.items()))))

    def on_update(self, fn):
        self.callbacks.append(fn)
        return fn

    on_click = on_update

    def fire(self, value=None):
        if value is not None:
            self.value = value
        for fn in self.callbacks:
            fn(None)


class _Gui:
    def __init__(self, server):
        self.server, self.folder = server, None

    def add_folder(self, name):
        gui = self

        class _Folder:
            def __enter__(self):
                gui.folder = name

            def __exit__(self, *exc):
                gui.folder = None

        return _Folder()

    def __getattr__(self, kind):
        if not kind.startswith("add_"):
            raise AttributeError(kind)

        def add(*args, **kwargs):
            h = _Handle(self.server.log, self.folder, kind, args, kwargs)
            self.server.handles[h.label] = h
            return h

        return add


def stub_viser(servers):
    """A ``viser`` module whose servers record their widgets in ``servers``."""
    mod = types.ModuleType("viser")

    class ViserServer:
        def __init__(self, host, port):
            self.log, self.handles, self.stopped = [("server", host, port)], {}, False
            self.gui = _Gui(self)
            servers.append(self)

        def on_client_connect(self, fn):
            return fn

        def stop(self):
            self.stopped = True

    mod.ViserServer = ViserServer
    return mod


class _Recorder:
    """A controller and runner that record their calls."""

    def __init__(self, calls, logdir):
        self.calls, self.logdir = calls, str(logdir)
        self.last_metrics, self.is_running = {}, False
        self.runner = self

    def __getattr__(self, name):
        def call(*args, **kwargs):
            args = tuple("<logdir>" if str(a) == self.logdir else a for a in args)
            self.calls.append((name, args, tuple(sorted(kwargs))))

        return call

    def __setattr__(self, name, value):
        if name in ("support_rays", "downscale"):
            self.calls.append(("set", name, value))
        object.__setattr__(self, name, value)


def _launch(mod, ctx, monkeypatch):
    servers, calls, states = [], [], []
    monkeypatch.setitem(sys.modules, "viser", stub_viser(servers))
    monkeypatch.setattr(mod, "Controller",
                        lambda c: _Recorder(calls, c["logger"].logdir))
    base = mod.ViewerState

    class Recorded(base):
        def __init__(self, P):
            super().__init__(P)
            states.append(self)

    monkeypatch.setattr(mod, "ViewerState", Recorded)
    ctx["P"].viewer_timeout = 0
    mod.launch_viewer(ctx)
    (server,) = servers
    (state,) = states
    return server, calls, state


def _fire_all(server, batch_dir):
    h = server.handles
    for label, value in (("Display", "depth"), ("Background", "black"), ("Active module", "1"),
                         ("Occupancy renderer", False), ("Full samples", 64),
                         ("Preview samples", 12), ("Exposure", 0.5), ("Gamma", 2.0),
                         ("Depth colormap", "viridis"), ("Near (m)", 3.0), ("Far (m)", 40.0),
                         ("Enable crop", True), ("Center (m)", (1.0, 2.0, 3.0)),
                         ("Roll/Pitch/Yaw (deg)", (0.0, 10.0, 20.0)),
                         ("Size (m)", (5.0, 6.0, 7.0)), ("Support rays", 8),
                         ("Downscale", 0.5), ("lr/sigma", 0.25), ("Batch dir", str(batch_dir)),
                         ("Mode", "runtime_adapt"), ("Target steps", 7)):
        h[label].fire(value)
    for label in ("Start", "Pause", "Resume", "Step once", "Stop", "Reset weights",
                  "Save runtime checkpoint", "Scan && Verify", "Snap to view", "Dolly in",
                  "Screenshot"):
        h[label].fire()
    return h["Scan result"].value


def test_launch_viewer_builds_the_same_gui(viewer_run, monkeypatch):
    jctx, tctx = contexts(viewer_run)
    want, wcalls, _ = _launch(jviewer, jctx, monkeypatch)
    got, gcalls, _ = _launch(tviewer, tctx, monkeypatch)
    assert got.log == want.log
    assert [(f, k) for f, k, *_ in got.log[1:]].count(("Visuals", "add_dropdown")) == 3
    assert {f for f, *_ in got.log[1:]} == {"Visuals", "Sampling", "Postprocessing", "Crop",
                                            "Camera", "Operation Mode", "Hyperparameters",
                                            "Continual batches"}
    assert got.stopped and want.stopped
    assert gcalls == wcalls == [("stop", (), ())]


def test_callbacks_give_the_same_state_and_calls(viewer_run, monkeypatch):
    batch = viewer_run / "data" / "out" / "example" / "continual" / "b000"
    out = []
    for mod, ctx in zip((jviewer, tviewer), contexts(viewer_run)):
        server, calls, state = _launch(mod, ctx, monkeypatch)
        calls.clear()
        scan = _fire_all(server, batch)
        out.append((vars(state), calls, scan))
    (wstate, wcalls, wscan), (gstate, gcalls, gscan) = out
    assert gstate == wstate
    assert gstate["display"] == "depth" and gstate["active_module"] == 1
    assert gstate["crop_size_m"] == (5.0, 6.0, 7.0) and gstate["bg_policy"] == "black"
    assert gcalls == wcalls
    names = [c[0] for c in gcalls]
    for name in ("set_mode", "start", "pause", "resume", "step_once", "stop", "reset_fast",
                 "save_runtime_checkpoint", "update_lr"):
        assert name in names, name
    assert ("start", (7,), ()) in gcalls and ("set", "support_rays", 16) in gcalls
    assert gscan == wscan and gscan.startswith("OK: (True")


def test_without_viser_both_raise_the_same_import_error(viewer_run, monkeypatch):
    monkeypatch.setitem(sys.modules, "viser", None)
    jctx, tctx = contexts(viewer_run)
    with pytest.raises(ImportError) as want:
        jviewer.launch_viewer(jctx)
    with pytest.raises(ImportError) as got:
        tviewer.launch_viewer(tctx)
    assert str(got.value) == str(want.value)
    argv = view_argv(viewer_run, "--op", "view", "--fname", "main")
    with pytest.raises(ImportError) as jmain:
        jrunner.main(argv)
    with pytest.raises(ImportError) as tmain:
        trunner.main(argv, device="cpu")
    assert str(tmain.value) == str(jmain.value) == str(want.value)
