"""The port's training loop, continued from tests/test_torch_trainer.py
(split from it so that the test run spreads them over its workers): a
SIGTERM stops the loop after its step and the resume restores the saved
state exactly; the loop's refusals; the logger's run directories. The micro
scene and schedule are that file's.
"""

import os
import signal
import types

import pytest
import torch

from acn_tpu_torch import convert, toy
from acn_tpu_torch.data import tasks as ttasks
from acn_tpu_torch.models.nn import tree_leaves, tree_map
from acn_tpu_torch.pipelines.offline_stage import trainer as ttrainer
from acn_tpu_torch.utils import checkpoint as tck
from acn_tpu_torch.utils import logging as tlogging
from acn_tpu_torch.utils.config import load_checkpoint_cfg
from test_torch_trainer import loop_P, samplers, scene


# ------------------------------------------------------------ stop and resume


class SignalAtStep(ttrainer.LoopDraws):
    """Generator draws that send SIGTERM to the process while the loop sets
    up step ``at``."""

    def __init__(self, seed, at):
        super().__init__(seed, "cpu")
        self.at, self.calls = at, 0

    def step(self):
        self.calls += 1
        if self.calls == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return super().step()


def _assert_equal(a, b, what):
    assert a.dtype == b.dtype and torch.equal(a, b), what


def _port_run(logs_root, P, start=None):
    sc = scene()
    _, ts = samplers(0)
    pools = ttasks.build_device_pools(ts, max_pool=512, seed=0)
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    opt, state = toy.init_train_state(model, P)
    kw = {}
    if start is not None:
        payload, tag = start
        model, occ = tck.restore_model(payload, sc.tcfg, "cpu")
        opt, state = toy.init_train_state(model, P)
        state["opt_state"] = tck.load_opt_state(tag[0], tag[1], state["opt_state"], opt)
        state["step"] = payload["step"]
        kw = dict(occ_states=occ, start_step=payload["step"], best=payload["best"])
    logger = tlogging.Logger("run", logs_root=logs_root)
    return state, opt, logger, pools, kw


def test_sigterm_stops_after_the_step_and_resume_restores_it(tmp_path):
    # any reading switches: the generator's draws are not the parity run's
    P = loop_P(outer_steps=6, eval_step=2, save_step=100, occ_auto_thresh=1.0)
    state, opt, logger, pools, _ = _port_run(str(tmp_path), P)
    handler = signal.getsignal(signal.SIGTERM)
    out = ttrainer.meta_trainer(P, scene().tcfg, state, opt, None, None, logger,
                                occ_cfg=scene().tocc_cfg, device_pools=pools,
                                draws=SignalAtStep(0, at=3), device="cpu")
    logger.close()
    assert signal.getsignal(signal.SIGTERM) is handler  # restored
    assert out["loop"]["last_step"] == 3 and out["step"] == 3
    run = logger.logdir
    assert sorted(p.name for p in run.glob("*.model")) == ["last.model"]
    payload = tck.load_checkpoint(run, "last")
    assert payload["step"] == 3
    # the switch fired after step 3 (readings at 2 and 3), before the save
    assert load_checkpoint_cfg(str(run / "last.P.json"))["occ_regime"] == "budget"

    # the resume restores the saved state exactly, then runs on to the end
    P2 = types.SimpleNamespace(**load_checkpoint_cfg(str(run / "last.P.json")))
    P2.outer_steps = 5
    state2, opt2, logger2, pools, kw = _port_run(str(tmp_path), P2,
                                                 start=(payload, (run, "last")))
    for a, b in zip(tree_leaves(state2["model"].params()), tree_leaves(out["model"].params())):
        assert torch.equal(a, b)
    assert state2["opt_state"].keys() == out["opt_state"].keys()
    for name in out["opt_state"]:  # paired by key: the two trees' orders differ
        tree_map(lambda a, b: _assert_equal(a, b, name), state2["opt_state"][name],
                 out["opt_state"][name])
    for name in out["occ_states"]:
        assert torch.equal(kw["occ_states"][name], out["occ_states"][name])
    assert kw["start_step"] == 3 and int(state2["opt_state"]["count"]) == 3
    out2 = ttrainer.meta_trainer(P2, scene().tcfg, state2, opt2, None, None, logger2,
                                 occ_cfg=scene().tocc_cfg, device_pools=pools,
                                 draws=ttrainer.LoopDraws(1, "cpu"), device="cpu", **kw)
    logger2.close()
    assert out2["loop"]["last_step"] == 5 and int(out2["opt_state"]["count"]) == 5
    assert [s["step"] for s in out2["loop"]["steps"]] == [4, 5]
    assert tck.load_checkpoint(logger2.logdir, "last")["step"] == 5


def test_loop_refuses_a_mesh_and_a_missing_card(tmp_path):
    P = loop_P()
    state, opt, logger, pools, _ = _port_run(str(tmp_path), P)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ttrainer.meta_trainer(P, scene().tcfg, state, opt, None, None, logger,
                              mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="none is available"):
            ttrainer.meta_trainer(P, scene().tcfg, state, opt, None, None, logger)
    logger.close()
    # without a process group the sum over processes leaves the meters as they are
    ml = tlogging.MetricLogger()
    ml.update(loss=2.0)
    ml.synchronize_between_processes()
    assert (ml.loss.count, ml.loss.total) == (1, 2.0)


def test_logger_versions_its_run_directory(tmp_path):
    first = tlogging.Logger("r", logs_root=str(tmp_path))
    first.log("hello")
    first.close()
    second = tlogging.Logger("r", logs_root=str(tmp_path))
    second.close()
    assert first.logdir.name == "r" and second.logdir.name == "r_v1"
    assert "hello" in (first.logdir / "log.txt").read_text()
