"""The port's runner, continued from tests/test_torch_runner.py (split from
it so that the test run spreads them over its workers): a short ``--op
train`` of each package writes a checkpoint that the other's
``build_context(…, "eval")`` restores to the same arrays, grids and step;
the port resumes its own run's optimizer. The dataset, micro model and
caches are that file's (its fixtures).
"""

from pathlib import Path

from acn_tpu import runner as jrunner
from acn_tpu.utils.config import parse_args as jparse
from acn_tpu_torch import runner as trunner
from acn_tpu_torch.models import container as tcont
from acn_tpu_torch.utils import checkpoint as tck
from acn_tpu_torch.utils.config import parse_args as tparse
from test_torch_runner import _argv, _same_tree, data_root, isolated  # noqa: F401  (fixtures)


def _port_train(data_root, fname, *extra):
    out = trunner.main(_argv(data_root, "train_occ", "--fname", fname, "--outer_steps", "4",
                             "--occ_warmup", "2", "--occ_auto_patience", "1",
                             "--eval_step", "2", "--save_step", "2", "--print_step", "1",
                             "--watchdog_timeout", "0", *extra), device="cpu")
    return out, Path("logs") / fname


def test_port_train_run_restores_in_acn_tpu_and_resumes(data_root):
    out, run = _port_train(data_root, "port_run")
    regimes = [s["regime"] for s in out["loop"]["steps"]]
    assert regimes == ["stratified", "stratified", "budget", "budget"]
    for tag in ("best", "step2", "step4", "last"):
        assert (run / f"{tag}.model").exists(), tag
    argv = _argv(data_root, "eval", "--checkpoint_path", str(run), "--prefix", "last",
                 "--fname", "j_eval")
    jctx = jrunner.build_context(jparse(argv), "eval")
    assert jctx["step"] == 4 and len(jctx["test_metadata"]) == 2
    _same_tree(out["model"].params(), jctx["variables"]["params"])
    _same_tree(out["occ_states"], jctx["occ_states"])
    assert jctx["P"].occ_regime == "budget"  # the switch rode the checkpoint
    # the port resumes from step2: weights, grids and the optimizer's count
    resumed, _ = _port_train(data_root, "port_resume", "--checkpoint_path", str(run),
                             "--prefix", "step2")
    assert [s["step"] for s in resumed["loop"]["steps"]] == [3, 4]
    assert int(resumed["opt_state"]["count"]) == 4


def test_acn_tpu_train_run_restores_in_the_port(data_root):
    jrunner.main(_argv(data_root, "train", "--fname", "jax_run", "--outer_steps", "2",
                       "--eval_step", "2", "--save_step", "2", "--print_step", "1",
                       "--watchdog_timeout", "0"))
    run = Path("logs") / "jax_run"
    argv = _argv(data_root, "eval", "--checkpoint_path", str(run), "--prefix", "last",
                 "--fname", "eval")
    tctx = trunner.build_context(tparse(argv), "eval", device="cpu")
    jctx = jrunner.build_context(jparse(argv), "eval")
    assert tctx["step"] == jctx["step"] == 2
    assert tctx["occ_states"] is None  # train.json trains without grids
    _same_tree(tctx["model"].params(), jctx["variables"]["params"])
    # and the optimizer state a resume of it would start from
    P = tctx["P"]
    opt = trunner.build_optimizer(P, tcont.param_group_labels(tctx["model"].params()),
                                  grad_clip=P.grad_clip)
    state = tck.load_opt_state(run, "step2", opt.init(tctx["model"].params()), opt)
    assert int(state["count"]) == 2
