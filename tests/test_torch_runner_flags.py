"""Every M9 flag through the port's own entry point (``runner.main``, what
``python -m acn_tpu_torch`` runs), on the micro dataset of
``test_torch_runner.py``: ``--algo maml|reptile``, ``--fim``,
``--optimizer adamw|sgd``, ``--nerf_variant vanilla`` with ``--dir_encoding``
/ ``--bg_encoding frequency``, and ``--hash_layout corner``. The chunked
loss is not among them: ``train_chunk_rays`` is read from ``P`` by the
training step, but neither package's parser defines it (acn_tpu drops an
unknown key of a JSON config too), so no run of either entry point sets it;
``test_torch_chunked_loss.py`` drives it through ``make_meta_train_step``.

Each runs ``--op train`` for 3 steps (2 stratified warm-up steps, then the
packed-budget regime after the switch, whose eval runs with the flag too)
and then ``--op eval --tto 1`` of its ``last`` checkpoint, which
acn_tpu's ``build_context`` restores to the same weights. Held: the
regimes, finite metrics, the checkpoint, finite PSNR and SSIM. Parity with
acn_tpu of each flag's step is in the other M9 test files.
"""

import math
from pathlib import Path

import numpy as np
import pytest

from acn_tpu import runner as jrunner
from acn_tpu.utils.config import parse_args as jparse
from acn_tpu_torch import runner as trunner
from test_torch_runner import _argv, _same_tree, data_root, isolated  # noqa: F401
from torch_m9_util import one_thread  # noqa: F401  (pytestmark uses it)

pytestmark = pytest.mark.usefixtures("one_thread")


FLAGS = {
    "maml": ["--algo", "maml"],
    "reptile": ["--algo", "reptile", "--lr", "0.5"],
    "fim": ["--fim", "--fim_epsilon", "1e-2"],
    "adamw": ["--optimizer", "adamw"],
    "sgd": ["--optimizer", "sgd"],
    "vanilla": ["--nerf_variant", "vanilla", "--dir_encoding", "frequency",
                "--bg_encoding", "frequency"],
    "corner": ["--hash_layout", "corner"],
}


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_flag_trains_and_evaluates_through_the_runner(data_root, name):
    flags = FLAGS[name]
    out = trunner.main(_argv(data_root, "train_occ", "--fname", name, "--outer_steps", "3",
                             "--occ_warmup", "2", "--occ_auto_patience", "1",
                             "--eval_step", "3", "--save_step", "3", "--print_step", "1",
                             "--watchdog_timeout", "0", *flags), device="cpu")
    steps = out["loop"]["steps"]
    assert [s["regime"] for s in steps] == ["stratified", "stratified", "budget"]
    for s in steps:
        assert all(np.isfinite(np.asarray(v)).all() for v in s["metrics"].values()), s
    assert out["loop"]["eval_psnr"] and all(
        math.isfinite(float(np.ravel(p)[-1])) for p in out["loop"]["eval_psnr"])
    run = Path("logs") / name
    assert (run / "last.model").exists() and (run / "last.optim").exists()
    argv = _argv(data_root, "eval", "--checkpoint_path", str(run), "--prefix", "last",
                 "--fname", f"{name}_eval", *flags)
    _same_tree(out["model"].params(),
               jrunner.build_context(jparse(argv), "eval")["variables"]["params"])
    results = trunner.main(argv + ["--tto", "1", "--test_batch_size", "1"], device="cpu")
    assert [r["tto"] for r in results] == [1]
    for r in results:
        assert math.isfinite(r["psnr"]) and -1.0 <= r["ssim"] <= 1.0
