"""The port's run summary (acn_tpu_torch.scripts.summarize_run) against
acn_tpu's, on the logs that the port's own ``--op train`` and ``--op eval``
wrote (a ``toy`` dataset of 2 experts, the micro model of
``test_torch_runner.py``): both packages' ``--json`` output equal, and every
step line, eval line and TTO row of those logs parsed. This also holds the
port's log lines to ``acn_tpu``'s formats. The text rendering is compared
too, and on a log of every line form with a timestamp and without.
"""

import json
import sys

import pytest

from acn_tpu.scripts import summarize_run as jsum
from acn_tpu_torch import runner as trunner
from acn_tpu_torch import toy
from acn_tpu_torch.data import dataset as tds
from acn_tpu_torch.data import tasks as ttasks
from acn_tpu_torch.scripts import summarize_run as tsum
from test_torch_runner import _argv

STEPS, TTO = 4, "0,1"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(train run dir, eval run dir) of the port under ``<tmp>/logs``."""
    tmp = tmp_path_factory.mktemp("summary")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setattr(tds, "RAY_CACHE", tmp / "rays")
        mp.setattr(ttasks, "ROUTE_CACHE", tmp / "routes")
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        root = tmp / "ds"
        toy.write_dataset_dir(root, K=2, train_cams=4, val_cams=2, H=24, W=32)
        trunner.main(_argv(root, "train_occ", "--fname", "tr", "--outer_steps", str(STEPS),
                           "--occ_warmup", "2", "--occ_auto_patience", "1",
                           "--eval_step", "2", "--save_step", "4", "--print_step", "1",
                           "--watchdog_timeout", "0"), device="cpu")
        trunner.main(_argv(root, "eval", "--checkpoint_path", "logs/tr", "--prefix", "last",
                           "--tto", TTO, "--test_batch_size", "1", "--fname", "ev"),
                     device="cpu")
    return tmp / "logs" / "tr", tmp / "logs" / "ev"


def _json(mod, capsys, *runs):
    assert mod.main(["--json", *map(str, runs)]) == 0
    return json.loads(capsys.readouterr().out)


def test_json_of_the_ports_logs_equals_acn_tpus(runs, capsys):
    got, want = _json(tsum, capsys, *runs), _json(jsum, capsys, *runs)
    assert got == want
    tr, ev = got[str(runs[0])], got[str(runs[1])]
    lines = runs[0].joinpath("log.txt").read_text().splitlines()
    assert [s["step"] for s in tr["steps"]] == list(range(1, STEPS + 1))
    assert len(tr["steps"]) == sum(" step " in ln and " loss: " in ln for ln in lines)
    assert [e["step"] for e in tr["evals"]] == [2, 4]
    assert len(tr["evals"]) == sum("[eval] step" in ln for ln in lines)
    assert [r["tto"] for r in ev["tto"]] == [0, 1] and not ev["steps"]
    assert tr["last"]["of"] == STEPS and tr["best_eval"] in tr["evals"]


def test_text_of_the_ports_logs_equals_acn_tpus(runs, capsys):
    for mod in (tsum, jsum):
        assert mod.main([str(runs[0]), str(runs[1] / "log.txt"), "missing_run"]) == 0
    out = capsys.readouterr()
    got, want = out.out.split("== ")[1:3], out.out.split("== ")[3:5]
    assert got == want and "eval PSNR (last 8)" in got[0] and "tto    1" in got[1]
    assert out.err.count("(no log.txt)") == 2


def test_every_line_form_parses_alike(tmp_path, capsys):
    log = tmp_path / "log.txt"
    log.write_text("\n".join([
        "[26-01-02 03:04:05] step 1/3 loss: 0.1250 (0.1250)  psnr_in: 9.01 (9.01)  "
        "psnr_out: 8.50 (8.50) | 1.25s/it (12,345 rays/s)",
        "step 2/3 loss: 1e-3 (0.06)  psnr_in: 10.0 (9.5)  psnr_out: 9.0 (8.75) "
        "| 0.50s/it (99 rays/s)",
        "[26-01-02 03:04:06] [eval] step 2 query PSNR 11.25",
        "     0   12.345   0.5000      nan       3.00",
        "     2      nan      nan      nan       4.00",
        "training complete at step 3; best eval PSNR 11.250",
        "a line of nothing",
    ]))
    got, want = _json(tsum, capsys, log), _json(jsum, capsys, log)
    assert json.dumps(got) == json.dumps(want)  # nan included
    s = got[str(log)]
    assert len(s["steps"]) == 2 and len(s["tto"]) == 2 and s["done"]["final_step"] == 3
    assert tsum.render_text("x", s) == jsum.render_text("x", s)
    assert tsum.render_text("y", {}) == jsum.render_text("y", {})
