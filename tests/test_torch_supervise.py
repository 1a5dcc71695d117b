"""The port's supervisor (acn_tpu_torch/scripts/supervise_train.sh), with a
stub ``acn_tpu_torch/__main__.py`` first on ``PYTHONPATH`` and a stub
``sleep`` first on ``PATH``.

* A first launch starts fresh, writes ``logs/<fname>/last.model`` and exits
  42 (the loop watchdog's code); the supervisor relaunches it with
  ``--checkpoint_path logs/<fname> --prefix last`` and stops when it exits 0.
* Exit 43 (the startup watchdog's) and any other non-zero code relaunch too.
* The resume tag: ``last`` before the highest ``stepN`` (numerically:
  step10 after step9) before ``best``; the newest run directory
  ``logs/<fname>*`` that holds a checkpoint.
"""

import os
import subprocess
from pathlib import Path

import pytest

SCRIPT = Path(__file__).resolve().parent.parent / "acn_tpu_torch" / "scripts" / "supervise_train.sh"

STUB = '''import os, sys
from pathlib import Path
calls = Path(os.environ["STUB_CALLS"])
n = len(calls.read_text().splitlines()) if calls.exists() else 0
with open(calls, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
codes = [int(c) for c in os.environ["STUB_CODES"].split(",")]
if os.environ.get("STUB_WRITE"):
    run = Path("logs") / os.environ["STUB_WRITE"]
    run.mkdir(parents=True, exist_ok=True)
    (run / "last.model").write_text("x")
sys.exit(codes[min(n, len(codes) - 1)])
'''


def _supervise(tmp_path, codes, *args, write=""):
    pkg = tmp_path / "stub" / "acn_tpu_torch"
    pkg.mkdir(parents=True, exist_ok=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "__main__.py").write_text(STUB)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    (bin_dir / "sleep").write_text("#!/bin/sh\nexit 0\n")
    (bin_dir / "sleep").chmod(0o755)
    calls = tmp_path / "calls.txt"
    calls.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(tmp_path / "stub"),
           "PATH": f"{bin_dir}:{os.environ['PATH']}", "STUB_CALLS": str(calls),
           "STUB_CODES": ",".join(map(str, codes)), "STUB_WRITE": write}
    out = subprocess.run(["bash", str(SCRIPT), *args], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=60)
    return out, calls.read_text().splitlines()


def test_relaunches_on_42_resuming_last_then_stops_on_0(tmp_path):
    out, calls = _supervise(tmp_path, [42, 0], "run1", "--outer_steps", "8", write="run1")
    assert out.returncode == 0, out.stderr
    assert calls == ["--op train --fname run1 --outer_steps 8",
                     "--op train --fname run1 --checkpoint_path logs/run1 --prefix last "
                     "--outer_steps 8"]
    assert "fresh start" in out.stdout and "exited with 42" in out.stdout
    assert "resuming from logs/run1/last" in out.stdout and "training completed" in out.stdout


@pytest.mark.parametrize("code", [43, 1, 137])
def test_any_nonzero_exit_relaunches(tmp_path, code):
    out, calls = _supervise(tmp_path, [code, code, 0], "r")
    assert out.returncode == 0 and len(calls) == 3
    assert out.stdout.count(f"exited with {code}") == 2


def test_resume_tag_order(tmp_path):
    run = tmp_path / "logs" / "exp_v1"
    run.mkdir(parents=True)
    for tag in ("best", "step9", "step10", "step2"):
        (run / f"{tag}.model").write_text("x")
    (tmp_path / "logs" / "exp_v2").mkdir()  # newer, but holds no checkpoint
    _, calls = _supervise(tmp_path, [0], "exp")
    assert calls == ["--op train --fname exp --checkpoint_path logs/exp_v1 --prefix step10"]
    for name in ("step9", "step10", "step2"):
        (run / f"{name}.model").unlink()
    _, calls = _supervise(tmp_path, [0], "exp")
    assert calls[0].endswith("--prefix best")
    (run / "last.model").write_text("x")
    _, calls = _supervise(tmp_path, [0], "exp")
    assert calls[0].endswith("--prefix last")
