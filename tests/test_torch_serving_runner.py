"""The runner's serving ops and the serving scripts of the port on the
micro run of ``test_torch_eval_card`` (a ``toy.write_dataset_dir`` dataset
of 2 experts and 24 × 32 views, a port checkpoint ``last`` with grids), on
the CPU.

* ``--op bake`` against ``acn_tpu``'s bake of the same checkpoint: the
  table f32 atol 1e-5, the grid exactly; then ``--op eval --baked_asset``
  with ``--tto 0,2``: the ``tto=2`` leg renders without adaptation (the log
  says so) and scores as ``tto=0``, bit for bit on the CPU.
* ``scripts/bench_render.py`` and ``scripts/measure_coarse_range.py`` on
  that run: their lines and results, finite.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from acn_tpu import runner as jrunner
from acn_tpu.pipelines import baking as jbake
from acn_tpu.utils.config import parse_args as jparse
from acn_tpu_torch import runner as trunner
from acn_tpu_torch.data import dataset as tds
from acn_tpu_torch.data import tasks as ttasks
from acn_tpu_torch.pipelines import baking as tbake
from test_torch_baking import _same_asset
from test_torch_eval_card import _eval_argv, eval_run  # noqa: F401 (a fixture)


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tds, "RAY_CACHE", tmp_path / "port_rays")
    monkeypatch.setattr(ttasks, "ROUTE_CACHE", tmp_path / "routes")
    monkeypatch.setenv("ACN_TPU_RAY_CACHE", str(tmp_path / "jax_rays"))


def test_op_bake_then_eval_the_asset(eval_run, isolated):
    bake_flags = ["--bake_resolution", "12"]
    argv = _eval_argv(eval_run, "--op", "bake", *bake_flags, "--fname", "bake")
    path = trunner.main(argv, device="cpu")
    assert Path(path).name == "baked_12.npz" and Path(path).parent.name == "bake"
    jctx = jrunner.build_context(jparse(_eval_argv(eval_run, "--op", "bake", *bake_flags,
                                                   "--fname", "jbake")), "bake")
    want = jbake.load_baked(jrunner.op_bake(jctx))
    _same_asset(tbake.load_baked(path, device="cpu"), want, 1e-5)

    ev = ["--baked_asset", path, "--tto", "0,2"]
    res = trunner.main(_eval_argv(eval_run, *ev, "--fname", "ev"), device="cpu")
    assert [r["tto"] for r in res] == [0, 2]
    scores = lambda r: [(v["psnr"], v["ssim"]) for v in r["views"]]
    assert res[1]["tto_losses"] == [] and scores(res[0]) == scores(res[1])
    log = (Path("logs") / "ev" / "log.txt").read_text()
    assert "TTO does not apply to a baked table; rendering tto=2 leg without adaptation" in log
    assert all(np.isfinite(r["psnr"]) and np.isfinite(r["ssim"]) for r in res)


def test_bench_render_script_on_a_run(eval_run, isolated, capsys):
    """``scripts/bench_render.py`` on the micro run on the CPU, one frame per
    regime at 12 × 16 (a routed preview, the routed and the strided dense
    frame; the other regimes differ from these in their numbers only), with
    a bake at 8³: one JSON line per regime, finite times, the plain scan (no
    kernel launch) on the CPU."""
    from acn_tpu_torch.scripts import bench_render

    out = bench_render.main(["--checkpoint_path", str(eval_run / "run"), "--prefix", "last",
                             "--hw", "12", "16", "--frames", "1", "--chunk_points", "20000",
                             "--skip", "preview_b4_half_res,preview_half_res,preview,"
                             "occ_budget,stratified",
                             "--baked", "8", "--baked_coarse", "16", "--device", "cpu"])
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    names = [x["regime"] for x in lines[:-1]]
    assert names == ["preview_b4", "routed_budget", "occ", "bake", "baked", "baked_half_res",
                     "baked_coarse"]
    assert all(x["device"] == "cpu" for x in lines[:-1]) and lines[-1] == out
    for name in names:
        res = out[name]
        assert all(np.isfinite(v) for v in res.values() if isinstance(v, float)), name
        assert res.get("scan_launches_per_frame", 0) == 0


def test_measure_coarse_range_script(eval_run, isolated):
    """``scripts/measure_coarse_range.py`` on the micro run's grids and its
    dataset: per (view, expert) a median fraction in [0, 1]."""
    from acn_tpu_torch.scripts import measure_coarse_range

    res = measure_coarse_range.main([str(eval_run / "run"), "last", "--data_path",
                                     str(eval_run / "data" / "out" / "example"), "--rays",
                                     "500", "--device", "cpu"])
    assert len(res["occupied"]) == 2 and len(res["median_fraction"]) == 3 * 2
    assert all(0.0 <= f <= 1.0 for f in res["median_fraction"])
    assert 0.0 < res["mean_hit_rate"] <= 1.0
