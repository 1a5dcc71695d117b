"""The port's runner (acn_tpu_torch.runner) against acn_tpu's, on a prepared
dataset directory that ``toy.write_dataset_dir`` writes in ``tmp_path``
(2 experts, 6 train and 2 val images of 24 × 32) with a micro model
(``TINY``: 2 hash levels, 8-wide MLPs, 64 support and 32 query rays).

* ``build_context`` for ``train`` (with occupancy) and ``bench``: the
  model and occupancy configs field for field, near and far, every
  sampler's arrays and the card sampler's pools, the premarked grids and the
  optimizer's labels, all exact; the restored weights of ``bench`` exact.
* The two entry points (tests/test_torch_runner_runs.py, split from this
  file so that the test run spreads them over its workers): a short ``--op
  train`` of each package writes a checkpoint that the other's
  ``build_context(…, "eval")`` restores to the same arrays, grids and step;
  the port resumes its own run's optimizer.
* The refusals: an incomplete multi-process set-up, and ``python -m
  acn_tpu_torch`` without a card, which exits before any work; ``--op
  view`` reaches the viewer, which without viser raises ``acn_tpu``'s
  ImportError.

Both packages' ray and route caches point into ``tmp_path``; runs write
under ``tmp_path/logs``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from acn_tpu import runner as jrunner
from acn_tpu.models import container as jcont
from acn_tpu.utils.config import parse_args as jparse
from acn_tpu_torch import convert, toy
from acn_tpu_torch import runner as trunner
from acn_tpu_torch.data import dataset as tds
from acn_tpu_torch.data import tasks as ttasks
from acn_tpu_torch.models.nn import tree_map
from acn_tpu_torch.utils import checkpoint as tck
from acn_tpu_torch.utils.config import parse_args as tparse
from test_torch_eval_card import K, TINY

REPO = Path(__file__).resolve().parent.parent
@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    toy.write_dataset_dir(root, K=K, train_cams=6, val_cams=2, H=24, W=32)
    return root


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tds, "RAY_CACHE", tmp_path / "port_rays")
    monkeypatch.setattr(ttasks, "ROUTE_CACHE", tmp_path / "routes")
    monkeypatch.setenv("ACN_TPU_RAY_CACHE", str(tmp_path / "jax_rays"))
    monkeypatch.setenv("ACN_TPU_CACHE", str(tmp_path / "jax_cache"))


def _argv(data_root, config, *extra):
    return ["--configPath", str(REPO / "configs" / f"{config}.json"),
            "--data_path", str(data_root), *TINY, *extra]


def _np(t):
    return t.detach().cpu().numpy()


def _same_tree(port_tree, jax_tree):
    """A port tree of tensors against a JAX tree of arrays, leaf by leaf by key."""
    tree_map(lambda a, b: np.testing.assert_array_equal(_np(a), np.asarray(b)),
             port_tree, jax.device_get(jax_tree))


def test_build_context_train_equals_acn_tpus(data_root):
    argv = _argv(data_root, "train_occ", "--fname", "ctx")
    jctx = jrunner.build_context(jparse(argv), "train")
    tctx = trunner.build_context(tparse(argv), "train", device="cpu")
    jP, tP = jctx["P"], tctx["P"]
    assert vars(tP) == vars(jP)  # near and far normalized the same way, flags and all
    assert tctx["cfg"] == convert.config_from_dict(dataclasses.asdict(jctx["cfg"]))
    assert tctx["occ_cfg"] == convert.occ_config_from_dict(dataclasses.asdict(jctx["occ_cfg"]))
    for name in ("global_aabb", "expert_aabbs"):
        np.testing.assert_array_equal(tctx[name], jctx[name])
    # the samplers: cells, pools, image ids and eligible cells of every expert
    for tsamp, jsamp in ((tctx["train_sampler"], jctx["train_sampler"]),
                         (tctx["test_sampler"], jctx["test_sampler"])):
        assert len(tsamp.samplers) == len(jsamp.samplers) == K
        for a, b in zip(tsamp.samplers, jsamp.samplers):
            np.testing.assert_array_equal(a.ds.rays, b.ds.rays)
            np.testing.assert_array_equal(a.cells, b.cells)
            assert a.eligible == b.eligible
            for p, q in zip(a.pools + a.pool_imgs, b.pools + b.pool_imgs):
                np.testing.assert_array_equal(p, q)
    assert tctx["device_pools"].keys() == jctx["device_pools"].keys()
    for k, v in tctx["device_pools"].items():
        np.testing.assert_array_equal(v, np.asarray(jctx["device_pools"][k]), err_msg=k)
    # the premarked grids, exact
    _same_tree(tctx["occ_states"], jctx["occ_states"])
    assert float((tctx["occ_states"]["occs"] < 0).float().mean()) > 0.1
    # the optimizer's groups
    assert tctx["optimizer"].labels == jcont.param_group_labels(jctx["variables"], jctx["cfg"])
    assert tctx["mesh"] is None and tctx["step"] == 0


def test_build_context_bench_restores_without_the_dataset(data_root, tmp_path):
    """The context-only op: the weights of a checkpoint, no dataset."""
    argv = _argv(data_root, "train", "--fname", "fixture")
    ctx = trunner.build_context(tparse(argv), "train", device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in ctx["model"].parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    tck.save_checkpoint(tmp_path / "run", "best", ctx["model"], P=ctx["P"], step=3,
                        best=12.5)
    argv = _argv(data_root, "eval", "--checkpoint_path", str(tmp_path / "run"),
                 "--prefix", "best", "--fname", "b")
    t = trunner.build_context(tparse(argv), "bench", device="cpu")
    j = jrunner.build_context(jparse(argv), "bench")
    assert t["step"] == j["step"] == 3 and t["best"] == j["best"] == 12.5
    _same_tree(t["model"].params(), j["variables"]["params"])
    _same_tree(ctx["model"].params(), j["variables"]["params"])
    assert not {"test_metadata", "train_sampler"} & set(t)
    with pytest.raises(ValueError, match="Unsupported op"):
        trunner.build_context(tparse(argv), "serve", device="cpu")


@pytest.mark.parametrize("flags", [["--coordinator_address", "localhost:1"],
                                   ["--num_processes", "2", "--process_id", "0"],
                                   ["--num_processes", "2"]])
def test_mesh_and_multiprocess_runs_are_refused(data_root, flags):
    """A multi-process run without all three of the coordinator, the
    process count and this process's id is refused (``acn_tpu``'s error)
    before any work; the mesh flags alone are ignored in one process, as
    there."""
    with pytest.raises(ValueError, match="coordinator_address"):
        trunner.main(_argv(data_root, "train", *flags), device="cpu")


@pytest.mark.parametrize("op,item", [("view", "M12")])
def test_unported_ops_are_refused(data_root, op, item, tmp_path, monkeypatch):
    """No op of ``acn_tpu``'s runner is refused any more: ``view`` (ROADMAP
    item M12) builds the view context, with the checkpoint restored, and
    reaches ``launch_viewer``, which without viser raises ``acn_tpu``'s
    ImportError, word for word."""
    from test_torch_eval_card import _model_with_content

    P, model, occ = _model_with_content(_argv(data_root, "train_occ"), data_root)
    tck.save_checkpoint(tmp_path / "run", "last", model, occ_states=occ, P=P, step=3)
    argv = _argv(data_root, "view", "--op", op, "--checkpoint_path", str(tmp_path / "run"),
                 "--prefix", "last", "--fname", "view")
    ctx = trunner.build_context(tparse(argv), op, device="cpu")
    assert ctx["step"] == 3 and ctx["occ_states"] is not None
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             ctx["model"].params(), model.params())
    monkeypatch.setitem(sys.modules, "viser", None)  # absent, whatever the host has
    with pytest.raises(ImportError) as want:
        jrunner.main(argv)
    with pytest.raises(ImportError) as got:
        trunner.main(argv, device="cpu")
    assert str(got.value) == str(want.value) and "viser" in str(got.value)


def test_module_entry_point_without_a_card_exits_before_any_work(data_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the run would be real")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-m", "acn_tpu_torch", "--op", "train",
                          *_argv(data_root, "train_occ")], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "RuntimeError" in out.stderr and "CUDA" in out.stderr
    assert not (tmp_path / "logs").exists()  # no run was started
