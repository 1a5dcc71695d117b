"""Shared set-up of the viewer tests (test_torch_viewer_engine.py,
test_torch_viewer_runners.py, test_torch_viewer_frame.py,
test_torch_viewer_gui.py): a micro run on disk and the view contexts of
both packages over it. It holds no test of its own.

The run: ``toy.write_dataset_dir`` (2 experts, 4 train and 2 val views of
24 × 32), a checkpoint ``last`` of the micro model of
``test_torch_eval_card.TINY`` (2 hash levels, 8-wide MLPs, σ-head bias +2,
30 % occupied grids, packed budget 32 from ``configs/train_occ.json``) and a
continual batch ``b000`` of 3 views (``toy.write_continual_batch``). The
contexts are ``build_context(P, "view")`` of ``configs/view.json`` with the
run's checkpoint, its ray samples and chunk points cut to ``TINY``'s.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from acn_tpu import runner as jrunner
from acn_tpu.utils.config import parse_args as jparse
from acn_tpu_torch import toy
from acn_tpu_torch import runner as trunner
from acn_tpu_torch.data import dataset as tds
from acn_tpu_torch.data import tasks as ttasks
from acn_tpu_torch.models.nn import tree_map
from acn_tpu_torch.utils import checkpoint as tck
from acn_tpu_torch.utils.config import parse_args as tparse
from test_torch_eval import jax_render_draws
from test_torch_eval_card import K, TINY, _model_with_content

REPO = Path(__file__).resolve().parent.parent
H, W = 24, 32
BATCH_VIEWS = 3


@pytest.fixture(scope="module")
def viewer_run(tmp_path_factory):
    """The run's root: ``data/`` (with ``out/example/continual/b000``) and
    ``run/`` (``last``)."""
    root = tmp_path_factory.mktemp("viewrun")
    data = toy.write_dataset_dir(root / "data", K=K, train_cams=4, val_cams=2, H=H, W=W)
    toy.write_continual_batch(data, "b000", views=BATCH_VIEWS, K=K, H=H, W=W)
    argv = ["--configPath", str(REPO / "configs" / "train_occ.json"),
            "--data_path", str(root / "data"), *TINY, "--fname", "fixture"]
    P, model, occ = _model_with_content(argv, root / "data")
    tck.save_checkpoint(root / "run", "last", model, occ_states=occ, P=P, step=8, best=1.0)
    return root


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    """Logs and both packages' ray and route caches under ``tmp_path``; the
    runs' loggers write their text logs only (TensorBoard's import, which
    loads TensorFlow, would take ~19 s of a test)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tds, "RAY_CACHE", tmp_path / "port_rays")
    monkeypatch.setattr(ttasks, "ROUTE_CACHE", tmp_path / "routes")
    monkeypatch.setenv("ACN_TPU_RAY_CACHE", str(tmp_path / "jax_rays"))
    monkeypatch.setenv("ACN_TPU_CACHE", str(tmp_path / "jax_cache"))


def view_argv(root, *extra):
    return ["--configPath", str(REPO / "configs" / "view.json"),
            "--data_path", str(root / "data"), *TINY, "--checkpoint_path",
            str(root / "run"), "--prefix", "last", "--fname", "view", *extra]


def contexts(root, *extra, op="view"):
    """(acn_tpu's context, the port's on the CPU) of ``op`` over the run."""
    argv = view_argv(root, *extra)
    if op == "train":  # the samplers of the dataset, the checkpoint's weights
        argv = ["--configPath", str(REPO / "configs" / "train_occ.json"),
                "--data_path", str(root / "data"), *TINY, "--checkpoint_path",
                str(root / "run"), "--prefix", "last", "--fname", "train", *extra]
    return jrunner.build_context(jparse(argv), op), trunner.build_context(
        tparse(argv), op, device="cpu")


def runner_draws(P):
    """The render draws of ``acn_tpu``'s ``RuntimeAdaptRunner`` as the
    port's runner asks for them (``TTODraws``'s function form, step i over
    the runner's life): ``PRNGKey(P.seed)`` split once per step, then
    ``jax_render_draws`` of that step's key (occupancy render)."""
    keys = []

    def fn(what, b, i, shape):
        while len(keys) <= i:
            key = keys[-1][0] if keys else jax.random.PRNGKey(int(P.seed))
            keys.append(jax.random.split(key))
        u, phase = jax_render_draws(keys[i][1], True, shape[0], P)
        return u if what == "u" else phase

    return fn


def jax_params(runner):
    """acn_tpu's runner's live parameters as numpy."""
    return jax.device_get(runner.variables["params"])


def assert_tree_equal(port_tree, jax_tree):
    """Leaf by leaf by key, bit for bit."""
    tree_map(lambda a, b: np.testing.assert_array_equal(a.detach().cpu().numpy(),
                                                        np.asarray(b)),
             port_tree, jax_tree)


def state_clone(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def assert_state_equal(model, state):
    got = model.state_dict()
    assert set(got) == set(state)
    for k, v in state.items():
        assert torch.equal(got[k], v), k
