"""The port's flag parser and merge rules (acn_tpu_torch.utils.config)
against acn_tpu's, and the forward of ``__graft_entry__.entry()`` in both
packages.

Exact throughout: for each of ``configs/{train,train_occ,eval,view}.json``,
with no overrides, with CLI overrides, and with a checkpoint's ``P.json``
that pins the architecture (and carries near and far already normalized,
per field or in the older both-or-neither form, or lacks
``hash_dense_levels``), the port's namespace equals acn_tpu's key for key.
A non-train op's ``fname`` is ``{op}_{timestamp}``: it is compared up to the
timestamp.

``entry()``: the 4-expert container of ``__graft_entry__`` (16 cell-layout
levels of 2^19 rows) on its (8192, 6) points, JAX's weights carried across
without a copy; rtol 1e-5 / atol 1e-6 (float32 MLPs whose products sum in
another order).
"""

import dataclasses
import json
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from acn_tpu.utils import config as jconfig
from acn_tpu_torch.utils import config as tconfig

REPO = Path(__file__).resolve().parent.parent
CONFIGS = ("train", "train_occ", "eval", "view")
CLI = ["--support_rays", "77", "--near", "5", "--far", "900", "--tto", "0,2", "--use_occ",
       "--seed", "3", "--dim_hidden", "32", "--hash_dense_levels", "--prefix", "last"]
ARCH = {"num_submodules": 2, "dim_hidden": 16, "color_hidden": 16, "log2_hashmap_size": 12,
        "hash_levels": 4, "hash_features": 4, "hash_layout": "cell", "bg_hidden": 8,
        "no_bg_nerf": False, "max_res": 512}


def _ckpt(tmp_path, kind):
    """A run directory whose ``last.P.json`` is of the given kind."""
    run = tmp_path / f"run_{kind}"
    run.mkdir()
    cfg = {**ARCH, "inner_lr": 0.5, "near": 0.001, "far": 1.5, "occ_regime": "budget",
           "use_occ": True, "occ_budget_per_ray": 32, "hash_dense_levels": 1}
    if kind == "split":
        cfg.update(near_normalized=1, far_normalized=1, near_far_normalized=1)
    elif kind == "legacy":  # before near and far were tracked per field
        cfg.update(near_far_normalized=1)
        del cfg["hash_dense_levels"]
    (run / "last.P.json").write_text(json.dumps(cfg))
    return run


def _parse(mod, argv):
    ns = vars(mod.parse_args(argv))
    if ns["op"] != "train":
        assert re.fullmatch(rf"{ns['op']}_\d{{8}}_\d{{6}}", ns["fname"]), ns["fname"]
        ns["fname"] = f"{ns['op']}_<timestamp>"
    return ns


@pytest.mark.parametrize("case", ["plain", "cli", "ckpt_split", "ckpt_legacy",
                                  "ckpt_split_cli"])
@pytest.mark.parametrize("name", CONFIGS)
def test_namespace_equals_acn_tpus(tmp_path, name, case):
    argv = ["--configPath", str(REPO / "configs" / f"{name}.json")]
    if case.startswith("ckpt"):
        argv += ["--checkpoint_path", str(_ckpt(tmp_path, case.split("_")[1])),
                 "--prefix", "last"]
    if case.endswith("cli"):
        argv += CLI
    want = _parse(jconfig, argv)
    got = _parse(tconfig, argv)
    assert got == want
    if case.startswith("ckpt"):  # the architecture came from the checkpoint
        assert all(got[k] == v for k, v in ARCH.items())
        assert got["hash_dense_levels"] == (0 if "legacy" in case else 1)


def test_the_parsers_have_the_same_flags():
    """The port adds no flag and drops none: every action's option strings,
    dest, default, choices, nargs, const and type are acn_tpu's."""
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.const,
                         a.type, type(a).__name__) for a in parser._actions}

    assert flags(tconfig.build_parser()) == flags(jconfig.build_parser())
    assert tconfig.ARCH_KEYS == jconfig.ARCH_KEYS


@pytest.mark.parametrize("argv", [[], ["--fim", "--no_bg_nerf", "--algo", "maml",
                                       "--inner_lr", "0.0031", "--lr", "0.00021"]])
def test_default_experiment_fname_equals_acn_tpus(argv):
    P = jconfig.parse_args(["--op", "train", *argv])
    assert tconfig.default_experiment_fname(P) == jconfig.default_experiment_fname(P)
    assert tconfig.namespace_to_jsonable(P) == jconfig.namespace_to_jsonable(P)


def test_cli_pins_against_json_and_checkpoint(tmp_path):
    run = _ckpt(tmp_path, "split")
    argv = ["--configPath", str(REPO / "configs" / "eval.json"), "--checkpoint_path",
            str(run), "--prefix", "last", "--inner_lr", "0.25", "--num_submodules", "6",
            "--near", "2"]
    P = tconfig.parse_args(argv)
    assert P.inner_lr == 0.25  # CLI over the checkpoint
    assert P.num_submodules == 2  # the architecture over the CLI
    # a fresh near (CLI) is in meters again; far is the JSON's, fresh too
    assert (P.near, P.near_normalized, P.far_normalized) == (2.0, 0, 0)


def test_entry_forward_matches_jax():
    """``__graft_entry__.entry()``'s container forward in both packages."""
    import jax

    import __graft_entry__
    from acn_tpu_torch import convert
    from acn_tpu_torch.models import container as tcont
    from acn_tpu_torch.models.container import Container
    from acn_tpu_torch.models.nn import tree_map

    fn, (jvars, x) = __graft_entry__.entry()
    want = np.asarray(jax.jit(fn)(jvars, x))
    # entry()'s config, from a small build of the same problem
    d = dataclasses.asdict(__graft_entry__._toy_problem(K=1, hash_log2=4, hash_levels=2)[0])
    d["num_submodules"] = 4
    d["expert"]["hash"].update(levels=16, log2_hashmap_size=19)
    cfg = convert.config_from_dict(d)
    with warnings.catch_warnings():  # views of JAX's read-only buffers, not copies
        warnings.simplefilter("ignore", UserWarning)
        t = lambda a: torch.from_numpy(np.asarray(a))
        params, bufs = jvars["params"], jvars["buffers"]
        model = Container(cfg, tree_map(t, params["experts"]), tree_map(t, params["bg_mlp"]),
                          t(bufs["centroids"]), t(bufs["expert_aabbs"]),
                          t(bufs["global_aabb"]))
    with torch.no_grad():
        got = tcont.container_forward(model, torch.from_numpy(np.asarray(x))).numpy()
    assert got.shape == want.shape == (8192, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
