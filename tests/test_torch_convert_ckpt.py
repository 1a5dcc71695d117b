"""The port's reference-checkpoint converter
(acn_tpu_torch.scripts.convert_reference_ckpt) against acn_tpu's.

* ``reference_state_dict_to_variables`` on a reference-style state dict built
  as ``tests/test_convert_ckpt.py`` builds it (a 2-expert corner-layout
  model): both packages' converted trees equal leaf for leaf, by key, and
  the port's forward and background equal JAX's on the source model (atol
  1e-6, the JAX test's bound); ``to_reference_state_dict`` gives that test's
  state dict key for key, bit for bit.
* ``_tcnn_blob_to_corner`` on a blob with hashed and dense levels: bit-equal.
* ``main`` of both packages on a reference run directory (``best.model`` and
  ``best.P``) over a ``toy`` dataset's masks: the two checkpoints equal
  leaf for leaf, each package reads the other's, and every converted leaf
  equals the source model's.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from acn_tpu.models import container as jcont
from acn_tpu.models.encodings import HashGridConfig as JHashGridConfig
from acn_tpu.scripts import convert_reference_ckpt as jconv
from acn_tpu.utils import checkpoint as jck
from acn_tpu_torch import convert, toy
from acn_tpu_torch.models import container as tcont
from acn_tpu_torch.models.encodings import HashGridConfig
from acn_tpu_torch.models.nn import tree_map
from acn_tpu_torch.scripts import convert_reference_ckpt as tconv
from acn_tpu_torch.utils import checkpoint as tck
from test_convert_ckpt import _setup, _to_reference_sd


def _same(port_tree, jax_tree):
    """Leaf for leaf, by key (a port tree may list its keys in another order)."""
    tree_map(lambda a, b: np.testing.assert_array_equal(
        a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a), np.asarray(b)),
        port_tree, jax.device_get(jax_tree))


def _port_twin(jcfg, jvars):
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    return cfg, convert.from_jax_variables(jax.device_get(jvars), cfg, "cpu")


def test_state_dict_converts_as_in_acn_tpu():
    jcfg, jvars = _setup()
    sd = _to_reference_sd(jvars, jcfg)
    _, jtemplate = _setup()
    jtemplate = {"params": jax.tree.map(lambda a: a + 0.1, jtemplate["params"]),
                 "buffers": jtemplate["buffers"]}
    want = jconv.reference_state_dict_to_variables(sd, jcfg, jtemplate)
    cfg, template = _port_twin(jcfg, jtemplate)
    model = tconv.reference_state_dict_to_variables(sd, cfg, template)
    _same(tck.variables_of(model), want)
    _same(tck.variables_of(model), jvars)  # every leaf from the state dict
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (256, 6)))
    y = jcont.container_forward(jvars, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(
        tcont.container_forward(model, torch.from_numpy(x)).detach().numpy(),
        np.asarray(y), atol=1e-6)
    d = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (64, 3)))
    np.testing.assert_allclose(
        tcont.background_color(model, torch.from_numpy(d)).detach().numpy(),
        np.asarray(jcont.background_color(jvars, jcfg, jnp.asarray(d))), atol=1e-6)
    # without centroids and background head: the template's centroids, no head
    part = {k: v for k, v in sd.items() if not k.startswith(("bg_mlp", "centroids"))}
    want = jconv.reference_state_dict_to_variables(part, jcfg, jtemplate)
    model = tconv.reference_state_dict_to_variables(part, cfg, template)
    assert model.bg_mlp is None and "bg_mlp" not in want["params"]
    _same(tck.variables_of(model), want)


def test_to_reference_state_dict_is_the_inverse():
    jcfg, jvars = _setup()
    _, model = _port_twin(jcfg, jvars)
    got, want = tconv.to_reference_state_dict(model), _to_reference_sd(jvars, jcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_tcnn_blob_converts_bit_for_bit():
    kw = dict(levels=4, min_res=2, max_res=16, log2_hashmap_size=8, features_per_level=2,
              layout="corner")
    cfg, jcfg = HashGridConfig(**kw), JHashGridConfig(**kw)
    res = cfg.level_resolutions()
    sizes = [-(-min(2 ** 8, (int(r) + 1) ** 3) // 8) * 8 for r in res]
    assert min(sizes) < 2 ** 8 == max(sizes)  # dense and hashed levels
    blob = np.random.default_rng(3).normal(size=sum(sizes) * 2).astype(np.float32)
    got, want = tconv._tcnn_blob_to_corner(blob, cfg), jconv._tcnn_blob_to_corner(blob, jcfg)
    assert got.dtype == want.dtype and got.shape == (4 * 2 ** 8, 2)
    np.testing.assert_array_equal(got, want)


def test_main_of_both_packages_writes_the_same_checkpoint(tmp_path):
    toy.write_dataset_dir(tmp_path / "data", K=2, train_cams=2, val_cams=2, H=24, W=32)
    ref = {"num_submodules": 2, "sigma_depth": 2, "color_depth": 2, "dim_hidden": 8,
           "color_hidden": 8, "log2_hashmap_size": 6}
    flags = ["--data_path", str(tmp_path / "data"), "--data_dirname", "example",
             "--mask_dirname", "g22_grid_bm110_ss11"]
    ours = tconv.ours_from_reference_P(argparse.Namespace(**ref), tmp_path / "data",
                                       "example", "g22_grid_bm110_ss11")
    _, source = tconv.template_model(ours, seed=1)
    src = tmp_path / "ref"
    src.mkdir()
    torch.save(tconv.to_reference_state_dict(source), src / "best.model")
    torch.save(ref, src / "best.P")
    tconv.main(["--src", str(src), "--dst", str(tmp_path / "port"), *flags])
    jconv.main(["--src", str(src), "--dst", str(tmp_path / "jax"), *flags])
    got = tck.load_checkpoint(tmp_path / "port", "best")
    want = jck.load_checkpoint(tmp_path / "jax", "best")
    _same(got["variables"], want["variables"])
    _same(tck.load_checkpoint(tmp_path / "jax", "best")["variables"],
          jck.load_checkpoint(tmp_path / "port", "best")["variables"])
    cfg, _ = tconv.template_model(ours)
    model, _ = tck.restore_model(got, cfg, device="cpu")
    got_sd, want_sd = model.state_dict(), source.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    assert model.cfg.expert.hash.layout == "corner"
