"""The vanilla (frequency-encoded) expert, the frequency encodings and the
corner hash layout in the port (acn_tpu_torch.models.{vanilla, encodings,
ngp, container}, ``convert``, ``runner.build_model_configs``) against
acn_tpu.

* ``frequency_encode`` and the NGP expert's ``frequency`` direction
  encoding; the container's ``frequency`` background encoding;
* the vanilla expert's forward and gradient (trunk with a skip, σ and geo
  heads, color MLP, SH or frequency directions), its density, and its
  weights carried across both ways;
* the corner-layout encode (one (levels · 2^log2, F) table, 8 hashed
  corners per point and level), forward and table gradient, in all three
  interpolations, bit for bit (the same gathers and products in the same
  order; the scatter-add of the gradient sums at most a few terms per row);
* a FoMAML meta-gradient of the budget regime with vanilla experts and with
  corner-layout tables, both packages from one converted state, with
  JAX's draws replayed (tolerances of ``torch_m9_util.check_meta_grads``);
* the runner's model config for ``--nerf_variant vanilla`` (hidden 256
  unless ``--dim_hidden`` > 64, depth ≥ 8) and ``--hash_layout corner``,
  field for field.

Tolerances: MLP outputs and gradients rtol 1e-5 / atol 1e-6 (matmuls sum in
other orders); elementwise encodings rtol 1e-6 / atol 1e-6 (cos and sin of
the two libraries may differ by an ulp).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.models import container as jcont
from acn_tpu.models import encodings as jenc
from acn_tpu.models import ngp as jngp
from acn_tpu.models import vanilla as jvan
from acn_tpu.models.encodings import HashGridConfig as JHash
from acn_tpu.models.ngp import NGPConfig as JNGP
from acn_tpu.models.vanilla import VanillaConfig as JVanilla
from acn_tpu_torch import convert
from acn_tpu_torch.models import container as tcont
from acn_tpu_torch.models import encodings as tenc
from acn_tpu_torch.models import ngp as tngp
from acn_tpu_torch.models import vanilla as tvan
from acn_tpu_torch.models.nn import tree_leaves, tree_map
from test_torch_train_step import _leaves, _np
from torch_m9_util import MICRO_HASH, check_meta_grads, meta_grads, scene
from torch_m9_util import one_thread  # noqa: F401  (pytestmark uses it)

pytestmark = pytest.mark.usefixtures("one_thread")


REPO = Path(__file__).resolve().parents[1]
VANILLA = JVanilla(hidden=16, sigma_depth=4, skips=(2,), color_hidden=8, color_depth=2,
                   pe_dim_xyz=4)
CORNER = JNGP(hidden=8, color_hidden=8, color_depth=2,
              hash=JHash(**{**MICRO_HASH, "layout": "corner", "dense_levels": False}))


def _pts(n=40, seed=0, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return np.concatenate([x, d], axis=-1)


# --------------------------------------------------------------- encodings


@pytest.mark.parametrize("include_input,use_pi", [(True, False), (False, True)])
def test_frequency_encode_matches_jax(include_input, use_pi):
    x = _pts(25)[:, :3] * 3.0
    want = jenc.frequency_encode(jnp.asarray(x), 5, include_input, use_pi)
    got = tenc.frequency_encode(torch.from_numpy(x), 5, include_input, use_pi)
    assert got.shape[-1] == tenc.frequency_out_dim(3, 5, include_input)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("interpolation", ["Linear", "Smoothstep", "Nearest"])
def test_corner_encode_and_table_gradient_match_jax(interpolation):
    kw = {**MICRO_HASH, "layout": "corner", "dense_levels": False,
          "interpolation": interpolation, "log2_hashmap_size": 6}
    jcfg, tcfg = JHash(**kw), tenc.HashGridConfig(**kw)
    table = np.asarray(jenc.init_hash_table(jax.random.PRNGKey(0), jcfg))
    tt = tenc.init_hash_table(tcfg, generator=torch.Generator().manual_seed(0))
    assert tuple(tt.shape) == table.shape == (2 * 64, 2)
    x = np.random.default_rng(1).random((60, 3)).astype(np.float32)
    g = np.random.default_rng(2).normal(size=(60, 4)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jenc.hash_encode(t, jnp.asarray(x), jcfg),
                        jnp.asarray(table))
    tab = torch.from_numpy(table.copy()).requires_grad_(True)
    got = tenc.hash_encode(tab, torch.from_numpy(x), tcfg)
    (gt,) = torch.autograd.grad(got, tab, torch.from_numpy(g))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_allclose(_np(gt), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-9)


def test_corner_encode_bf16_cells_match_jax():
    """Under bf16 the level resolution is rounded to bf16 before the
    multiply, as ``jnp.asarray(res, x01.dtype)`` rounds it: the corner
    table's rows are the same."""
    kw = {**MICRO_HASH, "layout": "corner", "dense_levels": False, "max_res": 255,
          "log2_hashmap_size": 8}
    jcfg, tcfg = JHash(**kw), tenc.HashGridConfig(**kw)
    table = np.asarray(jenc.init_hash_table(jax.random.PRNGKey(3), jcfg))
    x = np.random.default_rng(4).random((80, 3)).astype(np.float32)
    want = jenc.hash_encode(jnp.asarray(table, jnp.bfloat16),
                            jnp.asarray(x, jnp.bfloat16), jcfg)
    got = tenc.hash_encode(torch.from_numpy(table).bfloat16(),
                           torch.from_numpy(x).bfloat16(), tcfg)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-5)


# ------------------------------------------------------------------ experts


def _vanilla_params(cfg, seed=0):
    jp = jax.device_get(jvan.init_vanilla(jax.random.PRNGKey(seed), cfg))
    return jp, convert._tensors(jp, "cpu")


@pytest.mark.parametrize("dir_encoding", ["spherical", "frequency"])
def test_vanilla_expert_forward_and_gradient_match_jax(dir_encoding):
    cfg = dataclasses.replace(VANILLA, dir_encoding=dir_encoding)
    tcfg = convert.config_from_dict({"nerf_variant": "vanilla",
                                     "expert": dataclasses.asdict(cfg)}).expert
    assert tcfg == tvan.VanillaConfig(**dataclasses.asdict(cfg))
    jp, tp = _vanilla_params(cfg)
    xd = _pts(33, seed=5)
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    w = np.random.default_rng(6).normal(size=(33, 4)).astype(np.float32)
    f = lambda p: jnp.sum(jnp.asarray(w) * jvan.vanilla_forward(p, cfg, jnp.asarray(aabb),
                                                                  jnp.asarray(xd)))
    want, jg = jax.value_and_grad(f)(jax.tree.map(jnp.asarray, jp))
    tp = tree_map(lambda a: a.requires_grad_(True), tp)
    out = tvan.vanilla_forward(tp, tcfg, torch.from_numpy(aabb), torch.from_numpy(xd))
    got = (torch.from_numpy(w) * out).sum()
    tg = torch.autograd.grad(got, tree_leaves(tp))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    it = iter(tg)
    for a, b in zip(_leaves(tree_map(lambda _: next(it), tp)), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    sig = tvan.vanilla_density(tp, tcfg, torch.from_numpy(aabb), torch.from_numpy(xd[:, :3]))
    np.testing.assert_allclose(_np(sig), np.asarray(jvan.vanilla_density(
        jp, cfg, aabb, jnp.asarray(xd[:, :3]))), rtol=1e-5, atol=1e-7)
    assert tvan.param_group_labels(tp) == jvan.param_group_labels(jp)


def test_ngp_frequency_directions_and_background_match_jax():
    jcfg = JNGP(hidden=8, color_hidden=8, color_depth=2, dir_encoding="frequency",
                hash=JHash(**MICRO_HASH))
    tcfg = convert.config_from_dict({"expert": dataclasses.asdict(jcfg)}).expert
    jp = jax.device_get(jngp.init_ngp(jax.random.PRNGKey(1), jcfg))
    tp = convert._tensors(jp, "cpu")
    xd = _pts(21, seed=7)
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    np.testing.assert_allclose(
        _np(tngp.ngp_forward(tp, tcfg, torch.from_numpy(aabb), torch.from_numpy(xd))),
        np.asarray(jngp.ngp_forward(jp, jcfg, jnp.asarray(aabb), jnp.asarray(xd))),
        rtol=1e-5, atol=1e-6)
    sc = scene("budget", nerf_variant="vanilla", expert=VANILLA, bg_encoding="frequency")
    assert sc.tcfg.bg_enc_dim == sc.jcfg.bg_enc_dim == 27
    d = xd[:, 3:6]
    np.testing.assert_allclose(
        _np(tcont.background_color(sc.model, torch.from_numpy(d))),
        np.asarray(jcont.background_color(sc.jvars, sc.jcfg, jnp.asarray(d))),
        rtol=1e-5, atol=1e-6)


def test_vanilla_and_corner_containers_carry_across_and_route():
    for sc in (scene("budget", nerf_variant="vanilla", expert=VANILLA),
               scene("budget", expert=CORNER)):
        back = convert.to_jax_variables(sc.model)
        assert jax.tree.structure(back) == jax.tree.structure(sc.jvars)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(sc.jvars)):
            np.testing.assert_array_equal(a, b)
        labels = tcont.param_group_labels(sc.model.params())
        assert labels == jcont.param_group_labels(sc.jvars, sc.jcfg)
        xd = _pts(50, seed=8, lo=-0.9, hi=0.9)
        np.testing.assert_allclose(
            _np(tcont.container_forward(sc.model, torch.from_numpy(xd))),
            np.asarray(jcont.container_forward(sc.jvars, sc.jcfg, jnp.asarray(xd))),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            _np(tcont.container_density(sc.model, torch.from_numpy(xd[:, :3]))),
            np.asarray(jcont.container_density(sc.jvars, sc.jcfg, jnp.asarray(xd[:, :3]))),
            rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- training steps


@pytest.mark.parametrize("what", ["vanilla", "corner"])
def test_budget_meta_gradient_matches_jax(what):
    sc = (scene("budget", nerf_variant="vanilla", expert=VANILLA) if what == "vanilla"
          else scene("budget", expert=CORNER))
    jout, tout, _ = meta_grads("fomaml", "budget", sc=sc)
    check_meta_grads(jout, tout)


# ------------------------------------------------------------------- runner


@pytest.mark.parametrize("argv", [
    ["--nerf_variant", "vanilla"],
    ["--nerf_variant", "vanilla", "--dim_hidden", "128", "--sigma_depth", "2",
     "--dir_encoding", "frequency", "--bg_encoding", "frequency"],
    ["--hash_layout", "corner", "--dir_encoding", "frequency"],
])
def test_runner_model_config_matches_acn_tpu(argv):
    from acn_tpu import runner as jrunner
    from acn_tpu.utils import config as jconfig
    from acn_tpu_torch import runner as trunner
    from acn_tpu_torch.utils import config as tconfig

    base = ["--op", "train", "--configPath", str(REPO / "configs" / "train_occ.json")]
    meta = {"boundary_margin": 1.1, "cluster_2d": True}
    want = jrunner.build_model_configs(jconfig.parse_args(base + argv), meta)
    got = trunner.build_model_configs(tconfig.parse_args(base + argv), meta)
    assert got == convert.config_from_dict(dataclasses.asdict(want))
    if "vanilla" in argv:
        assert got.expert.sigma_depth >= 8
        assert got.expert.hidden == (256 if "--dim_hidden" not in argv else 128)
