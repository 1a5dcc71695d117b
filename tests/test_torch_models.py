"""Parity of the PyTorch port's models (acn_tpu_torch.models) with acn_tpu.

The same inputs, made from a numpy seed, go through the JAX function and its
port; JAX weights come from acn_tpu's own init and are carried across with
acn_tpu_torch.convert. Tolerances, with their reasons:

* f32 MLP products: rtol 1e-5 — the two frameworks' matmuls sum in
  different orders, ~1e-6 relative per layer;
* hash-grid indices: exact (the int64 hash must equal the uint32 one);
* elementwise polynomials (SH) and the hash blend: rtol/atol ~1e-6 — the
  same f32 operations, summed in a possibly different order.

* hash-encode gradients: atol 1e-6 — the table gradient is a scatter-add
  whose order differs; bf16 cell decisions (floor, fraction) are exact.

``small_scene`` is shared with the other test_torch_* files.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.models import container as jcont
from acn_tpu.models import encodings as jenc
from acn_tpu.models import ngp as jngp
from acn_tpu.models.container import ContainerConfig as JContainerConfig
from acn_tpu.models.encodings import HashGridConfig as JHashGridConfig
from acn_tpu.models.ngp import NGPConfig as JNGPConfig
from acn_tpu.models.trunc_exp import trunc_exp as jtrunc_exp
from acn_tpu.occupancy import grid as jgrid
from acn_tpu.occupancy.grid import OccConfig as JOccConfig
from acn_tpu_torch import convert
from acn_tpu_torch.models import container as tcont
from acn_tpu_torch.models import encodings as tenc
from acn_tpu_torch.models import ngp as tngp
from acn_tpu_torch.models import nn as tnn
from acn_tpu.models import nn as jnn
from acn_tpu_torch.models.trunc_exp import trunc_exp as ttrunc_exp

# L4/F2, 2^10 rows, resolutions 4, 10, 25, 64: two dense levels, two hashed
SMALL_HASH = dict(levels=4, min_res=4, max_res=64, log2_hashmap_size=10,
                  features_per_level=2, layout="cell", dense_levels=True)


@functools.lru_cache(maxsize=None)
def _jax_init(jcfg):
    """acn_tpu's container init, jitted once per config and process (eager
    dispatch of the vmapped init compiles op by op, which is slow)."""
    return jax.jit(lambda *a: jcont.init_container(a[0], jcfg, *a[1:]))


def small_scene(K=4, sigma_bias=None, alpha_thre=0.0, budget=8, s_max=64,
                fill=0.3, seed=0, hash_kw=None, use_bg_nerf=True, expert=None,
                nerf_variant="instant", bg_encoding="spherical"):
    """A small K-expert scene in both packages (hash grid ``SMALL_HASH``
    unless ``hash_kw`` gives another; ``expert``, a JAX expert config,
    replaces the NGP expert, with ``nerf_variant`` naming its kind).

    Returns a namespace with the JAX side (jcfg, jvars, jocc_cfg, jocc) and
    the port's (tcfg, model, tocc_cfg, tocc) on the CPU, holding the same
    weights and occupancy, plus the render params P."""
    jcfg = JContainerConfig(
        num_submodules=K, boundary_margin=1.05, cluster_2d=True,
        use_bg_nerf=use_bg_nerf, bg_hidden=8, nerf_variant=nerf_variant,
        bg_encoding=bg_encoding,
        expert=expert or JNGPConfig(hidden=16, color_hidden=16, color_depth=2,
                                    hash=JHashGridConfig(**(hash_kw or SMALL_HASH))),
    )
    rng = np.random.default_rng(seed)
    quad = []
    for iy in (-1, 1):
        for iz in (-1, 1):
            quad.append([[-1.0, min(0.1 * iy, iy), min(0.1 * iz, iz)],
                         [1.0, max(0.1 * iy, iy), max(0.1 * iz, iz)]])
    boxes = np.asarray(quad[:K], np.float32)
    cents = np.asarray([[0.0, 0.55 * iy, 0.55 * iz] for iy in (-1, 1)
                        for iz in (-1, 1)][:K], np.float32)
    gaabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    jvars = jax.device_get(_jax_init(jcfg)(
        jax.random.PRNGKey(seed), jnp.asarray(cents), jnp.asarray(boxes),
        jnp.asarray(gaabb)))
    if sigma_bias is not None:
        b = jvars["params"]["experts"]["sigma_head"]["b"]
        jvars["params"]["experts"]["sigma_head"]["b"] = np.full_like(b, sigma_bias)

    jocc_cfg = JOccConfig(resolution=16, levels=1, alpha_thre=alpha_thre,
                          near_plane=0.0, far_plane=100.0)
    st = jax.device_get(jgrid.init_occ_state(jnp.asarray(gaabb), jocc_cfg))
    jocc = {
        "occs": np.stack([st["occs"]] * K),
        "binaries": rng.random((K, *st["binaries"].shape)) < fill,
        "aabbs": np.stack([st["aabbs"]] * K),
    }
    P = types.SimpleNamespace(
        ray_samples=96, chunk_points=4_000_000, bg_color_default="white",
        occ_s_max=s_max, occ_s_kept=64, occ_budget_per_ray=budget,
        occ_render_s_max=0,
    )
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    return types.SimpleNamespace(
        jcfg=jcfg, jvars=jvars, jocc_cfg=jocc_cfg,
        jocc={k: jnp.asarray(v) for k, v in jocc.items()},
        tcfg=tcfg, model=convert.from_jax_variables(jvars, tcfg, "cpu"),
        tocc_cfg=convert.occ_config_from_dict(dataclasses.asdict(jocc_cfg)),
        tocc=convert.from_jax_occ_states(jocc, "cpu"), P=P,
        boxes=boxes, gaabb=gaabb,
    )


@pytest.fixture(scope="module")
def scene():
    return small_scene()


def _np(t):
    return t.detach().cpu().numpy()


def test_trunc_exp_forward_and_grad():
    x = np.array([-200.0, -88.5, -3.0, 0.0, 2.5, 87.9, 88.0, 150.0], np.float32)
    g = np.linspace(-1, 1, x.size).astype(np.float32)
    jy, jvjp = jax.vjp(jtrunc_exp, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    ty = ttrunc_exp(xt)
    ty.backward(torch.tensor(g))
    # atol 1e-37: XLA on the CPU flushes subnormal results (exp(−88) ≈ 6e-39)
    # to zero, PyTorch keeps them
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-6, atol=1e-37)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jvjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-37)
    assert np.isfinite(_np(xt.grad)).all()


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
def test_sh_encode(levels):
    d = np.random.default_rng(levels).normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tenc.sh_encode(torch.from_numpy(d), levels)),
        np.asarray(jenc.sh_encode(jnp.asarray(d), levels)), rtol=1e-5, atol=1e-6)


def test_level_resolutions_match_at_full_width():
    kw = dict(levels=8, min_res=16, max_res=4096, log2_hashmap_size=17,
              features_per_level=4, layout="cell", dense_levels=True)
    t, j = tenc.HashGridConfig(**kw), JHashGridConfig(**kw)
    np.testing.assert_array_equal(t.level_resolutions(), j.level_resolutions())
    assert int(t.level_resolutions()[-1]) == 4095
    assert [t.level_rows(l) for l in range(8)] == [j.level_rows(l) for l in range(8)]
    assert t.level_rows(0) == 4096 and t.level_rows(1) == 42875


def _hash_points(n=512, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 3)).astype(np.float32)
    # cell faces of every level and the clamp ends: where floor could differ
    x[:64] = (rng.integers(0, 64, (64, 3)) / 64.0).astype(np.float32)
    x[64:80] = np.float32(1e-6)
    x[80:96] = np.float32(1 - 1e-6)
    return x


def test_hash_indices_exact_and_features(scene):
    cfg_t, cfg_j = scene.tcfg.expert.hash, scene.jcfg.expert.hash
    tables_np = [np.array(t[0]) for t in scene.jvars["params"]["experts"]["hash_table"]]
    x = _hash_points()
    tt = [torch.from_numpy(t) for t in tables_np]
    jt = [jnp.asarray(t) for t in tables_np]
    for l in range(cfg_t.levels):
        _, h_t, frac_t = tenc._cell_level_lookup(tt, torch.from_numpy(x), cfg_t, l)
        _, h_j, frac_j = jenc._cell_level_lookup(jt, jnp.asarray(x), cfg_j, l)
        np.testing.assert_array_equal(_np(h_t), np.asarray(h_j))
        np.testing.assert_array_equal(_np(frac_t), np.asarray(frac_j))
    np.testing.assert_allclose(
        _np(tenc.hash_encode(tt, torch.from_numpy(x), cfg_t)),
        np.asarray(jenc._hash_encode_cell_impl(jt, jnp.asarray(x), cfg_j)),
        rtol=1e-6, atol=1e-9)


def test_spatial_hash_int64_equals_uint32():
    c = np.random.default_rng(4).integers(0, 8192, (4096, 3)).astype(np.int32)
    for log2 in (8, 17, 20):
        np.testing.assert_array_equal(
            _np(tenc._spatial_hash(torch.from_numpy(c), log2)),
            np.asarray(jenc._spatial_hash(jnp.asarray(c), log2)))


def _points(n=300, seed=5):
    rng = np.random.default_rng(seed)
    xd = rng.uniform(-1.1, 1.1, (n, 6)).astype(np.float32)
    return xd


def test_ngp_forward_matches(scene):
    xd = _points()
    k = 1
    jp = jax.tree.map(lambda a: jnp.asarray(a[k]), scene.jvars["params"]["experts"])
    want = jax.jit(lambda p, ab, x: jngp.ngp_forward(p, scene.jcfg.expert, ab, x))(
        jp, jnp.asarray(scene.boxes[k]), jnp.asarray(xd))
    got = tngp.ngp_forward(scene.model.expert(k), scene.tcfg.expert,
                           scene.model.expert_aabbs[k], torch.from_numpy(xd))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("active_module", [None, 2])
def test_container_forward_matches(scene, active_module):
    xd = _points(seed=6)
    want = jax.jit(lambda v, x: jcont.container_forward(
        v, scene.jcfg, x, active_module=active_module))(
        jax.tree.map(jnp.asarray, scene.jvars), jnp.asarray(xd))
    got = tcont.container_forward(scene.model, torch.from_numpy(xd),
                                  active_module=active_module)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("active_module", [None, 1])
def test_container_density_matches(scene, active_module):
    xyz = _points(seed=15)[:, :3]
    want = jax.jit(lambda v, x: jcont.container_density(
        v, scene.jcfg, x, active_module=active_module))(
        jax.tree.map(jnp.asarray, scene.jvars), jnp.asarray(xyz))
    got = tcont.container_density(scene.model, torch.from_numpy(xyz),
                                  active_module=active_module)
    assert got.shape == (xyz.shape[0],)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert scene.tcfg.expert_density is tngp.ngp_density


def test_background_color_matches(scene):
    d = np.random.default_rng(7).normal(size=(128, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jcont.background_color(v, scene.jcfg, x))(
        jax.tree.map(jnp.asarray, scene.jvars), jnp.asarray(d))
    got = tcont.background_color(scene.model, torch.from_numpy(d))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cluster_2d,margin", [(True, 1.05), (False, 1.3),
                                               (True, 1.0)])
def test_routing_weights_match(cluster_2d, margin):
    rng = np.random.default_rng(8)
    cents = rng.uniform(-1, 1, (4, 3)).astype(np.float32)
    pts = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    want = jcont.routing_weights(jnp.asarray(cents), jnp.asarray(pts),
                                 cluster_2d, margin)
    got = tcont.routing_weights(torch.from_numpy(cents), torch.from_numpy(pts),
                                cluster_2d, margin)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_convert_keeps_layouts(scene):
    e0 = scene.model.expert(0)
    jp = scene.jvars["params"]["experts"]
    assert tuple(e0["sigma_trunk"][0]["w"].shape) == jp["sigma_trunk"][0]["w"].shape[1:]
    assert [tuple(t.shape) for t in e0["hash_table"]] == [
        t.shape[1:] for t in jp["hash_table"]]
    np.testing.assert_array_equal(_np(scene.model.experts["hash_table"][3]),
                                  jp["hash_table"][3])
    assert torch.all(scene.tocc["binaries"] == torch.from_numpy(
        np.array(scene.jocc["binaries"])))


def test_port_init_matches_jax_init_shapes_and_bias(scene):
    box = torch.from_numpy(scene.boxes)
    model = tcont.init_container(
        scene.tcfg, torch.zeros(4, 3), box, torch.from_numpy(scene.gaabb),
        generator=torch.Generator().manual_seed(0))
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            scene.jvars["params"])[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        want[name] = tuple(leaf.shape)
    assert got == want
    with torch.no_grad():
        assert torch.all(model.experts["sigma_head"]["b"] == -1.0)
        w = model.experts["sigma_trunk"][0]["w"]
        assert float(w.abs().max()) <= 1.0 / np.sqrt(w.shape[1])


# ------------------------------------------------ the training slice's parts


def _hash_grads(interpolation, cell_backward):
    """Table and x gradients of Σ(encode · cotangent) in both packages."""
    kw = dict(SMALL_HASH, interpolation=interpolation, cell_backward=cell_backward)
    cfg_j, cfg_t = JHashGridConfig(**kw), tenc.HashGridConfig(**kw)
    rng = np.random.default_rng(11)
    # features of size 0.02: the x gradient (features × resolution, summed
    # over levels) is then of order 1, and atol 1e-6 is a few of its ulps
    tables = [(0.02 * rng.normal(size=(cfg_j.level_rows(l),
                                       8 * cfg_j.features_per_level)))
              .astype(np.float32) for l in range(cfg_j.levels)]
    x = _hash_points(256, seed=12)
    x[:64] += np.float32(0.003)  # off the faces: the x gradient jumps there
    ct = rng.normal(size=(256, cfg_j.out_dim)).astype(np.float32)
    want = jax.jit(jax.grad(lambda t, p: jnp.sum(
        jenc.hash_encode(t, p, cfg_j) * ct), argnums=(0, 1)))(
        [jnp.asarray(t) for t in tables], jnp.asarray(x))
    tt = [torch.tensor(t, requires_grad=True) for t in tables]
    tx = torch.tensor(x, requires_grad=True)
    (tenc.hash_encode(tt, tx, cfg_t) * torch.from_numpy(ct)).sum().backward()
    return want, ([t.grad for t in tt], tx.grad)


@pytest.mark.parametrize("cell_backward", ["save_rows", "remat"])
@pytest.mark.parametrize("interpolation", ["Linear", "Smoothstep", "Nearest"])
def test_hash_encode_backward_matches_jax_grad(interpolation, cell_backward):
    (want_t, want_x), (got_t, got_x) = _hash_grads(interpolation, cell_backward)
    for l, (g, w) in enumerate(zip(got_t, want_t)):  # dense and hashed levels
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-6, rtol=1e-5,
                                   err_msg=f"level {l}")
    np.testing.assert_allclose(_np(got_x), np.asarray(want_x), atol=1e-6,
                               rtol=1e-4)
    if interpolation != "Nearest":
        assert float(got_x.abs().max()) > 0


@pytest.mark.parametrize("interpolation", ["Linear", "Smoothstep"])
def test_hash_encode_remat_equals_save_rows(interpolation):
    _, (save_t, save_x) = _hash_grads(interpolation, "save_rows")
    _, (remat_t, remat_x) = _hash_grads(interpolation, "remat")
    for a, b in zip(save_t, remat_t):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(_np(save_x), _np(remat_x), atol=1e-6, rtol=1e-4)


def test_hash_encode_skips_x_gradient_and_takes_rows_from_operand():
    cfg = tenc.HashGridConfig(**SMALL_HASH)
    tables = [torch.randn(cfg.level_rows(l), 8 * cfg.features_per_level,
                          generator=torch.Generator().manual_seed(l),
                          requires_grad=True) for l in range(cfg.levels)]
    x = torch.from_numpy(_hash_points(64))
    out = tenc._HashEncodeCellSaved.apply(x, cfg, *tables)
    out.sum().backward()
    assert all(t.grad.shape == t.shape for t in tables)
    # a table with more rows than the config's ladder: the cotangent follows
    # the operand (the public wrapper refuses it; the function does not)
    big = [torch.cat([t.detach(), torch.zeros(5, t.shape[1])]).requires_grad_(True)
           for t in tables]
    tenc._HashEncodeCellSaved.apply(x, cfg, *big).sum().backward()
    assert all(b.grad.shape == b.shape for b in big)
    with pytest.raises(ValueError, match="row"):
        tenc.hash_encode(big, x, cfg)
    with pytest.raises(ValueError, match="cell_backward"):
        tenc.hash_encode(tables, x, dataclasses.replace(cfg, cell_backward="x"))


def test_cell_lookup_bf16_decisions_exact_at_full_width():
    """Under bf16 the level's resolution is rounded first (4095 → 4096), as
    acn_tpu multiplies by ``jnp.asarray(res, bfloat16)``: cell and fraction
    are then the same bits. JAX op by op, no fusion."""
    kw = dict(levels=8, min_res=16, max_res=4096, log2_hashmap_size=12,
              features_per_level=2, layout="cell", dense_levels=True)
    cfg_j, cfg_t = JHashGridConfig(**kw), tenc.HashGridConfig(**kw)
    x = _hash_points(512, seed=13)
    xb_t = torch.from_numpy(x).to(torch.bfloat16)
    xb_j = jnp.asarray(x).astype(jnp.bfloat16)
    tables = [np.zeros((cfg_j.level_rows(l), 16), np.float32)
              for l in range(cfg_j.levels)]
    tt = [torch.from_numpy(t).to(torch.bfloat16) for t in tables]
    jt = [jnp.asarray(t).astype(jnp.bfloat16) for t in tables]
    np.testing.assert_array_equal(_np(xb_t.to(torch.float32)),
                                  np.asarray(xb_j.astype(jnp.float32)))
    for l in range(cfg_t.levels):
        _, h_t, frac_t = tenc._cell_level_lookup(tt, xb_t, cfg_t, l)
        _, h_j, frac_j = jenc._cell_level_lookup(jt, xb_j, cfg_j, l)
        np.testing.assert_array_equal(_np(h_t), np.asarray(h_j), err_msg=str(l))
        np.testing.assert_array_equal(_np(frac_t.to(torch.float32)),
                                      np.asarray(frac_j.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corner_weights_bit_equal(dtype):
    """The port takes the eight products as two broadcast products; they are
    acn_tpu's products in its order, so the bits are the same (JAX op by op)."""
    f = np.random.default_rng(14).random((257, 3)).astype(np.float32)
    ft = torch.from_numpy(f).to(getattr(torch, dtype))
    fj = jnp.asarray(f).astype(getattr(jnp, dtype))
    got = tenc._corner_weights(ft)
    want = jenc._corner_weights(fj)
    assert got.shape == (257, 8) and got.dtype == ft.dtype
    np.testing.assert_array_equal(_np(got.to(torch.float32)),
                                  np.asarray(want.astype(jnp.float32)))


def test_trunc_exp_bf16_forward_and_gradient():
    x = np.array([-200.0, -88.5, -3.0, 0.0, 2.5, 87.9, 88.0, 150.0], np.float32)
    g = np.linspace(-1, 1, x.size).astype(np.float32)
    jy, jvjp = jax.vjp(jtrunc_exp, jnp.asarray(x).astype(jnp.bfloat16))
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    ty = ttrunc_exp(xt)
    ty.backward(torch.tensor(g).to(torch.bfloat16))
    jg = jvjp(jnp.asarray(g).astype(jnp.bfloat16))[0]
    assert ty.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    # one bf16 ulp (2^-8): exp is rounded from different float32 results
    np.testing.assert_allclose(_np(ty.to(torch.float32)),
                               np.asarray(jy.astype(jnp.float32)), rtol=2**-7,
                               atol=1e-37)
    np.testing.assert_allclose(_np(xt.grad.to(torch.float32)),
                               np.asarray(jg.astype(jnp.float32)), rtol=2**-6,
                               atol=1e-37)
    assert np.isfinite(_np(xt.grad.to(torch.float32))).all()


def test_tree_cast_casts_floating_leaves_and_gradient_returns_in_f32():
    tree = {"a": [torch.ones(2, requires_grad=True)],
            "i": torch.arange(3), "b": {"w": torch.ones(2, 2)}}
    cast = tnn.tree_cast(tree, torch.bfloat16)
    assert cast["a"][0].dtype == cast["b"]["w"].dtype == torch.bfloat16
    assert cast["i"].dtype == torch.int64
    (cast["a"][0] * 3).sum().backward()
    assert tree["a"][0].grad.dtype == torch.float32
    jt = jnn.tree_cast({"a": jnp.ones(2), "i": jnp.arange(3)}, jnp.bfloat16)
    assert jt["a"].dtype == jnp.bfloat16 and jt["i"].dtype == jnp.int32


def test_param_group_labels_match(scene):
    want = jcont.param_group_labels(scene.jvars, scene.jcfg)
    got = tcont.param_group_labels(scene.model.params())
    assert jax.tree.leaves(got) == jax.tree.leaves(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert tngp.param_group_labels(scene.model.expert(0)) == got["experts"]


def test_expert_slice_and_params_are_views_of_the_module(scene):
    params = scene.model.params()
    assert set(params) == {"experts", "bg_mlp"}
    e1 = tcont.expert_slice(params["experts"], 1)
    jp = scene.jvars["params"]["experts"]
    np.testing.assert_array_equal(_np(e1["color_mlp"][0]["w"]),
                                  jp["color_mlp"][0]["w"][1])
    assert e1["hash_table"][2].data_ptr() == \
        scene.model.experts["hash_table"][2][1].data_ptr()
    back = convert.to_jax_variables(scene.model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(scene.jvars)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(back) == jax.tree.structure(scene.jvars)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, None), (None, 1.0)])
def test_clip_half_ties_has_jnp_clip_gradient(lo, hi):
    x = np.array([-1.0, 0.0, 0.25, 1.0, 2.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, lo, hi) * 3.0))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = tnn.clip_half_ties(xt, lo, hi)
    (y * 3.0).sum().backward()
    np.testing.assert_array_equal(_np(y), np.asarray(jnp.clip(jnp.asarray(x), lo, hi)))
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(want))
    assert 1.5 in _np(xt.grad)  # half at a tie, where torch.clamp passes all


def test_config_conversion_carries_cell_backward():
    jcfg = JContainerConfig(expert=JNGPConfig(hash=JHashGridConfig(
        **SMALL_HASH, cell_backward="remat")))
    assert convert.config_from_dict(
        dataclasses.asdict(jcfg)).expert.hash.cell_backward == "remat"
    assert tenc.HashGridConfig().cell_backward == JHashGridConfig().cell_backward
