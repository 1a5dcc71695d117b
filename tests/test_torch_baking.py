"""The port's baked serving path (acn_tpu_torch.pipelines.baking) and the
runner's ``--op bake`` and ``--op eval --baked_asset`` against acn_tpu's.

* ``bake_field`` through ``bake_container`` on the small soft-MoE scene, at
  10³ and 12³ in chunks that do not divide the lattice (the last padded),
  SH 0, SH 1 and supersample 2: the table f32 atol 1e-5 (the MLPs and the
  SH projection sum in another order), the occupancy exactly.
* ``pack_baked`` on a random table, pooled and at the bake's resolution:
  the grid and the table exactly.
* ``trilinear_lookup`` and the z-pair lookup: f32 atol 1e-6 (the same
  products in the same corner order; XLA may fuse a multiply-add).
* ``render_baked_rays``, both branches and SH 1, JAX op by op (the marches'
  decisions must see the same points): f32 atol 1e-5; ``BakedRenderer``
  frames (JAX jitted): u8 within 1/255, f16 rtol 1e-3.
* Assets read across: an asset ``acn_tpu`` wrote renders in the port as
  in JAX, and the reverse; both write the same keys and dtypes.

The runner's ``--op bake`` and ``--op eval --baked_asset`` are held in
``test_torch_serving_runner.py``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.pipelines import baking as jbake
from acn_tpu_torch import toy
from acn_tpu_torch.pipelines import baking as tbake
from test_torch_march_render import _rays
from test_torch_models import small_scene

U8 = 1.0 / 255 + 1e-6


@pytest.fixture(scope="module")
def scene():
    return small_scene(sigma_bias=2.0, fill=0.3)


def _np(t):
    return t.detach().cpu().numpy()


def _same_asset(got, want, atol):
    np.testing.assert_allclose(_np(got["table"]), np.asarray(want["table"]), atol=atol)
    np.testing.assert_array_equal(_np(got["occ_state"]["binaries"]),
                                  np.asarray(want["occ_state"]["binaries"]))
    np.testing.assert_array_equal(_np(got["occ_state"]["aabbs"]),
                                  np.asarray(want["occ_state"]["aabbs"]))
    assert got["occ_cfg"].resolution == want["occ_cfg"].resolution
    assert (got["resolution"], got["sh_degree"]) == (want["resolution"], want["sh_degree"])


@pytest.mark.parametrize("R,occ_res,sh,ss", [(10, 5, 0, 1), (12, 5, 1, 1), (10, 5, 0, 2)])
def test_bake_container_matches_jax(scene, R, occ_res, sh, ss):
    kw = dict(resolution=R, bake_dirs=4, chunk=384, occ_resolution=occ_res, occ_thre=5e-3,
              sh_degree=sh, supersample=ss)
    want = jbake.bake_container(jax.tree.map(jnp.asarray, scene.jvars), scene.jcfg, **kw)
    got = tbake.bake_container(scene.model, **kw)
    _same_asset(got, want, 1e-5)
    assert _np(got["occ_state"]["binaries"]).any()
    assert got["table"].shape == (R ** 3, 13 if sh else 4)


@pytest.mark.parametrize("R,occ_res", [(16, 8), (12, 5)])
def test_pack_baked_exact(R, occ_res):
    rng = np.random.default_rng(R)
    table = rng.uniform(-0.3, 1.3, (R ** 3, 4)).astype(np.float32)
    table[:, 3] = np.where(rng.random(R ** 3) < 0.05, rng.exponential(1.0, R ** 3), 0.0)
    want = jbake.pack_baked(table, toy.SCENE_AABB, R, occ_resolution=occ_res)
    got = tbake.pack_baked(table, toy.SCENE_AABB, R, occ_resolution=occ_res, device="cpu")
    _same_asset(got, want, 0.0)
    assert got["occ_cfg"].resolution == (occ_res if R % occ_res == 0 else R)


def _random_asset(R=9, F=4, seed=0, occ_resolution=9):
    rng = np.random.default_rng(seed)
    table = rng.random((R ** 3, F)).astype(np.float32)
    table[:, -1] = np.where(rng.random(R ** 3) < 0.4, 4.0 * rng.random(R ** 3), 0.0)
    sh = 1 if F == 13 else 0
    if sh:
        table[:, :12] = rng.normal(0.0, 0.4, (R ** 3, 12))
    return (jbake.pack_baked(table, toy.SCENE_AABB, R, occ_resolution=occ_resolution,
                             sh_degree=sh),
            tbake.pack_baked(table, toy.SCENE_AABB, R, occ_resolution=occ_resolution,
                             sh_degree=sh, device="cpu"))


def test_trilinear_lookups_match_jax():
    jb, tb = _random_asset(F=13)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.2, 1.2, (500, 3)).astype(np.float32)  # some outside: clamped
    R = jb["resolution"]
    want = jbake.trilinear_lookup(jb["table"], jb["aabb"], R, jnp.asarray(x))
    got = tbake.trilinear_lookup(tb["table"], tb["aabb"], R, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
    jz = jbake.pack_zpairs(jb["table"], R)
    tz = tbake.pack_zpairs(tb["table"], R)
    np.testing.assert_array_equal(_np(tz), np.asarray(jz))
    want_z = jbake.trilinear_lookup_zpair(jz, jb["aabb"], R, jnp.asarray(x))
    got_z = tbake.trilinear_lookup_zpair(tz, tb["aabb"], R, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got_z), np.asarray(want_z), atol=1e-6)
    np.testing.assert_allclose(_np(got_z), _np(got), atol=1e-5)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_allclose(
        _np(tbake.decode_sh1(got[:, :12], torch.from_numpy(d))),
        np.asarray(jbake.decode_sh1(want[:, :12], jnp.asarray(d))), atol=1e-6)


@pytest.mark.parametrize("budget,s_coarse,sh", [(8, 0, 0), (8, 16, 1), (0, 0, 0),
                                                (0, 0, 1)])
def test_render_baked_rays_matches_jax(budget, s_coarse, sh):
    jb, tb = _random_asset(F=13 if sh else 4, seed=2)
    rays = _rays(seed=3)
    bg = np.random.default_rng(4).random((rays.shape[0], 3)).astype(np.float32)
    kw = dict(s_max=32, budget_per_ray=budget, alpha_thre=1e-2, s_coarse=s_coarse)
    want = jax.device_get(jbake.render_baked_rays(jb, jnp.asarray(rays),
                                                  bg_rgb=jnp.asarray(bg), **kw))
    got = tbake.render_baked_rays(tb, torch.from_numpy(rays), bg_rgb=torch.from_numpy(bg),
                                  **kw)
    assert float(want[3].max()) > 0.5
    for i, name in ((0, "rgb"), (1, "depth"), (3, "acc")):
        np.testing.assert_allclose(_np(got[i]), want[i], rtol=1e-5, atol=1e-5, err_msg=name)
    if budget:
        for name in ("wmax", "went"):
            np.testing.assert_allclose(_np(got[2][name]), want[2][name], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    else:
        np.testing.assert_allclose(_np(got[2]), want[2], rtol=1e-5, atol=1e-5)


def _frames_both(jb, tb, **kw):
    H, W = 24, 32
    cam = toy.overhead_camera(H, W, lift=1.5)
    view = dict(H=H, W=W, intrinsics=cam["intrinsics"], c2w=cam["c2w"],
                near_far_override=(0.2, None))
    want = jbake.BakedRenderer(jb, chunk_points=6000, **kw).render_image(**view)
    got = tbake.BakedRenderer(tb, chunk_points=6000, **kw).render_image(**view)
    assert float(np.asarray(want[2]).max()) > 0.5
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=U8)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3, atol=1e-3)
    return got


@pytest.mark.parametrize("budget,s_coarse,zpair", [(8, 0, True), (8, 16, False),
                                                   (0, 0, True)])
def test_baked_renderer_frames_match_jax(budget, s_coarse, zpair):
    jb, tb = _random_asset(seed=5)
    _frames_both(jb, tb, s_max=32, budget_per_ray=budget, s_coarse=s_coarse, zpair=zpair,
                 bg_color="black")


def test_baked_renderer_serves_random_backgrounds_white():
    _, tb = _random_asset()
    assert tbake.BakedRenderer(tb, bg_color="random").bg_color == "white"
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        tbake.BakedRenderer(tb).render_image(H=4, W=4, intrinsics=np.ones(4),
                                             c2w=np.eye(4)[:3], mesh=object())


def test_assets_read_across_both_ways(tmp_path):
    jb, tb = _random_asset(F=13, seed=6, occ_resolution=3)
    jbake.save_baked(tmp_path / "jax.npz", jb)
    tbake.save_baked(tmp_path / "port.npz", tb)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    from_jax = tbake.load_baked(tmp_path / "jax.npz", device="cpu")
    from_port = jbake.load_baked(tmp_path / "port.npz")
    _same_asset(from_jax, jb, 0.0)
    # an asset of acn_tpu renders in the port as in JAX, and the reverse
    _frames_both(jb, from_jax, s_max=32, budget_per_ray=8)
    _frames_both(from_port, tb, s_max=32, budget_per_ray=0)


def test_load_baked_puts_the_asset_on_the_card_by_default(tmp_path, monkeypatch):
    _, tb = _random_asset()
    tbake.save_baked(tmp_path / "a.npz", tb)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbake.load_baked(tmp_path / "a.npz")
