"""The port's routed and single-expert serving, its coarse range pre-pass,
the ``random`` background and randomized rendering (acn_tpu_torch.occupancy.
grid, nerfs.render / render_occ, pipelines.renderer) against acn_tpu's.

* ``coarse_ray_range`` and ``march_rays_budget(s_coarse=…)``: JAX op by op
  (``jnp.linspace`` jitted as it always is: the port's ``unit_linspace``);
  near′/far′ and the march's integers exactly equal; a property test (the
  port's copy of ``tests/test_occupancy.py``'s) that no occupied fine bin
  falls outside the range.
* ``render_expert_occ`` / ``render_expert_occ_budget`` (midpoints and
  JAX's draws, with and without the range pre-pass): JAX op by op, f32
  atol 1e-5.
* ``_expert_rects`` / ``_feather_weights``: exactly equal, on a cropping
  camera, a camera inside a box and a box behind the camera.
* Frames (``render_image`` one expert at a time and
  ``render_image_routed``): JAX's jitted Renderer; u8 rgb within 1/255 (a
  value on a rounding edge), f16 depth/acc rtol 1e-3 (one f16 rounding).
  With identical experts the port's routed frame equals its dense one to
  that tolerance.

The ``random`` background and randomized rendering are held in
``test_torch_random_bg.py``, the scripts in ``test_torch_serving_runner.py``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.nerfs import render_occ as jrocc
from acn_tpu.occupancy import grid as jgrid
from acn_tpu.pipelines.renderer import Renderer as JRenderer
from acn_tpu_torch import toy
from acn_tpu_torch.nerfs import render_occ as trocc
from acn_tpu_torch.occupancy import grid as tgrid
from acn_tpu_torch.pipelines.renderer import Renderer as TRenderer
from test_torch_march_render import INT_KEYS, _rays
from test_torch_models import small_scene

H, W = 24, 32
U8 = 1.0 / 255 + 1e-6


@pytest.fixture(scope="module")
def scene():
    return small_scene(sigma_bias=2.0, alpha_thre=1e-2, budget=8, s_max=64, fill=0.3)


def _P(sc, **over):
    return types.SimpleNamespace(**{**vars(sc.P), "occ_s_kept": 16, "chunk_points": 4000,
                                    **over})


def _cmp_frames(got, want):
    assert got[0].shape == (H, W, 3) and np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=U8)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------- the coarse range


def _blob_state(cfg_j, rng, R=32):
    bins = np.zeros((1, R, R, R), bool)
    for _ in range(3):
        c = rng.integers(4, R - 4, 3)
        r = rng.integers(1, 4)
        bins[(0, *(slice(int(a - r), int(a + r)) for a in c))] = True
    st = jax.device_get(jgrid.init_occ_state(jnp.asarray(toy.SCENE_AABB), cfg_j))
    return {**st, "binaries": bins}


@pytest.mark.parametrize("s_coarse,pool_to,spread", [(32, 32, 3.0), (16, 8, 8.0),
                                                     (24, 12, 3.0)])
def test_coarse_ray_range_exact(s_coarse, pool_to, spread):
    """near′/far′ bit for bit, pooled (32 → 8) or kept at full resolution (12
    does not divide 32), with rays that start far outside the grid."""
    rng = np.random.default_rng(s_coarse)
    cfg = jgrid.OccConfig(resolution=32, levels=1, near_plane=0.0)
    st = _blob_state(cfg, rng)
    n = 96
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = rng.uniform(0.0, 0.5, n).astype(np.float32)
    far = (near + rng.uniform(2.0, 4.0 * spread, n)).astype(np.float32)
    far[::13] = near[::13]  # empty intervals
    want = jgrid.coarse_ray_range({k: jnp.asarray(v) for k, v in st.items()},
                                  *map(jnp.asarray, (o, d, near, far)), s_coarse, pool_to)
    got = tgrid.coarse_ray_range({k: torch.from_numpy(np.array(v)) for k, v in st.items()},
                                 *map(torch.from_numpy, (o, d, near, far)), s_coarse, pool_to)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy() > near).any() and (got[0].numpy() == far).any()


def test_coarse_ray_range_is_conservative():
    """No occupied fine bin of the untightened ray lies outside the
    tightened range: random blobs, rays from 3 and 8 units out."""
    rng = np.random.default_rng(7)
    cfg = jgrid.OccConfig(resolution=32, levels=1, near_plane=0.0)
    for trial in range(4):
        st = {k: torch.from_numpy(np.array(v)) for k, v in _blob_state(cfg, rng).items()}
        n = 64
        spread = 3.0 if trial % 2 == 0 else 8.0
        o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
        d = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32) - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        near = np.full((n,), 0.1, np.float32)
        far = np.full((n,), 8.0 if trial % 2 == 0 else 20.0, np.float32)
        near2, far2 = (t.numpy() for t in tgrid.coarse_ray_range(
            st, *map(torch.from_numpy, (o, d, near, far)), s_coarse=32))
        assert (near2 >= near - 1e-5).all() and (far2 <= far + 1e-5).all()
        t = near[:, None] + (far - near)[:, None] * ((np.arange(512) + 0.5) / 512)[None, :]
        x = torch.from_numpy((o[:, None] + d[:, None] * t[..., None]).astype(np.float32))
        occ = tgrid.occupancy_lookup(st, x).numpy()
        covered = (t >= near2[:, None] - 1e-5) & (t <= far2[:, None] + 1e-5)
        assert occ.any() and not (occ & ~covered).any(), trial


@pytest.mark.parametrize("budget,jitter", [(64, False), (4, False), (8, True)])
def test_march_rays_budget_with_coarse_range_exact(scene, budget, jitter):
    """The packed march of expert 1's grid behind a 16-bin pre-pass: the
    integers exactly, the geometry rtol 1e-6 (JAX op by op)."""
    rays = _rays(seed=4)
    key = jax.random.PRNGKey(9) if jitter else None
    jstate = {k: v[1] for k, v in scene.jocc.items()}
    want = jax.device_get(jgrid.march_rays_budget(
        jstate, jnp.asarray(rays), scene.jocc_cfg, 64, budget, key=key, s_coarse=16))
    salt = (int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max)) if jitter
            else None)
    got = tgrid.march_rays_budget({k: v[1] for k, v in scene.tocc.items()},
                                  torch.from_numpy(rays), scene.tocc_cfg, 64, budget,
                                  salt=salt, s_coarse=16)
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("t0_b", "t1_b", "xd", "t_starts", "t_ends"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    plain = tgrid.march_rays_budget({k: v[1] for k, v in scene.tocc.items()},
                                    torch.from_numpy(rays), scene.tocc_cfg, 64, budget,
                                    salt=salt)
    # the pre-pass tightens the bins of rays through the box
    assert (got["t_ends"] - got["t_starts"]).sum() < (plain["t_ends"] - plain["t_starts"]).sum()


# ------------------------------------------------------ single-expert renders


@pytest.mark.parametrize("jitter", [False, True])
def test_render_expert_occ_matches_jax(scene, jitter):
    rays = _rays(seed=5)
    key = jax.random.PRNGKey(3) if jitter else None
    bg = np.random.default_rng(6).random((rays.shape[0], 3)).astype(np.float32)
    jv = jax.tree.map(jnp.asarray, scene.jvars)
    k = 2
    with jax.disable_jit():
        want = jax.device_get(jrocc.render_expert_occ(
            jv, {n: v[k] for n, v in scene.jocc.items()}, scene.jcfg, scene.jocc_cfg,
            jnp.asarray(rays), active_module=k, s_max=64, s_kept=12, alpha_thre=1e-2,
            key=key, bg_rgb=jnp.asarray(bg)))
    u = bits = None
    if jitter:
        k_jit, k_phase = jax.random.split(key)
        u = torch.from_numpy(np.array(jax.random.uniform(k_jit, (rays.shape[0], 64))))
        bits = torch.from_numpy(np.array(jax.random.randint(
            k_phase, (rays.shape[0],), 0, 1 << 30)).astype(np.int64))
    with torch.no_grad():
        got = trocc.render_expert_occ(
            scene.model, {n: v[k] for n, v in scene.tocc.items()}, scene.tocc_cfg,
            torch.from_numpy(rays), active_module=k, s_max=64, s_kept=12, alpha_thre=1e-2,
            u=u, phase_bits=bits, bg_rgb=torch.from_numpy(bg))
    assert float(want[3].max()) > 0.5
    for g, w, name in zip(got, want, ("rgb", "depth", "weights", "acc")):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("s_coarse,jitter", [(0, False), (16, False), (16, True)])
def test_render_expert_occ_budget_matches_jax(scene, s_coarse, jitter):
    rays = _rays(seed=7)
    key = jax.random.PRNGKey(4) if jitter else None
    jv = jax.tree.map(jnp.asarray, scene.jvars)
    k = 0
    want = jax.device_get(jrocc.render_expert_occ_budget(
        jv, {n: v[k] for n, v in scene.jocc.items()}, scene.jcfg, scene.jocc_cfg,
        jnp.asarray(rays), active_module=k, s_max=64, budget_per_ray=8, alpha_thre=1e-2,
        key=key, bg_rgb=jnp.ones((rays.shape[0], 3)), s_coarse=s_coarse))
    salt = (int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max)) if jitter
            else None)
    with torch.no_grad():
        got = trocc.render_expert_occ_budget(
            scene.model, {n: v[k] for n, v in scene.tocc.items()}, scene.tocc_cfg,
            torch.from_numpy(rays), active_module=k, s_max=64, budget_per_ray=8,
            alpha_thre=1e-2, salt=salt, bg_rgb=torch.ones(rays.shape[0], 3),
            s_coarse=s_coarse)
    assert float(want[3].max()) > 0.5
    for g, w, name in ((got[0], want[0], "rgb"), (got[1], want[1], "depth"),
                       (got[3], want[3], "acc")):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("wmax", "went"):
        np.testing.assert_allclose(got[2][name].numpy(), want[2][name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("budget,ray_samples", [(8, None), (0, 12)])
def test_single_expert_frames_match_jax(scene, budget, ray_samples):
    """``render_image(active_module=k)``, for the first and the last
    expert: the budget path (``occ_render_s_coarse`` 16), and the strided
    one at a preview's samples (``ray_samples`` 12: the march keeps 12
    samples, not the config's 16)."""
    P = _P(scene, occ_budget_per_ray=budget, occ_render_s_coarse=16 if budget else 0)
    jr = JRenderer(scene.jcfg, P, scene.jocc_cfg)
    tr = TRenderer(scene.tcfg, P, scene.tocc_cfg, device="cpu")
    cam = toy.overhead_camera(H, W)
    for k in (0, scene.tcfg.num_submodules - 1):
        want = jr.render_image(scene.jvars, scene.jocc, H=H, W=W, active_module=k,
                               ray_samples=ray_samples, **cam)
        got = tr.render_image(scene.model, scene.tocc, H=H, W=W, active_module=k,
                              ray_samples=ray_samples, **cam)
        _cmp_frames(got, want)


def test_preview_samples_scale_the_kept_samples(scene):
    tr = TRenderer(scene.tcfg, _P(scene, occ_budget_per_ray=0), scene.tocc_cfg, device="cpu")
    assert [tr._s_kept(s) for s in (96, 12, 4)] == [16, 12, 8]


# ------------------------------------------------------------ routed frames


def _quad_rects_jax_vs_port(aabbs, c2w, intr, h, w, pad):
    want = JRenderer._expert_rects(aabbs, c2w, intr, h, w, pad_px=pad)
    got = TRenderer._expert_rects(aabbs, c2w, intr, h, w, pad_px=pad)
    np.testing.assert_array_equal(got, want)
    for rect in got:
        for blend in (pad, 8):
            np.testing.assert_array_equal(TRenderer._feather_weights(rect, h, w, blend),
                                          JRenderer._feather_weights(rect, h, w, blend))
    return got


def test_expert_rects_and_feathers_exact():
    boxes, _ = toy.quadrant_layout(4)
    h = w = 64
    intr = np.array([0.7 * h, 0.7 * h, w / 2, h / 2], np.float32)
    cam = np.array([[0.0, 0.0, -1.0, -2.0], [0.0, 1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]],
                   np.float32)  # overhead at x = −2, looking down
    rects = _quad_rects_jax_vs_port(boxes, cam, intr, h, w, 2)
    areas = (rects[:, 1] - rects[:, 0]) * (rects[:, 3] - rects[:, 2])
    assert (areas < h * w).all()  # every quadrant crops
    inside = cam.copy()
    inside[:, 3] = (0.0, 0.5, 0.5)  # inside box 3
    rects = _quad_rects_jax_vs_port(boxes, inside, intr, h, w, 0)
    assert tuple(rects[3]) == (0, h, 0, w)
    behind = cam.copy()
    behind[:, 3] = (-2.0, 0.0, 0.7)  # the far z quadrants' corners behind the plane
    behind[:, :3] = np.array([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]],
                             np.float32) @ np.array(
        [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]], np.float32)
    rects = _quad_rects_jax_vs_port(boxes, behind, intr, h, w, 2)
    full = [tuple(r) == (0, h, 0, w) for r in rects]
    assert any(full) and not all(full)


@pytest.mark.parametrize("case", ["crop", "sky", "coarse"])
def test_render_image_routed_matches_jax(scene, case):
    """Quadrant rects that crop (blend 2 px), a far camera whose frame is
    mostly sky (the uncovered-pixel fallback), and the budget path with a
    16-bin pre-pass (the strided single-expert chunks are held by
    ``test_single_expert_frames_match_jax``)."""
    P = _P(scene, occ_budget_per_ray=8,
           occ_render_s_coarse=16 if case == "coarse" else 0)
    jr = JRenderer(scene.jcfg, P, scene.jocc_cfg)
    tr = TRenderer(scene.tcfg, P, scene.tocc_cfg, device="cpu")
    cam = toy.overhead_camera(H, W, lift=3.0 if case == "sky" else 1.0)
    rects = tr.routed_rects(scene.boxes, cam["c2w"], cam["intrinsics"], H, W, 2)
    if case == "crop":
        assert ((rects[:, 1] - rects[:, 0]) * (rects[:, 3] - rects[:, 2]) < H * W).all()
    if case == "sky":
        assert any(tuple(r) == (0, H, 0, W) for r in rects)  # the fallback
    want = jr.render_image_routed(scene.jvars, scene.jocc, H=H, W=W, blend_px=2, **cam)
    got = tr.render_image_routed(scene.model, scene.tocc, H=H, W=W, blend_px=2, **cam)
    _cmp_frames(got, want)
    if case == "sky":
        assert float(np.asarray(want[2]).min()) < 0.05 < float(np.asarray(want[2]).max())


def test_routed_dispatch_quantizes_crops_and_rows():
    """A crop is a multiple of 128 px re-anchored inside the frame, a chunk's
    rows the rect's height rounded up to 64 at most, and chunks carry K×
    the dense chunk's rays."""
    cfg, P, occ_cfg = toy.train_occ_config()
    r = TRenderer(cfg, P, occ_cfg, device="cpu")
    rects = np.array([[0, 649, 0, 1069], [500, 530, 1800, 1920], [0, 1080, 0, 1920]])
    plan = r.routed_dispatch(rects, 1920, True)
    by_k = {k: [p for p in plan if p[0] == k] for k in range(3)}
    assert {p[4] for p in by_k[0]} == {1152} and by_k[0][0][5] == 125_000 // 1152
    assert sum(p[2] for p in by_k[0]) == 649
    (k, r0, rows_this, c0, w_crop, rows), = by_k[1]
    assert (r0, rows_this, c0, w_crop, rows) == (500, 30, 1792, 128, 64)
    assert {p[4] for p in by_k[2]} == {1920} and by_k[2][0][5] == 125_000 // 1920


@pytest.mark.parametrize("budget", [64, 0])
def test_routed_equals_dense_with_identical_experts(scene, budget):
    """Every expert expert 0's weights, box and grid; the rects from the
    true quadrant boxes: the routed frame is the dense one (at a budget of
    every bin, so that no chunk overflows: a dense and a routed chunk hold
    other rays and would drop other samples)."""
    P = _P(scene, occ_budget_per_ray=budget)
    tr = TRenderer(scene.tcfg, P, scene.tocc_cfg, device="cpu")
    model, occ = toy.identical_experts(scene.model), toy.identical_occ(scene.tocc)
    cam = toy.overhead_camera(H, W, lift=1.0)
    dense = tr.render_image(model, occ, H=H, W=W, **cam)
    routed = tr.render_image_routed(model, occ, H=H, W=W, blend_px=2,
                                    expert_aabbs=scene.boxes, **cam)
    assert float(dense[2].max()) > 0.5
    np.testing.assert_allclose(routed[0], dense[0], atol=U8)
    for g, w in zip(routed[1:], dense[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)


def test_mesh_is_refused(scene):
    tr = TRenderer(scene.tcfg, _P(scene), scene.tocc_cfg, device="cpu")
    for fn in (tr.render_image, tr.render_image_routed):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            fn(scene.model, scene.tocc, H=H, W=W, mesh=object(), **toy.overhead_camera(H, W))
