"""The port's episodic sampling (acn_tpu_torch.data.tasks, data.ram_rays,
train_step.make_device_batch_fn) and its camera prune
(occupancy.grid.mark_invisible_cells, runner.premark_occ_states) against
acn_tpu's.

Exact throughout. The numpy copies (routing, the host samplers, the device
pools) give the same arrays as acn_tpu's from the same seeds. The sampler on
the card gives the same ray ids as acn_tpu's ``make_device_batch_fn`` when
it is handed JAX's own draws (the cell JAX's ``categorical`` picks, the
uniforms that order the images, the two offsets per image), read here from
pools whose rays carry their own row number. With draws from a torch
generator it is held to the episode constraints of
``tests/test_device_sampling.py``. The prune's masks equal JAX's run op by
op, cameras whose image border passes through cell centers among them.
"""

import dataclasses
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.data import tasks as jtasks
from acn_tpu.data.ram_rays import RamRaysDataset as JRamRays
from acn_tpu.occupancy import grid as jgrid
from acn_tpu.pipelines.offline_stage.train_step import make_device_batch_fn as jbatch_fn
from acn_tpu_torch import convert
from acn_tpu_torch.data import tasks as ttasks
from acn_tpu_torch.data.ram_rays import RamRaysDataset
from acn_tpu_torch.occupancy import grid as tgrid
from acn_tpu_torch.pipelines.offline_stage import train_step as tts

REGION = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)


def ray_store(seed, n=3000, n_images=12, y_range=(-1.0, 1.0)):
    """(rays, rgbs, image ids): rays from x = −2 along +x through the box,
    origins uniform over (y, z), each ray's color its own row number (so a
    sampled ray names its row)."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([np.full((n, 1), -2.0), rng.uniform(*y_range, (n, 1)),
                        rng.uniform(-1, 1, (n, 1))], 1)
    d = np.tile([1.0, 0.0, 0.0], (n, 1))
    nf = np.tile([0.0, 10.0], (n, 1))
    rays = np.concatenate([o, d, nf], 1).astype(np.float32)
    rgbs = np.repeat(np.arange(n, dtype=np.float32)[:, None], 3, 1)
    return rays, rgbs, rng.integers(0, n_images, n).astype(np.int32)


def samplers(K=2, S=32, Q=16, cell_dim=3, n_images=(12, 3), seed=0, route_cache=None):
    """The same K per-expert samplers in both packages; expert 1 has few
    images per cell, so that its query borrows the support's."""
    jout, tout = [], []
    for k in range(K):
        rays, rgbs, img = ray_store(seed + k, n_images=n_images[k % len(n_images)])
        jds = JRamRays.__new__(JRamRays)
        jds.rays, jds.rgbs, jds.img_indices = rays, rgbs, img
        jds.num_images = len(np.unique(img))
        jout.append(jtasks.TaskSampler(jds, REGION, cell_dim, S, Q, seed=seed + k))
        tout.append(ttasks.TaskSampler(RamRaysDataset.from_arrays(rays, rgbs, img),
                                       REGION, cell_dim, S, Q, seed=seed + k,
                                       route_cache=route_cache))
    return jout, tout


# ------------------------------------------------------------ host side


def test_ray_store_from_arrays_and_its_refusal():
    rays, rgbs, img = ray_store(0)
    ds = RamRaysDataset.from_arrays(rays, rgbs, img)
    assert len(ds) == 3000 and ds.num_images == 12
    jds = JRamRays.__new__(JRamRays)
    jds.rays, jds.rgbs, jds.img_indices = rays, rgbs, img
    for a, b in zip(ds.sample(np.random.default_rng(3), 50),
                    jds.sample(np.random.default_rng(3), 50)):
        np.testing.assert_array_equal(a, b)
    empty = RamRaysDataset([])  # from no images: an empty store, as acn_tpu's
    assert len(empty) == 0 and empty.num_images == 0 and empty.rays.shape == (0, 8)
    with pytest.raises(ValueError, match="differ in length"):
        RamRaysDataset.from_arrays(rays, rgbs[:10], img)


def test_micro_cells_and_routing_match(tmp_path):
    rays, _, _ = ray_store(1, n=5000)
    rays[::7, 3:6] = np.float32([0.3, 0.8, -0.52]) / np.linalg.norm([0.3, 0.8, -0.52])
    for dim in (1, 3, 5):
        cells = ttasks.make_micro_cells(REGION, dim)
        np.testing.assert_array_equal(cells, jtasks.make_micro_cells(REGION, dim))
        want = jtasks.route_rays_to_cells(rays, cells, chunk=1000)
        got = ttasks.route_rays_to_cells(rays, cells, chunk=1000, cache_dir=tmp_path)
        np.testing.assert_array_equal(got, want)
        # the second call reads the cache, keyed by the rays and the cells
        assert len(list(tmp_path.glob("*.npz"))) == [1, 3, 5].index(dim) + 1
        np.testing.assert_array_equal(
            ttasks.route_rays_to_cells(rays, cells, cache_dir=tmp_path), want)
    assert (want >= 0).any() and len(np.unique(want)) > 10


def test_host_samplers_match():
    js, ts = samplers()
    for j, t in zip(js, ts):
        assert j.eligible == t.eligible
        for a, b in zip(j.pools, t.pools):
            np.testing.assert_array_equal(a, b)
    jm, tm = jtasks.MultiTaskSampler(js), ttasks.MultiTaskSampler(ts)
    assert tm.num_experts == 2
    for _ in range(4):
        want, got = jm.sample_batch(3), tm.sample_batch(3)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_device_pools_match():
    js, ts = samplers()
    for max_pool, max_images in ((512, 32), (100, 4)):
        want = jtasks.build_device_pools(js, max_pool=max_pool, max_images=max_images, seed=5)
        got = ttasks.build_device_pools(ts, max_pool=max_pool, max_images=max_images, seed=5)
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------ the card's sampler


def jax_episode_draws(key, pools, K, T):
    """The draws of acn_tpu's ``make_device_batch_fn`` from ``key``, in the
    port's form: per task ``ks = split(key_kt, 6)``; the cell from
    ``categorical(ks[0])`` over the eligible cells, ``u`` from ``ks[1]``,
    the support and fresh query offsets from ``ks[3]`` and ``ks[5]``."""
    I = pools["img_start"].shape[2]
    keys = jax.random.split(key, K * T).reshape(K, T, -1)
    out = {"cell": np.zeros((K, T), np.int64), "u": np.zeros((K, T, I), np.float32),
           "offs_s": np.zeros((K, T, I), np.int64), "offs_q": np.zeros((K, T, I), np.int64)}
    for k in range(K):
        logits = jnp.where(jnp.asarray(pools["eligible"][k]), 0.0, -jnp.inf)
        for t in range(T):
            ks = jax.random.split(keys[k, t], 6)
            out["cell"][k, t] = int(jax.random.categorical(ks[0], logits))
            out["u"][k, t] = np.asarray(jax.random.uniform(ks[1], (I,)))
            out["offs_s"][k, t] = np.asarray(jax.random.randint(ks[3], (I,), 0, 1 << 30))
            out["offs_q"][k, t] = np.asarray(jax.random.randint(ks[5], (I,), 0, 1 << 30))
    return {k: torch.from_numpy(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def pools():
    """Device pools of two experts (12 and 3 images), their rays' x origin
    replaced by the row number, in both packages' forms."""
    _, ts = samplers()
    p = ttasks.build_device_pools(ts, max_pool=512, seed=3)
    p["rays"][..., 0] = np.arange(p["rays"].shape[1], dtype=np.float32)[None]
    return p


@pytest.mark.parametrize("seed", range(6))
def test_device_sampler_ids_equal_jax_with_its_draws(pools, seed):
    T, S, Q = 3, 32, 16
    key = jax.random.PRNGKey(seed)
    want = jax.jit(jbatch_fn(T, S, Q))({k: jnp.asarray(v) for k, v in pools.items()}, key)
    tp = tts.pools_to_device(pools, "cpu")
    draws = jax_episode_draws(key, pools, 2, T)
    s_ids, q_ids = tts.episode_ray_ids(tp, draws, S, Q)
    np.testing.assert_array_equal(s_ids.numpy(), np.asarray(want["support_rays"])[..., 0])
    np.testing.assert_array_equal(q_ids.numpy(), np.asarray(want["query_rays"])[..., 0])
    got = tts.make_device_batch_fn(T, S, Q)(tp, draws)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


def test_device_sampler_borrows_when_a_cell_has_few_images(pools):
    """Expert 1's cells hold 3 images: support takes all of them, so the
    query borrows support's images, in the window after support's rays."""
    tp = tts.pools_to_device(pools, "cpu")
    draws = tts.draw_episodes(tp, 4, torch.Generator().manual_seed(0))
    s_ids, q_ids = tts.episode_ray_ids(tp, draws, 32, 16)
    img = ray_store(1, n_images=3)[2]
    for t in range(4):
        s, q = s_ids[1, t].numpy(), q_ids[1, t].numpy()
        assert not np.intersect1d(s, q).size
        assert np.intersect1d(img[s], img[q]).size  # borrowed images


@pytest.mark.parametrize("seed", range(4))
def test_device_sampler_from_a_generator_keeps_the_constraints(pools, seed):
    """As tests/test_device_sampling.py holds acn_tpu's: every ray real,
    support and query disjoint, one cell per task, image counts within their
    bounds, no image over ⌈cap·split⌉ distinct rays; where the cell has images
    enough, every ray unique within its split and the splits
    image-disjoint."""
    T, S, Q = 3, 32, 16
    cst = ttasks.EpisodeConstraints()
    tp = tts.pools_to_device(pools, "cpu")
    gen = torch.Generator().manual_seed(seed)
    draws = tts.draw_episodes(tp, T, gen)
    assert draws["cell"].shape == (2, T) and bool(
        tp["eligible"][torch.arange(2)[:, None], draws["cell"]].all())
    assert 0 <= int(draws["offs_s"].min()) and int(draws["offs_q"].max()) < 1 << 30
    batch = tts.make_device_batch_fn(T, S, Q, cst)(tp, draws)
    cells = ttasks.make_micro_cells(REGION, 3)
    for k, n_images in ((0, 12), (1, 3)):
        img = ray_store(k, n_images=n_images)[2]
        raw = ray_store(k, n_images=n_images)[0]
        for t in range(T):
            s = batch["support_rays"][k, t].numpy()
            q = batch["query_rays"][k, t].numpy()
            assert (s[:, 7] > 0).all() and (q[:, 7] > 0).all()  # never padding
            s_ids, q_ids = s[:, 0].astype(int), q[:, 0].astype(int)
            assert not np.intersect1d(s_ids, q_ids).size
            yz = raw[np.concatenate([s_ids, q_ids]), 1:3]
            c = cells[int(draws["cell"][k, t])]
            assert ((yz >= c[0, 1:] - 1e-6) & (yz <= c[1, 1:] + 1e-6)).all()
            s_img, q_img = np.unique(img[s_ids]), np.unique(img[q_ids])
            assert 1 <= len(s_img) <= cst.max_images_support
            assert 1 <= len(q_img) <= cst.max_images_query
            for ids, n in ((s_ids, S), (q_ids, Q)):  # distinct rays per image
                per_image = np.unique(img[np.unique(ids)], return_counts=True)[1]
                assert per_image.max() <= np.ceil(cst.image_cap * n)
            if n_images == 12:  # a borrowing query takes one image, and repeats
                assert len(np.unique(s_ids)) == S and len(np.unique(q_ids)) == Q
                assert not np.intersect1d(s_img, q_img).size


@pytest.mark.requires_cuda
def test_device_sampler_on_the_card_equals_the_cpu(pools):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    draws = tts.draw_episodes(tts.pools_to_device(pools, "cpu"), 3,
                              torch.Generator().manual_seed(1))
    want = tts.episode_ray_ids(tts.pools_to_device(pools, "cpu"), draws, 32, 16)
    got = tts.episode_ray_ids(tts.pools_to_device(pools, "cuda"),
                              {k: v.cuda() for k, v in draws.items()}, 32, 16)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_pools_to_device_refuses_a_missing_card(pools):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA|none is available"):
        tts.pools_to_device(pools)


# ------------------------------------------------------------ the prune


def _cameras(seed, C=6):
    rng = np.random.default_rng(seed)
    K, c2w = [], []
    for _ in range(C):
        f = rng.uniform(20, 60)
        K.append([[f, 0, 16], [0, f, 12], [0, 0, 1]])
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        c2w.append(np.concatenate([q, rng.uniform(-3, 3, (3, 1))], 1))
    return np.asarray(K, np.float32), np.asarray(c2w, np.float32)


def _border_camera():
    """An axis-aligned camera at z = −4 looking along +z, focal length 20 and
    principal point 0 on a 4 × 4 image: the 4³ grid's centers at x (or y) =
    0.75 and depth 3.75 project exactly onto u = 4 (v = 4), the border."""
    K = np.array([[[20.0, 0, 0], [0, 20.0, 0], [0, 0, 1]]], np.float32)
    c2w = np.array([[[1, 0, 0, 0.0], [0, 1, 0, 0.0], [0, 0, 1, -4.0]]], np.float32)
    return K, c2w


def _mark_both(K, c2w, W, H, near, levels=2, R=16):
    jcfg = jgrid.OccConfig(resolution=R, levels=levels)
    tcfg = convert.occ_config_from_dict(dataclasses.asdict(jcfg))
    jst = {k: jnp.asarray(v) for k, v in jgrid.init_occ_state(jnp.asarray(REGION), jcfg).items()}
    jst["binaries"] = jnp.ones_like(jst["binaries"])
    with jax.disable_jit():  # op by op
        want = jgrid.mark_invisible_cells(jst, jnp.asarray(K), jnp.asarray(c2w), W, H,
                                          near, jcfg)
    tst = tgrid.init_occ_state(torch.from_numpy(REGION), tcfg)
    tst["binaries"] = torch.ones_like(tst["binaries"])
    with mock.patch.object(tgrid, "INVISIBLE_BLOCK", 1000):  # several blocks
        got = tgrid.mark_invisible_cells(tst, torch.from_numpy(K), torch.from_numpy(c2w), W, H,
                                         near, tcfg)
    return want, got


@pytest.mark.parametrize("seed", range(4))
def test_mark_invisible_cells_exact(seed):
    want, got = _mark_both(*_cameras(seed), 32, 24, 0.05)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    seen = np.asarray(want["occs"]) >= 0
    assert 0.0 < seen.mean() < 1.0


def test_mark_invisible_cells_exact_on_the_image_border():
    K, c2w = _border_camera()
    want, got = _mark_both(K, c2w, 4, 4, 0.0, levels=1, R=4)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    c = np.array([-0.75, -0.25, 0.25, 0.75], np.float32)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    u = (np.float32(20) * x) / (z + np.float32(4))
    on_border = u == 4.0
    assert on_border.sum() == 4  # x = 0.75 at depth 3.75, every y
    seen = np.asarray(want["occs"])[0] >= 0
    assert not seen[on_border].any() and seen.any()  # u < width: off the image
    assert not np.asarray(want["binaries"])[0][~seen].any()


def test_premark_occ_states_matches_acn_tpu():
    from acn_tpu import runner as jrunner

    K, c2w_rdf = _cameras(7, C=5)
    # the runner takes RUB poses and turns them into RDF ones
    c2w = np.concatenate([c2w_rdf[:, :, :3] @ np.diag([1, -1, -1]).astype(np.float32),
                          c2w_rdf[:, :, 3:]], 2)
    intr = np.stack([K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]], 1)
    boxes = np.array([[[-1, -1, -1], [1, 0.1, 0.1]], [[-1, -0.1, -0.1], [1, 1, 1]]], np.float32)
    jcfg = jgrid.OccConfig(resolution=16, levels=1)
    mds = [types.SimpleNamespace(intrinsics=i, c2w=c, W=32, H=24) for i, c in zip(intr, c2w)]
    want = jax.device_get(jrunner.premark_occ_states(None, jcfg, boxes, mds, near_plane=0.05))
    from acn_tpu_torch.runner import premark_occ_states
    tcfg = convert.occ_config_from_dict(dataclasses.asdict(jcfg))
    got = premark_occ_states(tcfg, boxes, intr, c2w, 32, 24, 0.05, device="cpu")
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    assert 0.0 < (np.asarray(want["occs"]) < 0).mean() < 1.0
    fresh = premark_occ_states(tcfg, boxes, np.zeros((0, 4)), np.zeros((0, 3, 4)), 32, 24, 0.05,
                               device="cpu")
    assert (fresh["occs"] == 0).all() and fresh["occs"].shape == got["occs"].shape
