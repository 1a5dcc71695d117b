"""Parity of the port's occupancy update, per-ray compactions, strided march
and auto-regime switch (acn_tpu_torch.occupancy.grid,
acn_tpu_torch.pipelines.offline_stage.trainer) with acn_tpu's.

Randomness: the JAX functions draw from a key; the port takes the draws.
The tests hand the port JAX's own draws from the same key (the march's
``u`` and ``phase`` bits, the update's jitter), or run the deterministic
path (``key=None``: bin midpoints, phase 0).

Tolerances, with their reasons:

* compaction indices and masks, the march's integer outputs and its
  ``overflow``: exact. A position one ulp off can flip an occupancy cell,
  and with it a ray's whole stride, so a mismatch is a fault.
* the march's positions, bins and widths: bit-equal with JAX run op by op
  (under ``jit`` XLA fuses ``o + d·t`` into multiply-adds).
* ``update_occ_grid``'s ``occs``: rtol 1e-6 (the density MLP's products
  are summed in another order; under ``jit`` the step size diag/1000 is a
  multiply by the rounded reciprocal). ``binaries``: exact for every cell
  farther than 1e-5 (relative) from the threshold; the threshold is a mean
  over the grid, summed in another order, so a cell inside that band may
  flip. Each test asserts that the band holds under 1 % of the cells.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.models import ngp as jngp
from acn_tpu.nerfs import render_occ as jrocc
from acn_tpu.occupancy import grid as jgrid
from acn_tpu.occupancy.grid import OccConfig as JOccConfig
from acn_tpu_torch import convert
from acn_tpu_torch.models import ngp as tngp
from acn_tpu_torch.nerfs import render_occ as trocc
from acn_tpu_torch.occupancy import grid as tgrid
from acn_tpu_torch.pipelines.offline_stage import trainer as ttrainer
from test_torch_models import small_scene
from test_torch_march_render import _rays

BAND = 1e-5


def _jtrainer():
    """acn_tpu's trainer module, imported by the tests that use it: it
    imports flax (checkpoints), which a machine may lack that runs only the
    card tests."""
    from acn_tpu.pipelines.offline_stage import trainer
    return trainer


@pytest.fixture(scope="module")
def scene():
    """The small scene, its hash features scaled up: from acn_tpu's init
    (U(±1e-4)) the density is all but constant over the grid (σ within
    2e-4 of its mean), and every cell would sit at the threshold."""
    sc = small_scene()
    experts = sc.jvars["params"]["experts"]
    experts["hash_table"] = [t * 5000.0 for t in experts["hash_table"]]
    sc.model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    return sc


def _np(t):
    return t.detach().cpu().numpy()


def _occ_cfgs(**kw):
    j = JOccConfig(**kw)
    return j, convert.occ_config_from_dict(dataclasses.asdict(j))


# ------------------------------------------------------------ grid basics


def test_occ_config_carries_every_field_and_step_size():
    j, t = _occ_cfgs(resolution=32, levels=2, occ_thre=0.03, ema_decay=0.9,
                     warmup_steps=100, update_interval=8, alpha_thre=0.02,
                     alpha_thre_start=0.001, cosine_anneal=False,
                     cone_angle=0.004, near_plane=0.1, far_plane=50.0,
                     render_step_size=None)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    aabb = np.array([[-1.0, -2.0, 0.5], [1.5, 0.25, 3.0]], np.float32)
    assert t.step_size_for(aabb) == j.step_size_for(aabb)
    np.testing.assert_allclose(float(t.step_size_for_traced(torch.from_numpy(aabb))),
                               float(j.step_size_for_traced(jnp.asarray(aabb))),
                               rtol=1e-7)
    fixed = dataclasses.replace(t, render_step_size=0.25)
    assert float(fixed.step_size_for_traced(torch.from_numpy(aabb))) == 0.25


@pytest.mark.parametrize("levels", [1, 2])
def test_cell_centers_bit_equal(levels):
    j, t = _occ_cfgs(resolution=8, levels=levels)
    roi = np.array([[-1.0, -0.3, 0.2], [0.7, 1.1, 2.0]], np.float32)
    with jax.disable_jit():
        want = jgrid.cell_centers(jgrid.init_occ_state(jnp.asarray(roi), j), j)
    got = tgrid.cell_centers(tgrid.init_occ_state(torch.from_numpy(roi), t), t)
    assert got.shape == (levels, 8 ** 3, 3)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("cosine", [True, False])
@pytest.mark.parametrize("step", [0, 1, 100, 254, 255, 1000])
def test_anneal_alpha_thre(step, cosine):
    j, t = _occ_cfgs(warmup_steps=256, alpha_thre=1e-2, alpha_thre_start=1e-3,
                     cosine_anneal=cosine)
    want = float(jgrid._anneal_alpha_thre(j, step))
    got = float(tgrid._anneal_alpha_thre(t, step))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(tgrid._anneal_alpha_thre(t, torch.tensor(step))) == got


def test_init_and_dummy_occ_states(scene):
    want = jax.device_get(_jtrainer().init_occ_states(scene.boxes, scene.jocc_cfg))
    got = ttrainer.init_occ_states(torch.from_numpy(scene.boxes), scene.tocc_cfg)
    for name in ("occs", "binaries", "aabbs"):
        np.testing.assert_array_equal(_np(got[name]), want[name], err_msg=name)
    assert torch.equal(ttrainer.dummy_occ_states(4),
                       torch.from_numpy(np.array(_jtrainer().dummy_occ_states(4))))
    back = convert.to_jax_occ_states(got)
    for name in got:
        np.testing.assert_array_equal(back[name], want[name])
    again = convert.from_jax_occ_states(back, "cpu")
    assert all(torch.equal(again[n], got[n]) for n in got)


# ------------------------------------------------------------ the EMA update


def _check_update(got, want, occs_before):
    """occs within rtol 1e-6; binaries exact outside the threshold band."""
    occ_w, occ_g = np.asarray(want["occs"]), _np(got["occs"])
    np.testing.assert_allclose(occ_g, occ_w, rtol=1e-6, atol=0)
    visible = np.asarray(occs_before) >= 0
    thre = max(min(1e-2, float(occ_w[visible].mean())), 1e-6)
    band = np.abs(occ_w - thre) <= BAND * thre
    same = _np(got["binaries"]) == np.asarray(want["binaries"])
    assert same[~band].all(), int((~same[~band]).sum())
    assert band.mean() < 0.01, band.sum()
    assert 0.05 < np.asarray(want["binaries"]).mean() < 0.95  # the cut matters
    np.testing.assert_array_equal(_np(got["aabbs"]), np.asarray(want["aabbs"]))
    return int(band.sum())


@functools.lru_cache(maxsize=None)
def _jax_update(occ_cfg, expert_cfg):
    """acn_tpu's update of one expert's grid, jitted once."""
    return jax.jit(lambda p, ab, st, key: jgrid.update_occ_grid(
        st, key, lambda x: jngp.ngp_density(p, expert_cfg, ab, x)[..., 0],
        occ_cfg, occ_cfg.step_size_for_traced(ab)))


@pytest.mark.parametrize("case", ["fresh", "decayed_with_invisible"])
def test_update_occ_grid_matches(scene, case):
    k = 2
    jp = jax.tree.map(lambda a: jnp.asarray(a[k]), scene.jvars["params"]["experts"])
    aabb = scene.boxes[k]
    st = {n: np.array(v[k]) for n, v in scene.jocc.items()}
    rng = np.random.default_rng(5)
    if case == "decayed_with_invisible":
        st["occs"] = rng.exponential(1e-3, st["occs"].shape).astype(np.float32)
        st["occs"][rng.random(st["occs"].shape) < 0.1] = -1.0
    key = jax.random.PRNGKey(11)
    want = jax.device_get(_jax_update(scene.jocc_cfg, scene.jcfg.expert)(
        jp, jnp.asarray(aabb), {n: jnp.asarray(v) for n, v in st.items()}, key))
    # the jitter acn_tpu draws from the same key, injected
    R, L = scene.jocc_cfg.resolution, scene.jocc_cfg.levels
    jitter = np.array(jax.random.uniform(key, (L, R ** 3, 3), minval=-0.5, maxval=0.5))
    tp = scene.model.expert(k)
    taabb = torch.from_numpy(aabb)
    got = tgrid.update_occ_grid(
        {n: torch.from_numpy(v) for n, v in st.items()},
        lambda x: tngp.ngp_density(tp, scene.tcfg.expert, taabb, x)[..., 0],
        scene.tocc_cfg, scene.tocc_cfg.step_size_for_traced(taabb),
        jitter=torch.from_numpy(jitter))
    _check_update(got, want, st["occs"])
    if case == "decayed_with_invisible":  # invisible cells stay as they are
        inv = st["occs"] < 0
        assert (_np(got["occs"])[inv] == -1.0).all()
        assert not _np(got["binaries"])[inv].any()


def test_make_occ_update_fn_matches_over_experts(scene):
    """The all-expert update against acn_tpu's, each expert with the jitter
    JAX draws from its split of the key."""
    key = jax.random.PRNGKey(4)
    jv = jax.tree.map(jnp.asarray, scene.jvars)
    occ0 = _jtrainer().init_occ_states(scene.boxes, scene.jocc_cfg)
    with jax.disable_jit():  # op by op: no multiply-add fused into the points
        want = jax.device_get(_jtrainer().make_occ_update_fn(scene.jcfg, scene.jocc_cfg)(
            jv, occ0, key))
    R, L, K = scene.jocc_cfg.resolution, scene.jocc_cfg.levels, 4
    jitter = np.stack([np.asarray(jax.random.uniform(kk, (L, R ** 3, 3), minval=-0.5,
                                                     maxval=0.5))
                       for kk in jax.random.split(key, K)])
    update = ttrainer.make_occ_update_fn(scene.tcfg, scene.tocc_cfg)
    t0 = ttrainer.init_occ_states(torch.from_numpy(scene.boxes), scene.tocc_cfg)
    got = update(scene.model, t0, jitter=torch.from_numpy(jitter))
    for k in range(K):
        _check_update({n: v[k] for n, v in got.items()},
                      {n: v[k] for n, v in want.items()}, np.zeros((L, R, R, R)))


def test_update_occ_grid_from_a_generator_is_seeded_and_keeps_no_graph(scene):
    update = ttrainer.make_occ_update_fn(scene.tcfg, scene.tocc_cfg)
    occ0 = ttrainer.init_occ_states(torch.from_numpy(scene.boxes), scene.tocc_cfg)
    a, b, c = (update(scene.model, occ0, generator=torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    assert torch.equal(a["occs"], b["occs"]) and not torch.equal(a["occs"], c["occs"])
    assert not a["occs"].requires_grad
    with pytest.raises(ValueError, match="jitter tensor or a generator"):
        update(scene.model, occ0)


# ------------------------------------------------------------ compaction


def _valid_masks(n=48, s_max=32, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.random((n, s_max)) < rng.uniform(0.0, 1.0, (n, 1))
    v[0], v[1] = False, True  # a ray with no valid bin, one with all
    return v


@pytest.mark.parametrize("s_kept", [4, 16, 40])
def test_compact_samples_exact(s_kept):
    v = _valid_masks(seed=s_kept)
    want = jax.device_get(jgrid.compact_samples(jnp.asarray(v), s_kept))
    got = tgrid.compact_samples(torch.from_numpy(v), s_kept)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), w)


@pytest.mark.parametrize("s_kept,seed", [(4, None), (16, None), (4, 1), (7, 2)])
def test_compact_samples_strided_exact(s_kept, seed):
    """Phase 0, and the phase bits JAX draws from its key."""
    v = _valid_masks(seed=s_kept)
    key = None if seed is None else jax.random.PRNGKey(seed)
    want = jax.device_get(jgrid.compact_samples_strided(jnp.asarray(v), s_kept, key=key))
    bits = (None if key is None else torch.from_numpy(np.asarray(
        jax.random.randint(key, (v.shape[0],), 0, 1 << 30)).astype(np.int64)))
    got = tgrid.compact_samples_strided(torch.from_numpy(v), s_kept, bits)
    for name, w, g in zip(("idx", "mask", "scale"), want, got):
        np.testing.assert_array_equal(_np(g), w, err_msg=name)
    if seed is not None:  # the phases are not all 0
        assert (np.asarray(want[0]) != np.asarray(
            jgrid.compact_samples_strided(jnp.asarray(v), s_kept)[0])).any()


# ------------------------------------------------------------ the strided march


def _jax_march_draws(key, n, s_max):
    """march_rays's draws from ``key``: (u, phase bits) as torch tensors."""
    k_jit, k_phase = jax.random.split(key)
    u = jax.random.uniform(k_jit, (n, s_max), dtype=jnp.float32)
    bits = jax.random.randint(k_phase, (n,), 0, 1 << 30)
    return (torch.from_numpy(np.asarray(u)),
            torch.from_numpy(np.asarray(bits).astype(np.int64)))


MARCH_INT_KEYS = ("mask",)
MARCH_FLOAT_KEYS = ("t_starts", "t_ends", "dts", "positions")


@pytest.mark.parametrize("seed,s_kept,jitter,union", [
    (0, 16, False, False), (1, 4, True, False), (2, 64, True, True),
    (3, 8, False, True), (4, 6, True, False)])
def test_march_rays_exact(scene, seed, s_kept, jitter, union):
    """One expert's grid (or, with ``union``, the any-expert validity of the
    soft-MoE renderer), midpoints and phase 0 or JAX's own draws: the kept
    bins, mask and would-be overflow equal, the floats bit-equal (JAX op by
    op). The mask is compared, and with it which bins were kept."""
    rays = _rays(seed=seed)
    s_max, budget = 64, 5
    key = jax.random.PRNGKey(100 + seed) if jitter else None
    jstate = {k: v[1] for k, v in scene.jocc.items()}
    tstate = {k: v[1] for k, v in scene.tocc.items()}
    jx = (jrocc._any_expert_valid_fn(
        scene.jocc, jnp.asarray(scene.jvars["buffers"]["expert_aabbs"]))
        if union else None)
    tx = (trocc._any_expert_valid_fn(scene.tocc, scene.model.expert_aabbs)
          if union else None)
    with jax.disable_jit():
        want = jax.device_get(jgrid.march_rays(
            jstate, jnp.asarray(rays), scene.jocc_cfg, s_max, s_kept, key=key,
            extra_valid_fn=jx, report_budget=budget))
    u, bits = _jax_march_draws(key, rays.shape[0], s_max) if jitter else (None, None)
    got = tgrid.march_rays(tstate, torch.from_numpy(rays), scene.tocc_cfg, s_max,
                           s_kept, u=u, phase_bits=bits, extra_valid_fn=tx,
                           report_budget=budget)
    assert set(got) == set(want)
    for k in MARCH_INT_KEYS + MARCH_FLOAT_KEYS:
        np.testing.assert_array_equal(_np(got[k]), want[k], err_msg=k)
    assert float(got["overflow"]) == float(want["overflow"])
    assert want["mask"].any() and not want["mask"].all()
    if jitter:
        mid = tgrid.march_rays(tstate, torch.from_numpy(rays), scene.tocc_cfg, s_max,
                               s_kept, extra_valid_fn=tx)
        assert not torch.equal(mid["positions"], got["positions"])
        assert "overflow" not in mid


def test_report_budget_overflow_is_the_budget_march_drop(scene):
    """The would-be overflow of the strided march is the overflow that the
    budget march really has on the same rays, grid and bins (midpoints)."""
    rays = _rays(seed=7)
    tstate = {k: v[0] for k, v in scene.tocc.items()}
    for budget in (2, 4, 64):
        strided = tgrid.march_rays(tstate, torch.from_numpy(rays), scene.tocc_cfg,
                                   64, 16, report_budget=budget)
        packed = tgrid.march_rays_budget(tstate, torch.from_numpy(rays),
                                         scene.tocc_cfg, 64, budget)
        assert float(strided["overflow"]) == float(packed["overflow"])
    assert float(packed["overflow"]) == 0.0 and float(
        tgrid.march_rays(tstate, torch.from_numpy(rays), scene.tocc_cfg, 64, 16,
                         report_budget=2)["overflow"]) > 0.3


def test_draw_march_is_seeded_and_in_range():
    a = tgrid.draw_march(50, 32, torch.Generator().manual_seed(0))
    b = tgrid.draw_march(50, 32, torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    u, bits = a
    assert u.shape == (50, 32) and bits.shape == (50,)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert 0 <= int(bits.min()) and int(bits.max()) < 1 << 30


# ------------------------------------------------------------ the auto switch


@pytest.mark.parametrize("thresh,patience,readings", [
    (0.02, 3, [0.5, 0.01, 0.01, 0.5, 0.01, 0.01, 0.01, 0.0, 0.9]),
    (0.02, 3, [0.02, 0.02, 0.02]),  # on the threshold counts as under it
    (0.02, 3, [0.03] * 10),
    (0.0, 1, [0.1, 0.0, 0.0]),
    (0.05, 5, [0.04, 0.04, 0.06, 0.01, 0.01, 0.01, 0.01, 0.01, 0.01]),
])
def test_auto_regime_switches_at_the_same_reading(thresh, patience, readings):
    j = _jtrainer().AutoRegime(thresh, patience)
    t = ttrainer.AutoRegime(thresh, patience)
    want = [j.observe(r) for r in readings]
    got = [t.observe(r) for r in readings]
    assert got == want and sum(got) <= 1
    assert (t.switched, t.streak) == (j.switched, j.streak)
