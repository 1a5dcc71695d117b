"""Parity of the port's budget march, packed compositing and soft-MoE
budget renderer (acn_tpu_torch.occupancy.grid / nerfs.render /
nerfs.render_occ) with acn_tpu's.

``march_rays_budget``'s integer outputs (validity, ray starts, packed ray
ids, real slots, ranks) must match EXACTLY, including the batch-tail-first
drop when the budget overflows: a 1-ulp difference in a sample position can
flip an occupancy or hash cell, so a mismatch is a fault to find, not a
tolerance to loosen. Float outputs: the packed geometry is the same f32
arithmetic (rtol 1e-6); composited colors go through f32 MLPs, exp/log and
differently ordered segment sums (atol 1e-5 on values in [0, 1], rtol 1e-5
on depths). With jitter (the counter hash ``_u01``) the same holds, and
the jitter itself is bit-equal. ``composite_packed``'s gradients: rtol 1e-4 /
atol 1e-6 (the reverse scan and the segment sums add in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.nerfs import render as jrender
from acn_tpu.nerfs import render_occ as jrocc
from acn_tpu.occupancy import grid as jgrid
from acn_tpu_torch.nerfs import render as trender
from acn_tpu_torch.nerfs import render_occ as trocc
from acn_tpu_torch.occupancy import grid as tgrid
from test_torch_models import small_scene

INT_KEYS = ("valid", "ray_start", "ray_id", "slot_real", "gpos")


@pytest.fixture(scope="module")
def scene():
    return small_scene(sigma_bias=2.0)


def _rays(n=96, seed=0):
    """Rays from above the box through it at random tilts, some inert
    (near 0, far −1) as the renderer makes them."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-0.9, 0.9, (n, 2)),
                        np.full((n, 1), 2.0)], 1)
    d = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), -np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nf = np.stack([rng.uniform(0.5, 1.0, n), rng.uniform(3.0, 3.5, n)], 1)
    nf[::11] = (0.0, -1.0)
    return np.concatenate([o, d, nf], 1).astype(np.float32)


def _march_both(scene, rays, s_max, budget, jit=True):
    jvalid = jrocc._any_expert_valid_fn(scene.jocc,
                                        jnp.asarray(scene.jvars["buffers"]["expert_aabbs"]))
    tvalid = trocc._any_expert_valid_fn(scene.tocc, scene.model.expert_aabbs)
    jstate = {k: v[0] for k, v in scene.jocc.items()}
    tstate = {k: v[0] for k, v in scene.tocc.items()}
    march = lambda st, r: jgrid.march_rays_budget(
        st, r, scene.jocc_cfg, s_max, budget, extra_valid_fn=jvalid)
    want = (jax.jit(march) if jit else march)(jstate, jnp.asarray(rays))
    got = tgrid.march_rays_budget(tstate, torch.from_numpy(rays),
                                  scene.tocc_cfg, s_max, budget,
                                  extra_valid_fn=tvalid)
    return jax.device_get(want), got


@pytest.mark.parametrize("budget", [64, 6, 2])  # never, sometimes, mostly full
def test_march_rays_budget_exact(scene, budget):
    # JAX op by op: under jit XLA contracts o + d·t into fused multiply-adds,
    # and its packed positions then differ from the port's by an ulp
    rays = _rays()
    want, got = _march_both(scene, rays, 64, budget, jit=False)
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert float(got["overflow"]) == float(want["overflow"])
    if budget == 2:
        assert float(want["overflow"]) > 0.3  # the drop path is exercised
    if budget == 64:
        assert float(want["overflow"]) == 0.0
    for k in ("t0_b", "t1_b", "xd", "t_starts", "t_ends"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_bin_edges_are_made_once_per_device():
    # a host-to-device copy in every chunk would make the host wait for the
    # card once per chunk; the edges are copied once and reused
    dev = torch.device("cpu")
    assert tgrid.bin_edges(64, dev) is tgrid.bin_edges(64, dev)
    np.testing.assert_array_equal(tgrid.bin_edges(64, dev)[0].numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, 65)))


def test_composite_packed_matches(scene):
    rays = _rays(seed=1)
    want_s, _ = _march_both(scene, rays, 64, 8)
    rng = np.random.default_rng(2)
    B = want_s["xd"].shape[0]
    sig = rng.exponential(8.0, B).astype(np.float32)
    rgb = rng.random((B, 3)).astype(np.float32)
    bg = rng.random((rays.shape[0], 3)).astype(np.float32)
    samples_t = {k: torch.from_numpy(np.array(v)) for k, v in want_s.items()}
    for thre in (0.0, 0.05):
        want = jax.jit(jrender.composite_packed, static_argnums=(3, 5))(
            jnp.asarray(sig), jnp.asarray(rgb),
            {k: jnp.asarray(v) for k, v in want_s.items()}, rays.shape[0],
            jnp.asarray(bg), thre)
        got = trender.composite_packed(
            torch.from_numpy(sig), torch.from_numpy(rgb), samples_t,
            rays.shape[0], bg_rgb=torch.from_numpy(bg), alpha_thre=thre)
        for w, g in zip(want[:3], got[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        for k in ("wmax", "went"):
            np.testing.assert_allclose(got[3][k].numpy(), np.asarray(want[3][k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_bg_default_color():
    assert trender.bg_default_color(3, "none") is None
    assert torch.equal(trender.bg_default_color(2, "white"), torch.ones(2, 3))
    assert torch.equal(trender.bg_default_color(2, "black"), torch.zeros(2, 3))


@pytest.mark.parametrize("alpha_thre", [0.0, 0.1])
def test_render_rays_occ_budget_matches(scene, alpha_thre):
    rays = _rays(seed=3)
    jv = jax.tree.map(jnp.asarray, scene.jvars)
    bg = np.random.default_rng(4).random((rays.shape[0], 3)).astype(np.float32)
    want = jax.jit(lambda v, occ, r, b: jrocc.render_rays_occ_budget(
        v, occ, scene.jcfg, scene.jocc_cfg, r, s_max=64, budget_per_ray=6,
        alpha_thre=alpha_thre, bg_rgb=b))(jv, scene.jocc, jnp.asarray(rays),
                                         jnp.asarray(bg))
    with torch.no_grad():
        got = trocc.render_rays_occ_budget(
            scene.model, scene.tocc, scene.tocc_cfg, torch.from_numpy(rays),
            s_max=64, budget_per_ray=6, alpha_thre=alpha_thre,
            bg_rgb=torch.from_numpy(bg))
    rgb_w, depth_w, extras_w, acc_w = want
    rgb_g, depth_g, extras_g, acc_g = got
    assert float(acc_w.max()) > 0.5  # opaque enough that the scan matters
    np.testing.assert_allclose(rgb_g.numpy(), np.asarray(rgb_w), atol=1e-5)
    np.testing.assert_allclose(acc_g.numpy(), np.asarray(acc_w), atol=1e-5)
    np.testing.assert_allclose(depth_g.numpy(), np.asarray(depth_w), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(extras_g["wmax"].numpy(),
                               np.asarray(extras_w["wmax"]), atol=1e-5)


# ------------------------------------------------ jitter and the gradients


def _u01_uint32(idx, salt):
    """acn_tpu's ``_u01`` (a closure of its ``march_rays_budget``) in numpy
    uint32 arithmetic."""
    with np.errstate(over="ignore"):
        h = (idx.astype(np.uint32) + np.uint32(salt)) * np.uint32(0x9E3779B1)
        h = (h ^ (h >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return (h >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))


@pytest.mark.parametrize("salt", [0, 1, 0x7FFFFFFE, 0x12345678, 0x7FFF0000])
def test_u01_bit_equal_to_uint32_arithmetic(salt):
    idx = np.concatenate([np.arange(4096), np.random.default_rng(salt % 97)
                          .integers(0, 2**31 - 1, 4096)]).astype(np.int64)
    want = _u01_uint32(idx, salt)
    got = tgrid._u01(torch.from_numpy(idx), salt).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(  # the salt as a tensor, as on the card
        tgrid._u01(torch.from_numpy(idx), torch.tensor(salt)).numpy(), want)
    assert got.min() >= 0.0 and got.max() < 1.0 and 0.4 < got.mean() < 0.6


@pytest.mark.parametrize("seed,budget", [(0, 64), (1, 6), (2, 2), (3, 6)])
def test_march_rays_budget_jittered_exact(scene, seed, budget):
    """One expert's grid, no extra validity, with jitter, as the training
    step marches: the salt acn_tpu draws from its key goes to the port.
    Integers equal, floats bit-equal; JAX op by op (no fusion)."""
    rays = _rays(seed=seed)
    key = jax.random.PRNGKey(seed)
    salt = int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max))
    jstate = {k: v[1] for k, v in scene.jocc.items()}
    tstate = {k: v[1] for k, v in scene.tocc.items()}
    with jax.disable_jit():
        want = jax.device_get(jgrid.march_rays_budget(
            jstate, jnp.asarray(rays), scene.jocc_cfg, 64, budget, key=key))
    got = tgrid.march_rays_budget(tstate, torch.from_numpy(rays),
                                  scene.tocc_cfg, 64, budget, salt=salt)
    mid = tgrid.march_rays_budget(tstate, torch.from_numpy(rays),
                                  scene.tocc_cfg, 64, budget)
    for k in INT_KEYS + ("t0_b", "t1_b", "xd", "t_starts", "t_ends", "overflow"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert not torch.equal(got["xd"], mid["xd"])  # the jitter moved the samples


def _composite_inputs(scene, seed):
    rays = _rays(seed=seed)
    smp, _ = _march_both(scene, rays, 64, 6)
    rng = np.random.default_rng(seed + 20)
    B = smp["xd"].shape[0]
    sig = rng.exponential(8.0, B).astype(np.float32)
    sig[::17] = 0.0  # σ on the clamp's bound
    rgb = rng.random((B, 3)).astype(np.float32)
    bg = rng.random((rays.shape[0], 3)).astype(np.float32)
    ct = rng.normal(size=(rays.shape[0], 3)).astype(np.float32)
    return rays.shape[0], smp, sig, rgb, bg, ct


@pytest.mark.parametrize("alpha_thre", [0.0, 0.05])
def test_composite_packed_gradients_match_jax_grad(scene, alpha_thre):
    n, smp, sig, rgb, bg, ct = _composite_inputs(scene, 5)
    jsmp = {k: jnp.asarray(v) for k, v in smp.items()}

    def jfn(s, c, b):
        out = jrender.composite_packed(s, c, jsmp, n, b, alpha_thre)
        return jnp.sum(out[0] * ct) + jnp.sum(out[2])

    want = jax.jit(jax.grad(jfn, argnums=(0, 1, 2)))(
        jnp.asarray(sig), jnp.asarray(rgb), jnp.asarray(bg))
    args = [torch.tensor(a, requires_grad=True) for a in (sig, rgb, bg)]
    tsmp = {k: torch.from_numpy(np.array(v)) for k, v in smp.items()}
    out = trender.composite_packed(args[0], args[1], tsmp, n, bg_rgb=args[2],
                                   alpha_thre=alpha_thre, with_stats=False)
    assert out[3] == {}
    (torch.sum(out[0] * torch.from_numpy(ct)) + torch.sum(out[2])).backward()
    for a, w, name in zip(args, want, ("sigma", "rgb", "bg")):
        assert float(a.grad.abs().max()) > 0
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_composite_packed_stats_do_not_change_the_rest(scene):
    n, smp, sig, rgb, bg, _ = _composite_inputs(scene, 6)
    tsmp = {k: torch.from_numpy(np.array(v)) for k, v in smp.items()}
    a = trender.composite_packed(torch.from_numpy(sig), torch.from_numpy(rgb),
                                 tsmp, n, bg_rgb=torch.from_numpy(bg))
    b = trender.composite_packed(torch.from_numpy(sig), torch.from_numpy(rgb),
                                 tsmp, n, bg_rgb=torch.from_numpy(bg),
                                 with_stats=False)
    assert set(a[3]) == {"wmax", "went"} and b[3] == {}
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)


def test_random_background_policy_is_named_as_not_ported():
    with pytest.raises(NotImplementedError, match="random"):
        trender.bg_default_color(2, "random")
    with pytest.raises(ValueError):
        trender.bg_default_color(2, "plaid")
