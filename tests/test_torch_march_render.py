"""Parity of the port's budget march, packed compositing and soft-MoE
budget renderer, and of its fixed-layout compositing, stratified sampling
and strided soft-MoE renderer (acn_tpu_torch.occupancy.grid / nerfs.render /
nerfs.render_occ), with acn_tpu's.

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

Fixed layouts: weights and composites rtol 1e-5 (``torch.cumprod`` and
``jnp.cumprod`` multiply in another order), gradients rtol 1e-4 / atol 1e-6,
with densities and colors placed on the clamps' bounds (JAX passes half the
gradient there). Stratified depths: bit-equal with JAX op by op, with and
without JAX's jitter. The renderers: atol 1e-5 on values in [0, 1], rtol
1e-5 on depths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.models import container as jcont
from acn_tpu.nerfs import render as jrender
from acn_tpu.nerfs import render_occ as jrocc
from acn_tpu.occupancy import grid as jgrid
from acn_tpu_torch.models import container as tcont
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
    assert tgrid.unit_linspace(65, dev) is tgrid.unit_linspace(65, dev)
    for n in (2, 7, 17, 65, 96, 257):  # jnp.linspace's bits, jitted as it is
        np.testing.assert_array_equal(tgrid.unit_linspace(n, dev)[0].numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n)))


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
    # the policy is ported; without a generator or draws it says what it needs
    with pytest.raises(ValueError, match="random"):
        trender.bg_default_color(2, "random")
    with pytest.raises(ValueError):
        trender.bg_default_color(2, "plaid")


# ------------------------------------------- fixed-layout and stratified


def _fixed_inputs(seed, n=40, s=24):
    """A fixed (n, s) layout: increasing bins, densities with zeros among
    them (σ on the clamp's bound), colors with exact 0 and 1 (on the clip's
    bounds), a mask and stride-widened widths."""
    rng = np.random.default_rng(seed)
    t0 = np.cumsum(rng.uniform(0.01, 0.1, (n, s)), axis=1).astype(np.float32) + 1.0
    t1 = (t0 + rng.uniform(0.0, 0.05, (n, s))).astype(np.float32)
    sig = rng.exponential(6.0, (n, s)).astype(np.float32)
    sig[:, ::7] = 0.0
    rgb = rng.uniform(-0.2, 1.2, (n, s, 3)).astype(np.float32)
    rgb[:, ::5] = 1.0
    rgb[:, 1::5] = 0.0
    mask = rng.random((n, s)) < 0.8
    dts = ((t1 - t0) * rng.integers(1, 4, (n, 1))).astype(np.float32)
    bg = rng.random((n, 3)).astype(np.float32)
    ct = rng.normal(size=(n, 3)).astype(np.float32)
    return t0, t1, sig, rgb, mask, dts, bg, ct


@pytest.mark.parametrize("mask_and_dts", [False, True])
def test_render_weights_and_composite_match_jax_with_gradients(mask_and_dts):
    t0, t1, sig, rgb, mask, dts, bg, ct = _fixed_inputs(8)
    rgb = np.clip(rgb, 0.0, 1.0)
    m, w_ = (mask, dts) if mask_and_dts else (None, None)

    def jfn(s, c, b):
        w, trans = jrender.render_weights_from_density(
            jnp.asarray(t0), jnp.asarray(t1), s,
            None if m is None else jnp.asarray(m), None if w_ is None else jnp.asarray(w_))
        out = jrender.composite(w, c, 0.5 * jnp.asarray(t0 + t1), b)
        return jnp.sum(out[0] * ct) + jnp.sum(out[1]) + jnp.sum(out[2]), (w, trans, out)

    (_, (jw, jtr, jout)), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(sig), jnp.asarray(rgb), jnp.asarray(bg))
    args = [torch.tensor(a, requires_grad=True) for a in (sig, rgb, bg)]
    w, trans = trender.render_weights_from_density(
        torch.from_numpy(t0), torch.from_numpy(t1), args[0],
        None if m is None else torch.from_numpy(m),
        None if w_ is None else torch.from_numpy(w_))
    out = trender.composite(w, args[1], torch.from_numpy(0.5 * (t0 + t1)), args[2])
    (torch.sum(out[0] * torch.from_numpy(ct)) + out[1].sum() + out[2].sum()).backward()
    for g, want in zip((w, trans, *out), (jw, jtr, *jout)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)
    for a, want, name in zip(args, jg, ("sigma", "rgb", "bg")):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert float(args[0].grad.abs().max()) > 0


@pytest.mark.parametrize("raw,masked", [(False, False), (True, True), (False, True)])
def test_volume_render_matches_jax_with_gradients(raw, masked):
    t0, _, sig, rgb, mask, _, bg, ct = _fixed_inputs(9)
    rgb_sigma = np.concatenate([rgb, sig[..., None] - (3.0 if raw else 0.0)], -1)
    kw = dict(raw_rgb=raw, raw_sigma=raw, sigma_scale=1.5 if raw else 1.0)

    def jfn(rs, b):
        out = jrender.volume_render(rs, jnp.asarray(t0), b,
                                    sample_mask=jnp.asarray(mask) if masked else None,
                                    **kw)
        return jnp.sum(out[0] * ct) + jnp.sum(out[1]) + jnp.sum(out[3]), out

    (_, jout), jg = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(rgb_sigma), jnp.asarray(bg))
    rs, b = (torch.tensor(a, requires_grad=True) for a in (rgb_sigma, bg))
    out = trender.volume_render(rs, torch.from_numpy(t0), b,
                                sample_mask=torch.from_numpy(mask) if masked else None,
                                **kw)
    (torch.sum(out[0] * torch.from_numpy(ct)) + out[1].sum() + out[3].sum()).backward()
    for g, want, name in zip(out, jout, ("rgb", "depth", "weights", "acc")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    for a, want, name in zip((rs, b), jg, ("rgb_sigma", "bg")):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("ray_samples,jitter", [(96, False), (96, True), (16, True),
                                                (7, False)])
def test_stratified_t_vals_bit_equal(ray_samples, jitter):
    """Without jitter the edges of ``jnp.linspace``; with it JAX's own
    ``u`` from the same key. JAX op by op, but ``jnp.linspace`` jitted as it
    always is (under ``jax.disable_jit`` it divides exactly instead of
    multiplying by the rounded reciprocal, and its values change)."""
    rays = _rays(seed=10)
    key = jax.random.PRNGKey(ray_samples)
    want = jrender.stratified_t_vals(key, jnp.asarray(rays[:, 6]),
                                     jnp.asarray(rays[:, 7]), ray_samples,
                                     randomized=jitter)
    u = (torch.from_numpy(np.array(jax.random.uniform(
        key, (rays.shape[0], ray_samples), dtype=jnp.float32))) if jitter else None)
    got = trender.stratified_t_vals(torch.from_numpy(rays[:, 6]),
                                    torch.from_numpy(rays[:, 7]), ray_samples, u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("jitter", [False, True])
def test_render_rays_stratified_matches(scene, jitter):
    rays = _rays(n=48, seed=11)
    key = jax.random.PRNGKey(3)
    bg = np.random.default_rng(12).random((rays.shape[0], 3)).astype(np.float32)
    jv = jax.tree.map(jnp.asarray, scene.jvars)
    want = jax.jit(lambda v, r, b: jrender.render_rays_stratified(
        lambda xd: jcont.container_forward(v, scene.jcfg, xd), r, 24,
        key=key if jitter else None, randomized=jitter, bg_rgb=b))(
        jv, jnp.asarray(rays), jnp.asarray(bg))
    u = (torch.from_numpy(np.array(jax.random.uniform(key, (rays.shape[0], 24))))
         if jitter else None)
    with torch.no_grad():
        got = trender.render_rays_stratified(
            lambda xd: tcont.container_forward(scene.model, xd),
            torch.from_numpy(rays), 24, u=u, bg_rgb=torch.from_numpy(bg))
    assert float(np.asarray(want[3]).max()) > 0.5  # opaque enough to matter
    for g, w, name in zip(got, want, ("rgb", "depth", "weights", "acc")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("alpha_thre,jitter", [(0.0, False), (0.1, False), (0.0, True)])
def test_render_rays_occ_matches(scene, alpha_thre, jitter):
    """The strided soft-MoE renderer, midpoints and phase 0 or JAX's draws
    from the same key, against acn_tpu's (JAX op by op, so that the
    occupancy decisions see the same points)."""
    rays = _rays(seed=13)
    key = jax.random.PRNGKey(21) if jitter else None
    bg = np.random.default_rng(14).random((rays.shape[0], 3)).astype(np.float32)
    jv = jax.tree.map(jnp.asarray, scene.jvars)
    with jax.disable_jit():
        want = jax.device_get(jrocc.render_rays_occ(
            jv, scene.jocc, scene.jcfg, scene.jocc_cfg, jnp.asarray(rays), s_max=64,
            s_kept=12, alpha_thre=alpha_thre, key=key, bg_rgb=jnp.asarray(bg)))
    u = bits = None
    if jitter:
        k_jit, k_phase = jax.random.split(key)
        u = torch.from_numpy(np.array(jax.random.uniform(k_jit, (rays.shape[0], 64))))
        bits = torch.from_numpy(np.array(jax.random.randint(
            k_phase, (rays.shape[0],), 0, 1 << 30)).astype(np.int64))
    with torch.no_grad():
        got = trocc.render_rays_occ(
            scene.model, scene.tocc, scene.tocc_cfg, torch.from_numpy(rays), s_max=64,
            s_kept=12, alpha_thre=alpha_thre, u=u, phase_bits=bits,
            bg_rgb=torch.from_numpy(bg))
    assert float(want[3].max()) > 0.5
    for g, w, name in zip(got, want, ("rgb", "depth", "weights", "acc")):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)
