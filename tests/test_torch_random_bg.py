"""The ``random`` background policy and randomized rendering of the port
(acn_tpu_torch.nerfs.render, pipelines.renderer, the training loss and the
TTO step) against acn_tpu's, on the small scene of ``test_torch_models``
without a background head (``--no_bg_nerf``).

* ``bg_default_color`` and ``apply_bg_mask`` with JAX's draws: exact.
* The ``random`` background and ``randomized`` ``render_rays`` (budget,
  strided, stratified) with JAX's per-chunk keys replayed through
  ``RenderDraws``: f32 atol 1e-5 (JAX's renderer is jitted: XLA fuses
  multiply-adds, a sample may move by an ulp); a dense frame under the
  policy with JAX's default key: u8 within 1/255, f16 rtol 1e-3.
* One strided episode loss and one TTO step with the background's draw
  replayed: rtol 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.models import container as jcont
from acn_tpu.nerfs import render as jrender
from acn_tpu.pipelines.offline_stage import train_step as jts
from acn_tpu.pipelines.online_stage import runtime_adapt as jrt
from acn_tpu.pipelines.renderer import Renderer as JRenderer
from acn_tpu.utils import optim as joptim
from acn_tpu_torch import convert, toy
from acn_tpu_torch.models import container as tcont
from acn_tpu_torch.nerfs import render as trender
from acn_tpu_torch.pipelines.offline_stage import train_step as tts
from acn_tpu_torch.pipelines.online_stage import runtime_adapt as trt
from acn_tpu_torch.pipelines.renderer import Renderer as TRenderer
from acn_tpu_torch.utils import optim as toptim
from test_torch_march_render import _rays
from test_torch_models import small_scene
from test_torch_routed import H, W, _cmp_frames, _P


def jax_chunk_draws(key=None):
    """acn_tpu's ``Renderer`` draws as ``RenderDraws`` asks for them: the key
    (``PRNGKey(0)`` by default) split once per chunk, the chunk's key into
    (background, render), the strided march's render key into (jitter,
    phase)."""
    key = jax.random.PRNGKey(0) if key is None else key
    keys = []

    def fn(what, c, shape):
        nonlocal key
        while len(keys) <= c:
            key, k = jax.random.split(key)
            keys.append(k)
        k_bg, k_render = jax.random.split(keys[c])
        if what == "bg":
            return np.array(jax.random.uniform(k_bg, shape, dtype=jnp.float32))
        if what == "salt":
            return int(jax.random.randint(k_render, (), 0, jnp.iinfo(jnp.int32).max))
        if what == "strat_u":
            return np.array(jax.random.uniform(k_render, shape, dtype=jnp.float32))
        k_jit, k_phase = jax.random.split(k_render)
        if what == "u":
            return np.array(jax.random.uniform(k_jit, shape, dtype=jnp.float32))
        return np.array(jax.random.randint(k_phase, shape, 0, 1 << 30)).astype(np.int64)

    return fn


@pytest.fixture(scope="module")
def plain_scene():
    """The small scene without a background head (``--no_bg_nerf``)."""
    return small_scene(sigma_bias=1.0, alpha_thre=1e-2, budget=8, s_max=64, fill=0.3,
                       use_bg_nerf=False)


@pytest.mark.parametrize("path", ["budget", "strided", "stratified"])
@pytest.mark.parametrize("randomized", [False, True])
def test_random_background_and_randomized_render_rays(plain_scene, path, randomized):
    sc = plain_scene
    P = _P(sc, bg_color_default="random", occ_budget_per_ray=8 if path == "budget" else 0,
           ray_samples=24)
    occ_j, occ_t = (None, None) if path == "stratified" else (sc.jocc_cfg, sc.tocc_cfg)
    jr = JRenderer(sc.jcfg, P, occ_j, chunk_rays=40)
    tr = TRenderer(sc.tcfg, P, occ_t, chunk_rays=40, device="cpu")
    rays = _rays(n=100, seed=8)
    key = jax.random.PRNGKey(12)
    want = jr.render_rays(sc.jvars, sc.jocc, rays, key=key, randomized=randomized,
                          with_stats=True)
    got = tr.render_rays(sc.model, sc.tocc, rays, draws=jax_chunk_draws(key),
                         randomized=randomized, with_stats=True)
    inert = rays[:, 7] < rays[:, 6]
    assert np.ptp(got[0][inert]) > 0.3  # the sky's colors are random
    for name, g, w in zip(("rgb", "depth", "acc", "wmax", "went"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


def test_random_background_frame_and_generator(plain_scene):
    """A dense frame under the ``random`` policy with JAX's default key, and
    a generator's draws: reproducible, on the generator's device."""
    sc = plain_scene
    P = _P(sc, bg_color_default="random")
    cam = toy.overhead_camera(H, W, lift=3.0)
    want = JRenderer(sc.jcfg, P, sc.jocc_cfg).render_image(sc.jvars, sc.jocc, H=H, W=W,
                                                           **cam)
    tr = TRenderer(sc.tcfg, P, sc.tocc_cfg, device="cpu")
    _cmp_frames(tr.render_image(sc.model, sc.tocc, H=H, W=W, draws=jax_chunk_draws(),
                                **cam), want)
    a, b = (tr.render_image(sc.model, sc.tocc, H=H, W=W,
                            draws=torch.Generator().manual_seed(3), **cam) for _ in range(2))
    np.testing.assert_array_equal(a[0], b[0])
    assert np.ptp(a[0][0, 0:4]) > 0  # sky pixels differ


def test_bg_default_color_and_apply_bg_mask():
    key = jax.random.PRNGKey(2)
    u = np.array(jax.random.uniform(key, (6, 3), dtype=jnp.float32))
    np.testing.assert_array_equal(
        trender.bg_default_color(6, "random", u=torch.from_numpy(u)).numpy(),
        np.asarray(jrender.bg_default_color(key, 6, "random")))
    with pytest.raises(ValueError, match="generator or injected draws"):
        trender.bg_default_color(6, "random")
    g = trender.bg_default_color(6, "random", generator=torch.Generator().manual_seed(0))
    assert g.shape == (6, 3) and ((g >= 0) & (g < 1)).all()
    rgb = np.random.default_rng(0).random((6, 3)).astype(np.float32)
    mask = np.array([1, 0, 1, 0, 0, 1], bool)
    for policy in ("none", "last_sample", "white", "black", "random", "other"):
        want = jrender.apply_bg_mask(jnp.asarray(rgb), jnp.asarray(mask), policy,
                                     key=key if policy == "random" else None)
        got = trender.apply_bg_mask(torch.from_numpy(rgb), torch.from_numpy(mask), policy,
                                    u=torch.from_numpy(u) if policy == "random" else None)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=policy)


def test_episode_loss_with_random_background(plain_scene):
    """One strided episode loss and gradient under ``--no_bg_nerf`` with the
    ``random`` policy, JAX's background draw (the loss key's second half)
    replayed."""
    sc = plain_scene
    P = types.SimpleNamespace(**{**vars(_P(sc)), "bg_color_default": "random",
                                 "occ_budget_per_ray": 0, "color_space": "linear",
                                 "use_amp": False, "train_chunk_rays": 0})
    k = 1
    batch = toy.training_batch(4, 1, 64, 8, seed=3)
    rays, rgbs = batch["support_rays"][k, 0].copy(), batch["support_rgbs"][k, 0]
    rays[::5, 6:8] = (0.0, -1.0)  # inert: their color is the background's
    key = jax.random.PRNGKey(8)
    jloss, jprep = jts.make_episode_loss(sc.jcfg, P, sc.jocc_cfg)
    jstate = {n: v[k] for n, v in sc.jocc.items()}
    jp = jax.tree.map(lambda a: jnp.asarray(a[k]), sc.jvars["params"]["experts"])
    aabb = jnp.asarray(sc.jvars["buffers"]["expert_aabbs"][k])

    def jfn(p):
        smp = jprep(jstate, jnp.asarray(rays), key)
        return jloss(p, None, aabb, jstate, jnp.asarray(rays), jnp.asarray(rgbs), key,
                     samples=smp)

    want = float(jax.jit(jfn)(jp))
    k_jit, k_phase = jax.random.split(key)
    n = rays.shape[0]
    rand = (torch.from_numpy(np.array(jax.random.uniform(k_jit, (n, P.occ_s_max)))),
            torch.from_numpy(np.array(jax.random.randint(k_phase, (n,), 0, 1 << 30),
                                      np.int64)))
    bg = torch.from_numpy(np.array(jax.random.uniform(jax.random.split(key)[1], (n, 3))))
    tloss, tprep = tts.make_episode_loss(sc.tcfg, P, sc.tocc_cfg)
    tp = tcont.expert_slice(sc.model.params()["experts"], k)
    smp = tprep({n_: v[k] for n_, v in sc.tocc.items()}, torch.from_numpy(rays), rand)
    with torch.no_grad():
        got = float(tloss(tp, None, sc.model.expert_aabbs[k], torch.from_numpy(rays),
                          torch.from_numpy(rgbs), smp, bg=bg))
        white = float(tloss(tp, None, sc.model.expert_aabbs[k], torch.from_numpy(rays),
                            torch.from_numpy(rgbs), smp, bg=torch.ones(n, 3)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert abs(got - white) > 1e-3  # the draw matters
    rnd = tts.EpisodeDraws(lambda what, k_, t, j, shape: np.zeros(shape, np.float32),
                           torch.device("cpu"), "strided", P, sc.tcfg)
    assert rnd.bg(0, 0, 1, 5).shape == (5, 3)
    with pytest.raises(ValueError, match="generator or injected draws"):
        tloss(tp, None, sc.model.expert_aabbs[k], torch.from_numpy(rays),
              torch.from_numpy(rgbs), smp)


def test_tto_step_with_random_background(plain_scene):
    """One strided TTO step under ``--no_bg_nerf`` with the ``random``
    policy, JAX's draws (background and render) replayed: the loss and the
    first moment (the clipped gradient)."""
    sc = plain_scene
    P = types.SimpleNamespace(**{**vars(_P(sc)), "bg_color_default": "random",
                                 "color_space": "linear", "optimizer": "adam",
                                 "encoding_lr": 1e-2, "sigma_lr": 2e-3, "color_lr": 2e-3,
                                 "bg_lr": 1e-3, "lr": 1e-4, "outer_steps": 10,
                                 "decay_factor": 10.0, "no_scheduler": False,
                                 "guard_nonfinite": 1})
    batch = toy.training_batch(4, 1, 48, 8, seed=6)
    rays, rgbs = batch["support_rays"][0, 0].copy(), batch["support_rgbs"][0, 0]
    rays[::4, 6:8] = (0.0, -1.0)
    key = jax.random.PRNGKey(31)
    jopt = joptim.build_optimizer(P, jcont.param_group_labels(sc.jvars, sc.jcfg),
                                  grad_clip=1.0)
    jstep = jrt.make_tto_step(sc.jcfg, P, jopt, sc.jocc_cfg, True)
    jparams = jax.tree.map(jnp.asarray, sc.jvars["params"])
    _, _, jloss = jstep(jparams, jopt.init(jparams), sc.jvars["buffers"], sc.jocc,
                        jnp.asarray(rays), jnp.asarray(rgbs), key)
    n = rays.shape[0]
    k_bg, k_render = jax.random.split(key)
    k_jit, k_phase = jax.random.split(k_render)
    rand = (torch.from_numpy(np.array(jax.random.uniform(k_jit, (n, P.occ_s_max)))),
            torch.from_numpy(np.array(jax.random.randint(k_phase, (n,), 0, 1 << 30),
                                      np.int64)))
    bg = torch.from_numpy(np.array(jax.random.uniform(k_bg, (n, 3))))
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    topt = toptim.build_optimizer(P, tcont.param_group_labels(model.params()), grad_clip=1.0)
    tstep = trt.make_tto_step(sc.tcfg, P, topt, sc.tocc_cfg, True)
    _, tloss = tstep(model, topt.init(model.params()), sc.tocc, torch.from_numpy(rays),
                     torch.from_numpy(rgbs), rand, bg=bg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    draws = trt.TTODraws(lambda what, b, i, shape: np.full(shape, 0.5, np.float32),
                         torch.device("cpu"), True, P, sc.tcfg)
    assert torch.equal(draws.bg(0, 0, 3), torch.full((3, 3), 0.5))
    assert callable(draws.frame(0))
