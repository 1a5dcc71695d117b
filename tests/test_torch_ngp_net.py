"""The NGP expert's network and the soft-MoE blend (acn_tpu_torch.ops.ngp_net):
its plain version in every mode against acn_tpu's functions on the CPU, the
config checks, the routing of the serving call sites, and the CUDA kernel
against the plain version on the card (``requires_cuda``).

The same numpy inputs, made from a seed, go through both packages at micro
widths; the JAX weights come from acn_tpu's own init and are carried across
with ``convert``. Tolerances, with their reasons:

* CPU, plain against JAX, float32: rtol 1e-5 / atol 1e-6 — the same
  network, whose matrix products the two frameworks sum in other orders;
* card, kernel against plain, float32: rtol 1e-5 / atol 1e-6 on σ and rgb
  — the kernel sums its layer products on the tensor cores in 3xTF32 (each
  operand split into two TF32 parts, the small × small product dropped) in
  its own order, cuBLAS in full f32 in another; everything else rounds as
  the plain ops do. ``test_3xtf32_products_match_plain_and_jax`` emulates
  the split on the CPU and holds it to the same tolerance,
  ``test_3xtf32_tile_order_matches_plain_and_jax`` the kernel's order too
  (each 8-input tile's products summed, then added in input order);
* card, the ``wide`` expert (σ trunk 256 × 8, colour 128 × 5): rtol 3e-4
  / atol 1e-6 (``WIDE_RTOL``). Over 8 layers of 256, float32 itself drifts
  from float64: with weights that keep the activations' scale (gain 2.45
  over torch's init) and features ×10 or ×20, σ's pre-activation reaches
  tens and σ = exp(z) carries z's absolute error as its relative one. On
  the CPU, over 6 seeds of 1,024 points, plain f32 lay 3.2e-5 to 7.2e-5
  (relative) from float64 below the clamp, the emulated kernel order
  (``_mm_3xtf32_tiles``) 2.0e-5 to 5.2e-5, and the two up to 1.17e-4 from
  each other: 1e-5 cannot hold, 3e-4 leaves a margin of 2.5
  (``test_wide_tolerance_from_the_emulation_against_float64`` keeps one of
  those draws).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.models import container as jcont
from acn_tpu.models import ngp as jngp
from acn_tpu.models.container import ContainerConfig as JContainerConfig
from acn_tpu.models.encodings import HashGridConfig as JHashGridConfig
from acn_tpu.models.ngp import NGPConfig as JNGPConfig
from acn_tpu.nerfs import render_occ as jrocc
from acn_tpu_torch import convert, toy
from acn_tpu_torch.models import container as tcont
from acn_tpu_torch.models import ngp as tngp
from acn_tpu_torch.models import nn as tnn
from acn_tpu_torch.models.ngp import NGPConfig
from acn_tpu_torch.models.encodings import HashGridConfig
from acn_tpu_torch.nerfs import render_occ as trocc
from acn_tpu_torch.ops import ngp_net

from test_torch_models import SMALL_HASH

RTOL, ATOL = 1e-5, 1e-6
WIDE_RTOL = 3e-4  # the wide expert, kernel against plain f32 (module docstring)

# (hidden, color_hidden, sigma_depth, color_depth, dir_encoding, sh_levels or
# freq_pe_dim, boundary_margin): every SH level count asked for and the
# frequency encoding, depths 1 to 3, widths 16 and 64, one-hot and soft
CONFIGS = [
    (16, 16, 1, 1, "spherical", 1, 1.0),
    (16, 16, 2, 3, "spherical", 4, 1.1),
    (64, 64, 3, 2, "spherical", 5, 1.0),
    (16, 64, 2, 2, "frequency", 2, 1.1),
    (64, 16, 1, 3, "spherical", 4, 1.1),
    (64, 64, 2, 2, "spherical", 4, 1.0),
]
MODES = ["single", "density_single", "linear_blend", "density", "sigma_blend"]


@pytest.fixture(autouse=True)
def one_thread():
    """Micro shapes gain nothing from torch's threads, and under several
    workers their threads wait on each other's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jexpert(hidden, color_hidden, sd, cd, enc, lv, hash_kw=()):
    kw = dict(sh_levels=lv) if enc == "spherical" else dict(freq_pe_dim=lv)
    return JNGPConfig(hidden=hidden, color_hidden=color_hidden, sigma_depth=sd,
                      color_depth=cd, dir_encoding=enc,
                      hash=JHashGridConfig(**{**SMALL_HASH, **dict(hash_kw)}), **kw)


# configurations the kernel's first versions refused, each (conf as in
# CONFIGS, K, hash overrides over SMALL_HASH): 20 experts; width 160 at
# depth 5 (the wide path); L·F 128 (the 128 class by its input) and 256
WIDER = {
    "K20": ((16, 16, 2, 2, "spherical", 4, 1.1), 20, ()),
    "w160d5": ((160, 160, 5, 5, "spherical", 4, 1.1), 4, ()),
    "lf128": ((32, 32, 2, 2, "spherical", 4, 1.1), 4,
              (("levels", 16), ("features_per_level", 8))),
    "lf256": ((32, 32, 2, 2, "spherical", 4, 1.1), 4,
              (("levels", 16), ("features_per_level", 16))),
}

_SCENES = {}


def _scene(conf, K=4, seed=0, hash_kw=()):
    """K experts in both packages with one set of weights: (jcfg, jvars,
    tcfg, model on the CPU). The port's init (torch's Linear init, hash
    tables ×100 so that the features, not the biases, set the outputs)
    carried to JAX with ``convert.to_jax_variables``. Up to 4 experts take
    the quadrants, more ``toy.expert_layout``'s grid."""
    key = (conf, K, seed, hash_kw)
    if key not in _SCENES:
        *expert, margin = conf
        jcfg = JContainerConfig(num_submodules=K, boundary_margin=margin, cluster_2d=True,
                                use_bg_nerf=False, expert=_jexpert(*expert, hash_kw))
        boxes = np.asarray([[[-1.0, -1.0 if iy < 0 else -0.1, -1.0 if iz < 0 else -0.1],
                             [1.0, 0.1 if iy < 0 else 1.0, 0.1 if iz < 0 else 1.0]]
                            for iy in (-1, 1) for iz in (-1, 1)][:K], np.float32)
        cents = np.asarray([[0.0, 0.5 * iy, 0.5 * iz] for iy in (-1, 1)
                            for iz in (-1, 1)][:K], np.float32)
        if K > 4:
            boxes, cents = toy.expert_layout(K)
        gaabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
        tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
        model = tcont.init_container(tcfg, *map(torch.from_numpy, (cents, boxes, gaabb)),
                                     generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            for t in model.experts["hash_table"]:
                t.mul_(100.0)
        _SCENES[key] = (jcfg, convert.to_jax_variables(model), tcfg, model)
    return _SCENES[key]


def _xd(n=257, seed=3):
    rng = np.random.default_rng(seed)
    xd = rng.uniform(-1.0, 1.0, (n, 6)).astype(np.float32)
    xd[::17, 3:6] = 0.0  # a zero direction: the norm's clamp
    return xd


def _np(t):
    return t.detach().cpu().numpy()


_JAX_WANT = {}


def _jax_want(conf, mode, k=2, K=4, hash_kw=()):
    """acn_tpu's function in ``mode`` on ``_xd()`` (cached: the tests of
    the plain version and of the 3xTF32 emulation share it)."""
    key = (conf, mode, k, K, hash_kw)
    if key not in _JAX_WANT:
        jcfg, jvars, _, _ = _scene(conf, K, hash_kw=hash_kw)
        xd = _xd()
        jv = jax.tree.map(jnp.asarray, jvars)
        jp = jax.tree.map(lambda a: a[k], jv["params"]["experts"])
        ab = jnp.asarray(jvars["buffers"]["expert_aabbs"][k])
        if mode == "single":
            want = jax.jit(lambda p, b, x: jngp.ngp_forward(p, jcfg.expert, b, x))(jp, ab, xd)
        elif mode == "density_single":
            want = jax.jit(lambda p, b, x: jngp.ngp_density(p, jcfg.expert, b, x))(
                jp, ab, xd[:, :3])[:, 0]
        elif mode == "linear_blend":
            want = jax.jit(lambda v, x: jcont.container_forward(v, jcfg, x))(jv, xd)
        elif mode == "density":
            want = jax.jit(lambda v, x: jcont.container_density(v, jcfg, x))(jv, xd[:, :3])
        else:
            want = jnp.concatenate([a.reshape(a.shape[0], -1) for a in jax.jit(
                lambda v, x: jrocc._soft_moe_eval(v, jcfg, x))(jv, xd)[::-1]], axis=1)
        _JAX_WANT[key] = np.asarray(want)
    return _JAX_WANT[key]


def _port_outputs(conf, mode, k=2, entry=True, K=4, hash_kw=()):
    """``ngp_net_plain`` in ``mode`` on ``_xd()`` and, with ``entry``, the
    port's entry point that takes it under ``torch.no_grad``."""
    _, _, tcfg, model = _scene(conf, K, hash_kw=hash_kw)
    xt = torch.from_numpy(_xd())
    ecfg = tcfg.expert
    with torch.no_grad():
        h_all = tcont.expert_features(model, xt[:, :3])
        experts = tcont.net_experts(model)
        w = tcont.routing_weights(model.centroids, xt[:, :3], tcfg.cluster_2d,
                                  tcfg.boundary_margin)
        if mode == "single":
            got = [ngp_net.ngp_net_plain("single", h_all[k:k + 1], xt[:, 3:6], None,
                                         [experts[k]], ecfg),
                   entry and tcont.container_forward(model, xt, active_module=k)]
        elif mode == "density_single":
            got = [ngp_net.ngp_net_plain("density", h_all[k:k + 1], None, None,
                                         [experts[k]], ecfg),
                   entry and tcont.container_density(model, xt[:, :3], active_module=k)]
        elif mode == "linear_blend":
            got = [ngp_net.ngp_net_plain("linear_blend", h_all, xt[:, 3:6], w, experts, ecfg),
                   entry and tcont.container_forward(model, xt)]
        elif mode == "density":
            got = [ngp_net.ngp_net_plain("density", h_all, None, w, experts, ecfg),
                   entry and tcont.container_density(model, xt[:, :3])]
        else:
            got = [ngp_net.ngp_net_plain("sigma_blend", h_all, xt[:, 3:6], w, experts, ecfg),
                   entry and trocc._soft_moe_eval(model, xt)]
            got = [o if o is False else torch.cat([t.reshape(t.shape[0], -1)
                                                   for t in o[::-1]], dim=1) for o in got]
    return got if entry else got[:1]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("conf", CONFIGS, ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_jax(conf, mode):
    """``ngp_net_plain`` in each mode, and the port's entry point that takes
    it under ``torch.no_grad``, against acn_tpu's function on the CPU."""
    want = _jax_want(conf, mode)
    for g in _port_outputs(conf, mode):
        assert g.shape == want.shape
        np.testing.assert_allclose(_np(g), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(WIDER))
def test_plain_matches_jax_at_wider_configs(name, mode):
    """The same at 20 experts, width 160 at depth 5, and L·F 128 and 256."""
    conf, K, hash_kw = WIDER[name]
    want = _jax_want(conf, mode, K=K, hash_kw=hash_kw)
    for g in _port_outputs(conf, mode, K=K, hash_kw=hash_kw):
        assert g.shape == want.shape
        np.testing.assert_allclose(_np(g), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- 3xTF32


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 of float32 x: round half away from zero at bit 13 of
    the int32 view (the sign bit apart, the pattern is the magnitude), the 13
    low bits cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as csrc/ngp_net.cu takes it on the tensor cores: each operand
    v = big + small, big = tf32(v), small = tf32(v − big); the sum of
    small·big + big·small + big·big (small·small dropped). The TF32
    products are exact in float64, and so is their sum here; the kernel's
    float32 accumulators round it, in their own order."""
    xb, wb = _tf32(x), _tf32(w)
    xs, ws = _tf32(x - xb), _tf32(w - wb)
    d = torch.float64
    return (xs.to(d) @ wb.to(d) + xb.to(d) @ ws.to(d) + xb.to(d) @ wb.to(d)).to(x.dtype)


def _mm_3xtf32_tiles(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``_mm_3xtf32`` in the kernel's order, every width class and the
    wide path alike: each input tile of 8 gives a partial, its 24 TF32
    products summed exactly and rounded once (the mma's own accumulation is
    not round to nearest: an approximation of its bits), and the partials
    are added to a float32 sum from 0 in input order, one rounded add each."""
    xb, wb = _tf32(x), _tf32(w)
    xs, ws = _tf32(x - xb), _tf32(w - wb)
    d = torch.float64
    acc = torch.zeros((*x.shape[:-1], w.shape[1]), dtype=x.dtype)
    for k0 in range(0, x.shape[-1], 8):
        k = slice(k0, k0 + 8)
        acc = acc + (xs[..., k].to(d) @ wb[k].to(d) + xb[..., k].to(d) @ ws[k].to(d)
                     + xb[..., k].to(d) @ wb[k].to(d)).to(x.dtype)
    return acc


def _linear_3xtf32(p, x: torch.Tensor, mm=_mm_3xtf32) -> torch.Tensor:
    y = mm(x, p["w"].to(x.dtype))  # the bias after the sum, as (x @ w) + b
    return y + p["b"].to(x.dtype) if "b" in p else y


@pytest.mark.parametrize("conf", CONFIGS, ids=lambda c: "-".join(map(str, c)))
def test_3xtf32_products_match_plain_and_jax(conf, monkeypatch):
    """The network with every layer product emulated as the kernel computes
    it (``_mm_3xtf32``), in every mode, against the plain f32 network and
    against acn_tpu's functions, within the f32 tolerances (the emulation
    moves the outputs by ≈ 1e-7 relative: the split keeps ≈ 22 bits of each
    operand)."""
    plain = {mode: _port_outputs(conf, mode, entry=False)[0] for mode in MODES}
    monkeypatch.setattr(tnn, "apply_linear", _linear_3xtf32)
    for mode in MODES:
        emu = _np(_port_outputs(conf, mode, entry=False)[0])
        want = _jax_want(conf, mode)
        assert emu.shape == want.shape and np.isfinite(emu).all()
        np.testing.assert_allclose(emu, _np(plain[mode]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(emu, want, rtol=RTOL, atol=ATOL)


TILE_CASES = {**{"-".join(map(str, c)): (c, 4, ()) for c in CONFIGS}, **WIDER}


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_3xtf32_tile_order_matches_plain_and_jax(name, monkeypatch):
    """The network with every layer product as ``_mm_3xtf32_tiles`` (the
    split and the kernel's order of sums, in the width classes and on the
    wide path), in every mode, against the plain f32 network and against
    acn_tpu's functions, within the f32 tolerances."""
    conf, K, hash_kw = TILE_CASES[name]
    kw = dict(K=K, hash_kw=hash_kw)
    plain = {mode: _port_outputs(conf, mode, entry=False, **kw)[0] for mode in MODES}
    monkeypatch.setattr(tnn, "apply_linear",
                        lambda p, x: _linear_3xtf32(p, x, mm=_mm_3xtf32_tiles))
    for mode in MODES:
        emu = _np(_port_outputs(conf, mode, entry=False, **kw)[0])
        want = _jax_want(conf, mode, **kw)
        assert emu.shape == want.shape and np.isfinite(emu).all()
        np.testing.assert_allclose(emu, _np(plain[mode]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(emu, want, rtol=RTOL, atol=ATOL)


def _wide_cfg():
    """The ``wide`` expert of ``toy.FLAG_SETS`` over the smoke's."""
    return toy.flag_config(toy.train_occ_config()[0], **toy.FLAG_SETS["wide"]).expert


def test_wide_tolerance_from_the_emulation_against_float64():
    """``WIDE_RTOL``'s derivation (module docstring): the ``wide`` expert
    with weights ×2.45 over torch's init (the activations keep their
    scale) and features N(0, 10²), 4 experts, 256 points. Plain f32 and the
    emulated kernel order each lie about as far from float64 (both above
    1e-5, below 1e-4, relative, in σ); their distance exceeds the default
    tolerance and stays within half of ``WIDE_RTOL``."""
    cfg = _wide_cfg()
    experts, h, d, w = _net_inputs(cfg, 4, 256, 16, "cpu", gain=2.45, feature_scale=10.0)
    T = lambda o: o if isinstance(o, tuple) else (o,)
    rel = lambda a, b: max(float(((x.double() - y.double()).abs()
                                  / (y.double().abs() + 1e-6)).max()) for x, y in zip(T(a), T(b)))
    plain = ngp_net.ngp_net_plain("sigma_blend", h, d, w, experts, cfg)
    f64 = ngp_net.ngp_net_plain("sigma_blend", h.double(), d.double(), w.double(),
                                [tnn.tree_map(lambda t: t.double(), e) for e in experts], cfg)
    real = tnn.apply_linear
    try:
        tnn.apply_linear = lambda p, x: _linear_3xtf32(p, x, mm=_mm_3xtf32_tiles)
        emu = ngp_net.ngp_net_plain("sigma_blend", h, d, w, experts, cfg)
    finally:
        tnn.apply_linear = real
    plain_err, emu_err, apart = rel(plain, f64), rel(emu, f64), rel(emu, plain)
    assert 1e-5 < plain_err < 1e-4 and 1e-5 < emu_err < 1e-4, (plain_err, emu_err)
    assert RTOL < apart <= WIDE_RTOL / 2, apart
    for x, y in zip(T(emu), T(plain)):
        torch.testing.assert_close(x, y, rtol=WIDE_RTOL, atol=ATOL)


def test_tf32_rounding_on_chosen_bit_patterns():
    """``_tf32`` on ties, just below and above them, negatives, subnormals,
    ±0, the largest finite values; and big + small reconstructs x to within
    the small part's own rounding."""
    bits = {  # input pattern: cvt.rna.tf32.f32's pattern
        0x3F800000: 0x3F800000,  # 1.0, exact
        0x3F800FFF: 0x3F800000,  # below the half: down
        0x3F801000: 0x3F802000,  # the tie: away from zero
        0x3F803000: 0x3F804000,  # a tie with an odd kept bit: away from zero, not to even
        0x3F801001: 0x3F802000,
        0xBF801000: 0xBF802000,  # -: away from zero
        0xBF800FFF: 0xBF800000,
        0x3FFFF000: 0x40000000,  # the carry reaches the exponent
        0x00000FFF: 0x00000000,  # subnormals: the same rule on the pattern
        0x00001000: 0x00002000,
        0x807FF000: 0x80800000,  # -subnormal rounds up to -FLT_MIN
        0x00000000: 0x00000000,  # +0
        0x80000000: 0x80000000,  # -0
        0x7F7FE000: 0x7F7FE000,  # the largest TF32 value, exact
    }
    x = torch.tensor(list(bits), dtype=torch.int64).to(torch.int32).view(torch.float32)
    got = _tf32(x).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert got.tolist() == list(bits.values())
    v = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    big = _tf32(v)
    small = _tf32(v - big)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((v - big).abs() <= big.abs() * 2.0**-11).all())
    assert bool(((big + small - v).abs() <= v.abs() * 2.0**-21).all())


@pytest.mark.parametrize("mode", ngp_net.MODES)
@pytest.mark.parametrize("enc", ["spherical", "frequency"])
def test_plain_takes_no_points(mode, enc):
    """P = 0 (a chunk that marched nothing) gives empty outputs of the
    mode's shapes; the frequency encoding of no direction included."""
    _, _, tcfg, model = _scene((16, 16, 2, 2, enc, 2, 1.1))
    xd = torch.zeros((0, 6))
    with torch.no_grad():
        h = tcont.expert_features(model, xd[:, :3])
        w = tcont.routing_weights(model.centroids, xd[:, :3], True, 1.1)
        experts = tcont.net_experts(model)
        if mode == "single":
            h, w, experts = h[:1], None, experts[:1]
        out = ngp_net.ngp_net(mode, h, None if mode == "density" else xd[:, 3:6], w,
                              experts, tcfg.expert)
    shapes = {"single": [(0, 4)], "linear_blend": [(0, 4)], "density": [(0,)],
              "sigma_blend": [(0,), (0, 3)]}[mode]
    assert [tuple(t.shape) for t in (out if isinstance(out, tuple) else (out,))] == shapes


def _ngp_cfg(**over):
    kw = dict(hidden=64, color_hidden=64, sigma_depth=2, color_depth=2,
              hash=HashGridConfig(levels=8, features_per_level=4, layout="cell"))
    kw.update(over)
    return NGPConfig(**kw)


# the refusals of the kernel's first versions that no longer stand: every
# width, depth, L·F, frequency band count and expert count from 1 is taken
TAKEN_NOW = {"hidden 129", "color_depth 5", "L·F 68", "freq_pe_dim 8", "17 experts"}


@pytest.mark.parametrize("over,K,word", [
    (dict(hidden=129), 1, "hidden 129"),
    (dict(color_hidden=0), 1, "color_hidden 0"),
    (dict(sigma_depth=0), 1, "sigma_depth 0"),
    (dict(color_depth=5), 1, "color_depth 5"),
    (dict(hash=HashGridConfig(levels=17, features_per_level=4)), 1, "L·F 68"),
    (dict(geo_feat_dim=16), 1, "geo_feat_dim 16"),
    (dict(sh_levels=6), 1, "sh_levels 6"),
    (dict(dir_encoding="frequency", freq_pe_dim=8), 1, "freq_pe_dim 8"),
    (dict(dir_encoding="hash"), 1, "dir_encoding 'hash'"),
    ({}, 17, "17 experts"),
])
def test_config_checks_refuse_what_the_kernel_does_not_take(over, K, word):
    """What no parser flag reaches is refused, naming the supported set (a
    width or depth of 0, geo_feat_dim 16, SH levels 6, an unknown
    encoding); what the first versions refused beyond that (``TAKEN_NOW``)
    is taken."""
    if word in TAKEN_NOW:
        ngp_net.check_config(_ngp_cfg(**over), K)
        return
    with pytest.raises(ValueError, match="it takes every width, depth") as e:
        ngp_net.check_config(_ngp_cfg(**over), K)
    assert word in str(e.value)


def test_config_checks_take_the_smoke_and_the_limits():
    for cfg, K in [(_ngp_cfg(), 4), (_ngp_cfg(hidden=128, color_hidden=1, sigma_depth=4,
                                              color_depth=1, sh_levels=5), 16),
                   (_ngp_cfg(dir_encoding="frequency", freq_pe_dim=7,
                             hash=HashGridConfig(levels=32, features_per_level=2)), 1),
                   (_ngp_cfg(hidden=160, color_hidden=160, sigma_depth=5, color_depth=5), 20),
                   (_ngp_cfg(hash=HashGridConfig(levels=32, features_per_level=8)), 3)]:
        ngp_net.check_config(cfg, K)


@pytest.mark.parametrize("name", ["k25", "l16f8", "l40f3", "f1", "wide", "K20", "w160d5",
                                  "lf256", "F1", "F3", "F16", "L37"])
def test_every_parser_config_is_taken_by_the_kernels(name):
    """The configurations of ``toy.FLAG_SETS`` (chip_smoke.py phase 16) and
    of these tests (20 experts, width 160 at depth 5, L·F 256, F = 1, 3, 16,
    37 levels), built from parser flags by ``runner.build_model_configs``
    (which ``toy.flag_config`` matches): neither the network's
    ``check_config`` nor the hash kernels' constants refuse them. Which
    path the network takes: the wide one exactly above 128."""
    from acn_tpu_torch import runner
    from acn_tpu_torch.ops import hashgrid as hg

    flags = {**toy.FLAG_SETS, "K20": {"num_submodules": 20},
             "w160d5": {"dim_hidden": 160, "color_hidden": 160, "sigma_depth": 5,
                        "color_depth": 5},
             "lf256": {"hash_levels": 16, "hash_features": 16},
             "F1": {"hash_features": 1}, "F3": {"hash_features": 3},
             "F16": {"hash_features": 16}, "L37": {"hash_levels": 37}}[name]
    cfg0, P, _ = toy.train_occ_config()
    cfg = toy.flag_config(cfg0, **flags)
    args = dict(num_submodules=4, dim_hidden=64, sigma_depth=2, color_hidden=64,
                color_depth=2, hash_levels=8, hash_features=4, log2_hashmap_size=20,
                max_res=4096, hash_dense_levels=True, nerf_variant="instant",
                dir_encoding="spherical", bm=1.05, no_bg_nerf=False, bg_hidden=32,
                bg_encoding=cfg0.bg_encoding)
    built = runner.build_model_configs(
        types.SimpleNamespace(**{**args, **flags}),
        {"boundary_margin": 1.05, "cluster_2d": True})
    assert built == cfg
    ngp_net.check_config(cfg.expert, cfg.num_submodules)
    for dt in (torch.float32, torch.bfloat16):
        c = hg._consts.__wrapped__(cfg.expert.hash, dt)
        assert c.out_dim == cfg.expert.hash.out_dim
    widths = [cfg.expert.hidden, cfg.expert.color_hidden, cfg.expert.hash.out_dim,
              1 + ngp_net.GEO + cfg.expert.dir_enc_dim]
    assert ngp_net.wide(cfg.expert, "sigma_blend") == (max(widths) > 128)


def _small_container(K):
    """The smoke's container config with K experts at micro widths (its
    tables would take 427 MB at full size)."""
    cfg = toy.train_occ_config()[0]
    e = cfg.expert
    e = dataclasses.replace(e, hidden=8, color_hidden=8, hash=dataclasses.replace(
        e.hash, levels=2, log2_hashmap_size=6, max_res=32))
    return dataclasses.replace(cfg, num_submodules=K, expert=e)


def test_serving_model_keeps_the_quadrants_and_takes_any_expert_count():
    """``toy.serving_model`` at K = 4 gives the bits it gave over
    ``quadrant_layout`` (its weights, boxes and centroids); at K = 25 it
    builds over ``expert_layout``'s 5 × 5 grid, whose boxes cover the scene
    and hold their centroids."""
    cfg = _small_container(4)
    boxes, cents = toy.quadrant_layout(4)
    want = tcont.init_container(cfg, torch.from_numpy(cents), torch.from_numpy(boxes),
                                torch.from_numpy(toy.SCENE_AABB),
                                generator=torch.Generator().manual_seed(3))
    got = toy.serving_model(cfg, seed=3, device="cpu")
    a, b = got.state_dict(), want.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    boxes, cents = toy.expert_layout(25)
    assert boxes.shape == (25, 2, 3) and cents.shape == (25, 3)
    assert (boxes[:, 0] <= cents).all() and (cents <= boxes[:, 1]).all()
    assert (boxes[:, 0] >= -1).all() and (boxes[:, 1] <= 1).all()
    assert sorted(set(boxes[:, 0, 1].round(6))) == sorted(set((boxes[:, 0, 2]).round(6)))
    model = toy.serving_model(_small_container(25), seed=0, device="cpu")
    assert model.expert_aabbs.shape == (25, 2, 3)
    torch.testing.assert_close(model.expert_aabbs, torch.from_numpy(boxes))


def test_kernel_refuses_cpu_tensors_and_unknown_modes():
    cfg = _ngp_cfg(hidden=16, color_hidden=16,
                   hash=HashGridConfig(levels=2, features_per_level=2, log2_hashmap_size=8))
    params = tngp.init_ngp(cfg, generator=torch.Generator().manual_seed(0))
    h = torch.zeros((1, 5, 4))
    with pytest.raises(ValueError, match="CUDA device"):
        ngp_net.ngp_net_kernel("single", h, torch.zeros((5, 3)), None, [params], cfg)
    with pytest.raises(ValueError, match="unknown mode"):
        ngp_net.ngp_net("blend", h, torch.zeros((5, 3)), None, [params], cfg)
    with pytest.raises(ValueError, match="records no gradient"):
        tngp.hash_features(params, cfg, torch.tensor([[-1.0] * 3, [1.0] * 3]),
                           torch.zeros((5, 3)), out=torch.empty((5, 4)))


def _serving_calls(model, tcfg):
    """The serving call sites, each a thunk: (name, mode it reaches)."""
    from acn_tpu_torch.occupancy.grid import OccConfig
    from acn_tpu_torch.pipelines import baking
    from acn_tpu_torch.pipelines.offline_stage import trainer
    from acn_tpu_torch.pipelines.renderer import Renderer
    import types

    occ_cfg = OccConfig(resolution=8, levels=1, alpha_thre=0.0, near_plane=0.0,
                        far_plane=100.0)
    occ = trainer.init_occ_states(model.expert_aabbs, occ_cfg)
    occ["binaries"][:] = True
    rng = np.random.default_rng(1)
    o = np.concatenate([rng.uniform(-0.8, 0.8, (24, 2)), np.full((24, 1), 2.0)], 1)
    d = np.concatenate([rng.uniform(-0.3, 0.3, (24, 2)), -np.ones((24, 1))], 1)
    rays = np.concatenate([o, d / np.linalg.norm(d, axis=1, keepdims=True),
                           np.tile([[0.5, 3.5]], (24, 1))], 1).astype(np.float32)

    def renderer(budget, use_occ=True):
        P = types.SimpleNamespace(ray_samples=16, chunk_points=4096, bg_color_default="white",
                                  occ_s_max=32, occ_s_kept=8, occ_budget_per_ray=budget,
                                  occ_render_s_max=0)
        return Renderer(tcfg, P, occ_cfg if use_occ else None, device="cpu")

    update = trainer.make_occ_update_fn(tcfg, occ_cfg)
    jitter = torch.zeros((tcfg.num_submodules, 1, 8**3, 3))
    return [
        ("budget_frame", "sigma_blend", lambda: renderer(8).render_rays(model, occ, rays)),
        ("budget0_frame", "sigma_blend", lambda: renderer(0).render_rays(model, occ, rays)),
        ("stratified_frame", "linear_blend",
         lambda: renderer(8, use_occ=False).render_rays(model, occ, rays)),
        ("routed_expert", "single",
         lambda: renderer(8).render_rays(model, occ, rays, active_module=1)),
        ("bake", "sigma_blend", lambda: baking.bake_container(
            model, resolution=4, chunk=64, occ_resolution=4)),
        ("occ_update", "density", lambda: update(model, occ, jitter=jitter)),
        ("container_density", "density",
         lambda: tcont.container_density(model, torch.from_numpy(rays[:, :3]))),
    ]


@pytest.mark.parametrize("site", range(7))
def test_serving_call_sites_reach_ngp_net_without_grad_and_the_composition_with(
        site, monkeypatch):
    conf = (16, 16, 2, 2, "spherical", 4, 1.1)
    _, _, tcfg, model = _scene(conf)
    name, mode, call = _serving_calls(model, tcfg)[site]
    seen, composed = [], []
    real_net, real_fwd, real_dens = (ngp_net.ngp_net, ngp_net.features_forward,
                                     ngp_net.features_density)
    monkeypatch.setattr(ngp_net, "ngp_net", lambda m, *a: seen.append(m) or real_net(m, *a))
    monkeypatch.setattr(ngp_net, "features_forward",
                        lambda *a: composed.append(1) or real_fwd(*a))
    monkeypatch.setattr(ngp_net, "features_density",
                        lambda *a, **k: composed.append(1) or real_dens(*a, **k))
    with torch.no_grad():
        call()
    assert seen and set(seen) == {mode}, (name, seen)
    # the plain version runs inside ngp_net on the CPU; nothing composes
    # outside it
    assert len(composed) > 0
    seen.clear()
    # under autograd: the composition, never ngp_net
    xd = torch.from_numpy(_xd(40))
    with torch.enable_grad():
        tcont.container_forward(model, xd).sum().backward()
        trocc._soft_moe_eval(model, xd)[0].sum().backward()
        tcont.container_density(model, xd[:, :3]).sum().backward()
        tngp.ngp_density(model.expert(0), tcfg.expert, model.expert_aabbs[0], xd[:, :3])
    assert seen == []
    # bf16 under no_grad (a training step's AMP) keeps the composition too
    p16 = tnn.tree_cast(model.expert(1), torch.bfloat16)
    with torch.no_grad():
        tngp.ngp_forward(p16, tcfg.expert, model.expert_aabbs[1], xd.to(torch.bfloat16))
    assert seen == []


# ================================================================ card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _net_inputs(cfg, K, P, seed, dev, sigma_shift=0.0, margin=1.1, gain=1.0,
                feature_scale=1.0):
    """K experts' layer weights (torch's Linear init, then ×``gain``),
    hash features N(0, ``feature_scale``²), directions with zero rows,
    routing weights of random points (one-hot at margin 1): all on
    ``dev``."""
    gen = torch.Generator().manual_seed(seed)
    experts = []
    for _ in range(K):
        p = {"sigma_trunk": tnn.init_mlp([cfg.hash.out_dim] + [cfg.hidden] * cfg.sigma_depth,
                                         generator=gen),
             "sigma_head": tnn.init_linear(cfg.hidden, 1, generator=gen),
             "geo_head": tnn.init_linear(cfg.hidden, cfg.geo_feat_dim, generator=gen),
             "color_mlp": tnn.init_mlp([cfg.geo_feat_dim + cfg.dir_enc_dim]
                                       + [cfg.color_hidden] * cfg.color_depth + [3],
                                       generator=gen)}
        p["sigma_head"]["b"] = p["sigma_head"]["b"] - 1.0 + sigma_shift
        experts.append(tnn.tree_map(lambda t: (t * gain).to(dev), p))
    rng = np.random.default_rng(seed)
    L = cfg.hash.out_dim
    h = torch.from_numpy((feature_scale * rng.normal(size=(K, P, L))).astype(np.float32)).to(dev)
    d = torch.from_numpy(rng.normal(size=(P, 6)).astype(np.float32)).to(dev)
    d[::7, 3:6] = 0.0
    cents = torch.from_numpy(rng.uniform(-1, 1, (K, 3)).astype(np.float32)).to(dev)
    pts = torch.from_numpy(rng.uniform(-1, 1, (P, 3)).astype(np.float32)).to(dev)
    w = tcont.routing_weights(cents, pts, True, margin)
    return experts, h, d[:, 3:6], w


def _close(got, want, rtol=RTOL):
    for g, t in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.shape == t.shape
        torch.testing.assert_close(g, t, rtol=rtol, atol=ATOL)


def _run_modes(cfg, K, P, seed, rtol=RTOL, **kw):
    dev = _card()
    experts, h, d, w = _net_inputs(cfg, K, P, seed, dev, **kw)
    before = ngp_net.launch_counts()
    calls = [("single", h[:1], d, None, experts[:1]),
             ("density", h[:1], None, None, experts[:1]),
             ("sigma_blend", h, d, w, experts), ("linear_blend", h, d, w, experts),
             ("density", h, None, w, experts)]
    for mode, hh, dd, ww, ee in calls:
        got = ngp_net.ngp_net_kernel(mode, hh, dd, ww, ee, cfg)
        torch.cuda.synchronize()
        _close(got, ngp_net.ngp_net_plain(mode, hh, dd, ww, ee, cfg), rtol)
    assert ngp_net.launch_counts() - before == (len(calls) if P else 0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("P", [0, 1, 31, 33, 32_768])
@pytest.mark.parametrize("conf", CONFIGS, ids=lambda c: "-".join(map(str, c)))
def test_kernel_matches_plain_on_card(conf, P):
    hidden, ch, sd, cd, enc, lv, margin = conf
    kw = dict(sh_levels=lv) if enc == "spherical" else dict(freq_pe_dim=lv)
    cfg = _ngp_cfg(hidden=hidden, color_hidden=ch, sigma_depth=sd, color_depth=cd,
                   dir_encoding=enc, hash=HashGridConfig(levels=4, features_per_level=2), **kw)
    _run_modes(cfg, 4, P, seed=P + hidden, margin=margin)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("P", [32_768, 983_040])
def test_kernel_matches_plain_at_the_smoke_width_on_card(P):
    _run_modes(_ngp_cfg(), 4, P, seed=1)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shift", [-200.0, 200.0])
def test_kernel_matches_plain_past_the_trunc_exp_clamp_on_card(shift):
    _run_modes(_ngp_cfg(), 4, 4_099, seed=2, sigma_shift=shift, margin=1.0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("width", [96, 128])
def test_kernel_matches_plain_at_the_widest_class_on_card(width):
    _run_modes(_ngp_cfg(hidden=width, color_hidden=width - 32, sigma_depth=4, color_depth=4),
               3, 1_000, seed=4)


@pytest.mark.requires_cuda
def test_kernel_reads_strided_directions_and_raises_on_bad_input_on_card():
    dev = _card()
    cfg = _ngp_cfg()
    experts, h, d, w = _net_inputs(cfg, 2, 100, 5, dev)
    with pytest.raises(ValueError, match="contiguous float32"):
        ngp_net.ngp_net_kernel("sigma_blend", h, d, w.t().contiguous().t(), experts, cfg)
    with pytest.raises(ValueError, match="features"):
        ngp_net.ngp_net_kernel("single", h[:1].double(), d, None, experts[:1], cfg)
    with pytest.raises(ValueError, match="NGP network kernel does not take"):
        ngp_net.ngp_net_kernel("single", h[:1], d, None, experts[:1],
                               dataclasses.replace(cfg, geo_feat_dim=16))
    assert d.stride(0) == 6  # a view of (P, 6) rows
    _close(ngp_net.ngp_net_kernel("single", h[:1], d, None, experts[:1], cfg),
            ngp_net.ngp_net_plain("single", h[:1], d.contiguous(), None, experts[:1], cfg))


# the point lists: which points each expert runs, slab edges, bits


def _blend_calls(h, d, w, experts):
    return [("sigma_blend", h, d, w, experts), ("linear_blend", h, d, w, experts),
            ("density", h, None, w, experts)]


@pytest.mark.requires_cuda
def test_kernel_skips_an_expert_with_no_point_on_card():
    """Expert 1's weight is 0 at every point of the call: its list is empty
    in every slab."""
    dev = _card()
    cfg = _ngp_cfg()
    experts, h, d, w = _net_inputs(cfg, 4, 5_000, 6, dev)
    w = w.clone()
    w[:, 1] = 0.0
    for mode, hh, dd, ww, ee in _blend_calls(h, d, w, experts):
        _close(ngp_net.ngp_net_kernel(mode, hh, dd, ww, ee, cfg),
               ngp_net.ngp_net_plain(mode, hh, dd, ww, ee, cfg))


@pytest.mark.requires_cuda
def test_kernel_takes_one_hot_weights_in_random_order_on_card():
    """Each point's weight one-hot on a random expert (margin 1.0), the
    points in random order: every list is a random quarter of the slab."""
    dev = _card()
    cfg = _ngp_cfg()
    P, K = 20_000, 4
    experts, h, d, _ = _net_inputs(cfg, K, P, 7, dev)
    pick = torch.from_numpy(np.random.default_rng(7).integers(0, K, P)).to(dev)
    w = torch.nn.functional.one_hot(pick, K).to(torch.float32).contiguous()
    for mode, hh, dd, ww, ee in _blend_calls(h, d, w, experts):
        _close(ngp_net.ngp_net_kernel(mode, hh, dd, ww, ee, cfg),
               ngp_net.ngp_net_plain(mode, hh, dd, ww, ee, cfg))


SLAB_MAX, SLAB_MIN = 1024, 256  # kSlabMax, kSlabMin of csrc/ngp_net.cu
WIDE_SLAB_MAX, WIDE_SLAB_MIN = 4096, 128  # kWideSlabMax, kWideSlabMin
WIDE_STAGES, STAGE_FLOATS = 3, 4 * 2 * 512  # kWideStages, kStageFloats


def _width_class(cfg, mode):
    """csrc/ngp_net.cu's ``width_class``: 64 or 128 where every width the
    network carries fits, else 0 (the wide path)."""
    widths = [cfg.hidden, cfg.hash.out_dim]
    if mode != "density":
        widths += [cfg.color_hidden, 1 + ngp_net.GEO + cfg.dir_enc_dim]
    return 64 if max(widths) <= 64 else 128 if max(widths) <= 128 else 0


def _shapes(cfg, mode, W):
    """``layer_shapes``: (kt, nt) of each staged layer at width class W."""
    tiles = lambda n: (n + 7) // 8
    hid = W // 8 if W else tiles(cfg.hidden)
    col = W // 8 if W else tiles(cfg.color_hidden)
    shapes = [(tiles(cfg.hash.out_dim if l == 0 else cfg.hidden), hid)
              for l in range(cfg.sigma_depth)] + [(tiles(cfg.hidden), tiles(1 + ngp_net.GEO))]
    if mode != "density":
        shapes += ([(tiles(1 + ngp_net.GEO + cfg.dir_enc_dim), col)]
                   + [(tiles(cfg.color_hidden), col)] * (cfg.color_depth - 1)
                   + [(tiles(cfg.color_hidden), 1)])
    return shapes


def _wide_plan(cfg, mode, smem):
    """csrc/ngp_net.cu's ``wide_plan`` before the call's own size: (the
    full slab, whether the activations stay on chip). Shared memory holds
    the layers' shapes and the ring's barriers, the ring, the two tiles'
    activations (on chip where every layer is at most 4 blocks of 64 wide
    and a slab of ``WIDE_SLAB_MIN`` fits beside them), the two tiles'
    direction encodings, then the slab."""
    tiles = lambda n: (n + 7) // 8
    shapes, _ = ngp_net.wide_shapes(mode, cfg)
    kw = max(max(kt, 8 * nb) for _, _, kt, nb, _, _ in shapes)
    fits = all(nb <= ngp_net.ROUND_BLOCKS for _, _, _, nb, _, _ in shapes)
    es = 0 if mode == "density" else 8 * tiles(1 + ngp_net.GEO + cfg.dir_enc_dim) - 16 + 2
    per_point = 4 * 4 + 3  # the accumulators, the list, the ballots
    ring_off = (4 * len(shapes) + 4 * WIDE_STAGES + 31) // 32 * 32
    act_off, act = ring_off + WIDE_STAGES * STAGE_FLOATS, 2 * 4 * kw * 32 * 4
    enc = 2 * 64 * es  # a tile's direction encodings, each warpgroup's

    def beside(front):
        if 4 * front + 32 * per_point > smem:
            return 0
        return min((smem - 4 * front) // per_point // 32 * 32, WIDE_SLAB_MAX)

    onchip = fits and beside(act_off + act + enc) >= WIDE_SLAB_MIN
    return beside(act_off + (act if onchip else 0) + enc), onchip


def _slab(cfg, mode, P, smem, sms):
    """The points a slab that ``plan()`` in csrc/ngp_net.cu takes for this
    net, mode and P on a card of ``smem`` bytes of shared memory a block and
    ``sms`` SMs: in a width class the layers' shapes, the expert's pointer
    table and the weights' staged images (f32 landing and split), on the
    wide path ``_wide_plan``'s, then as many points as
    fit beside them, fewer where the call has less than a full slab an SM.
    Its arithmetic, step for step."""
    tiles = lambda n: (n + 7) // 8
    W = _width_class(cfg, mode)
    shapes = _shapes(cfg, mode, W)
    land = [8 * kt * (8 * n + 4) + 8 * n for kt, n in shapes]
    split = [128 * kt * n + 8 * n for kt, n in shapes]
    enc = 0 if mode == "density" else 8 * tiles(1 + ngp_net.GEO + cfg.dir_enc_dim) - 16 + 2
    per_point = 4 * (enc + 4) + 3
    # the shapes, then the staged expert's (w, b) pointers (16 bytes a slot)
    shape_floats = (5 * len(shapes) + 3) // 4 * 4 + 4 * (cfg.sigma_depth + cfg.color_depth + 3)

    def beside(floats):
        wbytes = 4 * (floats + shape_floats)
        if wbytes + 32 * per_point > smem:
            return 0
        return min((smem - wbytes) // per_point // 32 * 32, SLAB_MAX)

    if W == 0:
        S = _wide_plan(cfg, mode, smem)[0]
        if S:  # whole rounds of slabs over one block an SM
            rounds = -(-P // (S * sms))
            S = min(S, (-(-P // (rounds * sms)) + 31) // 32 * 32)
    else:
        S = beside(sum(land) + sum(split))
        if S < SLAB_MIN and beside(max(land) + max(split)) > S:
            S = beside(max(land) + max(split))
    fill = (-(-P // sms) + 31) // 32 * 32
    return min(S, max(SLAB_MIN, fill))


def test_slab_plan_at_the_smoke_width():
    """``_slab`` gives the slabs PERF.md reports for the smoke's net on an
    H100 (227 KB of shared memory a block, 132 SMs): 640 points where the
    direction encoding is kept, 1,024 in density, 256 for a support march,
    and between those, a slab an SM."""
    cfg, smem, sms = _ngp_cfg(), 232_448, 132
    assert [_slab(cfg, m, 983_040, smem, sms) for m in ("single", "sigma_blend", "density")] \
        == [640, 640, 1024]
    assert [_slab(cfg, m, P, smem, sms) for m in ("single", "density")
            for P in (1, 32_768, 84_480, 84_481)] == [256, 256, 640, 640, 256, 256, 640, 672]


def _edge_calls(cfg, edge, seed):
    """For each of ``_run_modes``' five calls, P on the named edge of the
    slab the card plans for that call's mode, and its inputs."""
    dev = _card()
    props = torch.cuda.get_device_properties(dev)
    smem, sms = props.shared_memory_per_block_optin, props.multi_processor_count
    for mode, blend in (("single", False), ("density", False), ("sigma_blend", True),
                        ("linear_blend", True), ("density", True)):
        full = _slab(cfg, mode, 1 << 40, smem, sms)
        P = {"1": 1, "15": 15, "17": 17, "min_slab+1": SLAB_MIN + 1,
             "full_slabs+1": full * sms + 1, "twice_full_slabs+1": 2 * full * sms + 1}[edge]
        want = {"min_slab+1": SLAB_MIN, "full_slabs+1": full, "twice_full_slabs+1": full}
        if edge in want:
            assert _slab(cfg, mode, P, smem, sms) == want[edge], (mode, edge)
        experts, h, d, w = _net_inputs(cfg, 4 if blend else 1, P, seed, dev, margin=1.05)
        yield (mode, h, None if mode == "density" else d, w if blend else None, experts)


EDGES = ["1", "15", "17", "min_slab+1", "full_slabs+1", "twice_full_slabs+1"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("edge", EDGES)
def test_kernel_matches_plain_at_tile_and_slab_edges_on_card(edge):
    """A partial tile (1, 15, 17 points), and one point past a whole number
    of slabs, each call at its own mode's slab as ``plan()`` sizes it: two
    slabs of the least size (the second of one point), a full slab on every
    SM and one more point, and twice that (blocks take several slabs). The
    encoding modes and density plan different slabs (640 and 1,024 points
    at the smoke's width on an H100)."""
    cfg = _ngp_cfg()
    for mode, hh, dd, ww, ee in _edge_calls(cfg, edge, seed=8 + EDGES.index(edge)):
        got = ngp_net.ngp_net_kernel(mode, hh, dd, ww, ee, cfg)
        _close(got, ngp_net.ngp_net_plain(mode, hh, dd, ww, ee, cfg))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("width", [96, 128])
def test_kernel_matches_plain_at_the_widest_class_with_frequency_on_card(width):
    """Widths 96 and 128 at depth 4 (their layers stream through two slots)
    with the frequency encoding of 7 bands (the widest colour input, 15 + 45)
    over several slabs."""
    _run_modes(_ngp_cfg(hidden=width, color_hidden=width, sigma_depth=4, color_depth=4,
                        dir_encoding="frequency", freq_pe_dim=7), 3, 2_500, seed=9)


@pytest.mark.requires_cuda
def test_kernel_is_deterministic_on_card():
    """Two launches on the same inputs give the same bits (the experts add
    in order into per-point sums: no atomics)."""
    dev = _card()
    cfg = _ngp_cfg()
    experts, h, d, w = _net_inputs(cfg, 4, 50_000, 10, dev)
    for mode, hh, dd, ww, ee in _blend_calls(h, d, w, experts) + [
            ("single", h[:1], d, None, experts[:1])]:
        a = ngp_net.ngp_net_kernel(mode, hh, dd, ww, ee, cfg)
        b = ngp_net.ngp_net_kernel(mode, hh, dd, ww, ee, cfg)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y), mode


# every expert configuration: more experts, wider and deeper networks, wider
# inputs; the wide path (above 128) at its tile, pass and slab edges


def _wider_card_cfg(name):
    """(expert config, K, rtol) of a card case: 20 and 25 experts, depth 6
    at 128 (the class streams it), L·F 128 (the 128 class by its input), and
    on the wide path width 160 at depth 5, L·F 256, 20 frequency bands (a
    colour input of 139) and the ``wide`` expert at its own tolerance."""
    return {
        "K20": (_ngp_cfg(), 20, RTOL),
        "K25": (_ngp_cfg(hidden=32, color_hidden=32), 25, RTOL),
        "depth6_128": (_ngp_cfg(hidden=128, color_hidden=96, sigma_depth=6, color_depth=6), 3,
                       RTOL),
        "lf128": (_ngp_cfg(hash=HashGridConfig(levels=16, features_per_level=8)), 4, RTOL),
        "w160d5": (_ngp_cfg(hidden=160, color_hidden=160, sigma_depth=5, color_depth=5), 4,
                   RTOL),
        "lf256": (_ngp_cfg(hash=HashGridConfig(levels=16, features_per_level=16)), 3, RTOL),
        "freq20": (_ngp_cfg(dir_encoding="frequency", freq_pe_dim=20), 2, RTOL),
        "wide": (_wide_cfg(), 4, WIDE_RTOL),
    }[name]


WIDER_CARD = ["K20", "K25", "depth6_128", "lf128", "w160d5", "lf256", "freq20", "wide"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("P", [1, 1_000, 70_000])
@pytest.mark.parametrize("name", WIDER_CARD)
def test_kernel_matches_plain_at_every_expert_configuration_on_card(name, P):
    cfg, K, rtol = _wider_card_cfg(name)
    _run_modes(cfg, K, P, seed=P + K, rtol=rtol)


@pytest.mark.requires_cuda
def test_wide_kernel_matches_plain_where_float32_drifts_on_card():
    """The ``wide`` expert with the weights and features of
    ``test_wide_tolerance_from_the_emulation_against_float64`` (σ in the
    tens of its exponent), within ``WIDE_RTOL``."""
    _run_modes(_wide_cfg(), 4, 5_000, seed=16, rtol=WIDE_RTOL, gain=2.45, feature_scale=10.0)


WIDE_EDGES = ["1", "15", "17", "pass+1", "min_slab+1", "full_slabs+1"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("edge", WIDE_EDGES)
def test_wide_path_at_tile_pass_and_slab_edges_on_card(edge):
    """The wide path (width 160) at a partial tile, one point past a pass of
    two 64-point tiles (128 points), two slabs of the least size, and one
    point past a full slab on every SM, each mode at its own slab as
    ``plan()`` sizes it."""
    dev = _card()
    cfg = _ngp_cfg(hidden=160, color_hidden=136, sigma_depth=3, color_depth=3)
    props = torch.cuda.get_device_properties(dev)
    smem, sms = props.shared_memory_per_block_optin, props.multi_processor_count
    for mode, blend in (("single", False), ("density", False), ("sigma_blend", True),
                        ("linear_blend", True), ("density", True)):
        assert _width_class(cfg, mode) == 0
        full = _slab(cfg, mode, 1 << 40, smem, sms)
        P = {"1": 1, "15": 15, "17": 17, "pass+1": 129, "min_slab+1": SLAB_MIN + 1,
             "full_slabs+1": full * sms + 1}[edge]
        experts, h, d, w = _net_inputs(cfg, 4 if blend else 1, P, 30 + WIDE_EDGES.index(edge),
                                       dev, margin=1.05)
        args = (h, None if mode == "density" else d, w if blend else None, experts)
        _close(ngp_net.ngp_net_kernel(mode, *args, cfg), ngp_net.ngp_net_plain(mode, *args, cfg))


@pytest.mark.requires_cuda
def test_wide_path_is_deterministic_and_sizes_its_scratch_on_card():
    """Two launches of the wide path give the same bits; its device buffer
    is the experts' split images alone where the activations stay on chip
    (no scratch), and nothing in the width classes."""
    dev = _card()
    cfg = _ngp_cfg(hidden=256, color_hidden=128, sigma_depth=3, color_depth=2)
    experts, h, d, w = _net_inputs(cfg, 4, 50_000, 40, dev)
    assert _wide_plan(cfg, "sigma_blend", 232_448)[1]
    assert ngp_net.wide_bytes("sigma_blend", cfg, 4, 50_000) \
        == 4 * 4 * ngp_net.wide_shapes("sigma_blend", cfg)[1]
    assert ngp_net.wide_bytes("sigma_blend", _ngp_cfg(), 4, 50_000) == 0
    for mode, hh, dd, ww, ee in _blend_calls(h, d, w, experts) + [
            ("single", h[:1], d, None, experts[:1])]:
        a = ngp_net.ngp_net_kernel(mode, hh, dd, ww, ee, cfg)
        b = ngp_net.ngp_net_kernel(mode, hh, dd, ww, ee, cfg)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y), mode


# the wide path's design: the weights split once a call into the layout
# wgmma reads, 64-point tiles two a pass, activations on chip up to 256
# wide and spilled above


def _read_as_the_kernel_does(img: torch.Tensor, shape: tuple) -> tuple:
    """A layer's (big, small) weights (8 kt rows, 64 nb columns) read back
    from an expert's split image the way the wide kernel reads them, written
    independently of ``wide_split_plain``: the producer copies, for each
    round of up to 4 blocks and each k-step j, 2 × 512 × its blocks floats
    from off + 1024 (kt·4·round + j·blocks); a warpgroup's wgmma reads
    block b's big part at b × 512 floats of the stage and its small part at
    (blocks + b) × 512, K-major without swizzle (element (k-slot s, column
    n) at (n / 8)·64 + (s / 4)·32 + (n % 8)·4 + s % 4, the layout the
    card's probe of m64n64k8 confirmed); its A fragment puts input row
    8j + 2t in k-slot t and 8j + 2t + 1 in k-slot t + 4."""
    _, _, kt, nb, off, _ = shape
    big = torch.zeros((8 * kt, 64 * nb))
    small = torch.zeros_like(big)
    for r in range(-(-nb // 4)):
        nbr = min(4, nb - 4 * r)
        for j in range(kt):
            stage = img[off + 1024 * (kt * 4 * r + j * nbr):][:1024 * nbr]
            for b in range(nbr):
                for part, base in ((big, b * 512), (small, (nbr + b) * 512)):
                    for slot in range(8):
                        row = 8 * j + (2 * slot if slot < 4 else 2 * (slot - 4) + 1)
                        n = torch.arange(64)
                        at = base + (n // 8) * 64 + (slot // 4) * 32 + (n % 8) * 4 + slot % 4
                        part[row, 64 * (4 * r + b) + n] = stage[at]
    return big, small


@pytest.mark.parametrize("name", ["wide", "w264d1", "w136d2"])
def test_wide_split_plain_is_the_layout_the_kernel_reads(name):
    """``wide_split_plain``'s image, read back as the kernel reads it
    (``_read_as_the_kernel_does``), is each staged layer split into its
    TF32 parts (σ and geo side by side, the colour input behind a zero row),
    zeros past its rows and columns, and the biases after the layers; its
    size is the C side's ``wide_shapes``."""
    cfg = {"wide": _wide_cfg(),
           "w264d1": _ngp_cfg(hidden=264, color_hidden=264, sigma_depth=1, color_depth=1),
           "w136d2": _ngp_cfg(hidden=136, color_hidden=72, sigma_depth=2, color_depth=2,
                              dir_encoding="frequency", freq_pe_dim=3)}[name]
    experts = _net_inputs(cfg, 2, 4, 3, "cpu")[0]
    for mode in ("sigma_blend", "density"):
        shapes, floats = ngp_net.wide_shapes(mode, cfg)
        img = ngp_net.wide_split_plain(mode, experts, cfg)
        assert img.shape == (2, floats)
        for k, e in enumerate(experts):
            staged = ngp_net._staged(e, cfg, mode)
            assert len(staged) == len(shapes)
            for shape, (wt, bt) in zip(shapes, staged):
                n_in, n_out, kt, nb, _, boff = shape
                full = torch.zeros((8 * kt, 64 * nb))
                full[:n_in, :n_out] = wt
                big, small = _read_as_the_kernel_does(img[k], shape)
                assert torch.equal(big, _tf32(full)) and torch.equal(small, _tf32(full - big))
                assert torch.equal(img[k, boff:boff + 64 * nb][:n_out], bt)
                assert not img[k, boff + n_out:boff + 64 * nb].any()
        heads = ngp_net._staged(experts[0], cfg, mode)[cfg.sigma_depth]
        assert torch.equal(heads[0][:, 0], experts[0]["sigma_head"]["w"][:, 0])
        if mode != "density":
            first = ngp_net._staged(experts[0], cfg, mode)[cfg.sigma_depth + 1][0]
            assert not first[0].any() and torch.equal(first[1:], experts[0]["color_mlp"][0]["w"])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", ["sigma_blend", "density"])
@pytest.mark.parametrize("name", ["wide", "w264d1", "w136d2"])
def test_wide_split_kernel_matches_plain_bits_on_card(name, mode):
    """The split kernel writes ``wide_split_plain``'s bits (cvt.rna.tf32 is
    ``tf32_plain``), counted once a launch."""
    dev = _card()
    cfg = {"wide": _wide_cfg(),
           "w264d1": _ngp_cfg(hidden=264, color_hidden=264, sigma_depth=1, color_depth=1),
           "w136d2": _ngp_cfg(hidden=136, color_hidden=72, sigma_depth=2, color_depth=2,
                              dir_encoding="frequency", freq_pe_dim=3)}[name]
    experts = _net_inputs(cfg, 3, 4, 5, dev)[0]
    before = ngp_net.split_launch_counts()
    got = ngp_net.wide_split_kernel(mode, experts, cfg)
    torch.cuda.synchronize()
    assert ngp_net.split_launch_counts() == before + 1
    want = ngp_net.wide_split_plain(mode, experts, cfg)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("P", [63, 64, 65, 127, 129, 64 * 7 - 1, 64 * 7 + 1])
def test_wide_path_at_wgmma_tile_edges_on_card(P):
    """The ``wide`` expert at point counts on each side of a 64-point tile
    and of a pass (two tiles): every mode against the plain version, each
    call one network and one split launch."""
    _card()
    before = ngp_net.split_launch_counts()
    _run_modes(_wide_cfg(), 4, P, seed=50 + P, rtol=WIDE_RTOL)
    assert ngp_net.split_launch_counts() - before == 5


@pytest.mark.requires_cuda
@pytest.mark.parametrize("listed", [0, 1])
def test_wide_path_with_an_expert_of_no_or_one_point_on_card(listed):
    """Expert 2's weight is 0 at every point but ``listed`` of them: its
    list is empty, or one point (a tile of one row)."""
    dev = _card()
    cfg = _wide_cfg()
    experts, h, d, w = _net_inputs(cfg, 4, 3_000, 60 + listed, dev)
    w = w.clone()
    w[:, 2] = 0.0
    if listed:
        w[1_234, 2] = 0.5
    for mode, hh, dd, ww, ee in _blend_calls(h, d, w, experts):
        _close(ngp_net.ngp_net_kernel(mode, hh, dd, ww, ee, cfg),
               ngp_net.ngp_net_plain(mode, hh, dd, ww, ee, cfg), WIDE_RTOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("depth", [1, 8])
@pytest.mark.parametrize("width", [136, 192, 256, 264])
def test_wide_path_at_widths_and_depths_on_card(width, depth):
    """Widths 136, 192 and 256 (activations on chip: 3 and 4 blocks of 64)
    and 264 (5 blocks: two rounds of columns, the activations spilled to the
    block's scratch) at depths 1 and 8, every mode."""
    _card()
    cfg = _ngp_cfg(hidden=width, color_hidden=width, sigma_depth=depth, color_depth=depth)
    assert _wide_plan(cfg, "sigma_blend", 232_448)[1] == (width <= 256)
    assert (ngp_net.wide_bytes("sigma_blend", cfg, 3, 2_000)
            > 4 * 3 * ngp_net.wide_shapes("sigma_blend", cfg)[1]) == (width > 256)
    _run_modes(cfg, 3, 2_000, seed=70 + width + depth, rtol=WIDE_RTOL)


@pytest.mark.requires_cuda
def test_wide_path_sees_a_weight_updated_in_place_on_card():
    """A TTO step or a viewer publish updates weights in place (same
    tensors, same device table): the next call splits them again and
    matches the plain version on the new weights."""
    dev = _card()
    cfg = _wide_cfg()
    experts, h, d, w = _net_inputs(cfg, 4, 2_000, 80, dev)
    first = ngp_net.ngp_net_kernel("sigma_blend", h, d, w, experts, cfg)
    with torch.no_grad():
        for e in experts:
            e["sigma_trunk"][3]["w"].mul_(1.5)
            e["color_mlp"][1]["b"].add_(0.25)
    again = ngp_net.ngp_net_kernel("sigma_blend", h, d, w, experts, cfg)
    torch.cuda.synchronize()
    assert not torch.equal(first[0], again[0])
    _close(again, ngp_net.ngp_net_plain("sigma_blend", h, d, w, experts, cfg), WIDE_RTOL)
