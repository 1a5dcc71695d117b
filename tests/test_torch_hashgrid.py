"""The port's cell-layout hash encode (acn_tpu_torch.ops.hashgrid): its plain
forward and table cotangent against acn_tpu's ``_hash_encode_cell_saved``
and its ``jax.vjp``; ``HashCellBwdTables`` as a function with a gradient;
the CUDA kernels against the plain versions on the card (``requires_cuda``).

The same numpy inputs, made from a seed, go through both packages at micro
shapes (4 levels, 2^12 rows, a few hundred points), x01 and tables in
float32 or bfloat16, every interpolation, dense levels on and off, with
points on cell faces of every level and at 1 − 1e-6 (1.0 in bfloat16: the
cell ``res``, clipped on a dense level, hashed on the others). JAX runs op by
op (no ``jit``), so its roundings are its ops' own. Tolerances:

* the cell index h and the raw fraction: bit-equal, in both types;
* float32 forward, tables at the init's scale (U(±1e-3)): rtol 1e-6 / atol
  1e-9 (``test_hash_indices_exact_and_features``); float32 table cotangent: atol 1e-6 / rtol 1e-5
  (``test_hash_encode_backward_matches_jax_grad``): the same products,
  summed in another order (JAX's ``einsum``, its scatter);
* bfloat16: the port rounds each weight-row product to bf16 and sums in
  float32 (PyTorch's eager ops), JAX's ``einsum`` sums the exact products
  and rounds once, and both scatters round every add to bf16: each element
  within 4 bf16 ulps (4 · 2^-8) of the sum of its terms' magnitudes, taken
  in float64 by the plain version itself.

On the card (``requires_cuda``): float32 forward within 2e-6 of the output's
largest magnitude, bfloat16 within one bf16 ulp of the plain version's
element; the table cotangent in float32 within rtol 1e-5, in bfloat16
within n · 2^-8 of the sum of its terms' magnitudes from a
float32-accumulated reference, n the most adds into one row (the bound of
any order of n rounded adds, which the plain ``index_add_`` meets too) and,
on 32,768 random points, per level no farther in L2 from that reference than
1.5× the plain ``index_add_`` (both add in an order of their own; two orders
land within a few % of each other at this size); Nearest with
table[r, c·F + f] = 8·r + c exactly (h and the corner); the double backward
against the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.models import encodings as jenc
from acn_tpu.models.encodings import HashGridConfig as JHashGridConfig
from acn_tpu_torch.models import encodings as tenc
from acn_tpu_torch.ops import cuda_lib
from acn_tpu_torch.ops import hashgrid as hg

BF16_EPS = 2.0**-8
# (x01, tables, F): the three kernel widths, and the mixed case
TYPES = [("float32", "float32", 2), ("bfloat16", "bfloat16", 4),
         ("float32", "bfloat16", 8)]
INTERPOLATIONS = ["Linear", "Smoothstep", "Nearest"]


@pytest.fixture(autouse=True)
def one_thread():
    """Micro shapes gain nothing from torch's threads, and under several
    workers their threads wait on each other's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_kw(F=2, interpolation="Linear", dense=True):
    # resolutions 16, 101, 645, 4095 (4096 in bf16); level 0 dense when on
    return dict(levels=4, min_res=16, max_res=4096, log2_hashmap_size=12,
                features_per_level=F, layout="cell", dense_levels=dense,
                interpolation=interpolation)


def _points(cfg, n=320, seed=0):
    """Random points, cell faces k/res of every level and k/64, the clamp
    ends: where floor and the fraction could round apart."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 3)).astype(np.float32)
    res = cfg.level_resolutions()
    for i, r in enumerate(res):
        x[32 * i:32 * (i + 1)] = (rng.integers(0, r + 1, (32, 3)) / r).astype(np.float32)
    x[128:160] = (rng.integers(0, 65, (32, 3)) / 64.0).astype(np.float32)
    x[160:176] = np.float32(1 - 1e-6)
    x[176:184] = np.float32(1e-6)
    x[184:192, 0] = np.float32(1 - 1e-6)  # one axis at the end
    return x


def _tables(cfg, seed=1):
    """U(−1e-3, 1e-3), ``init_hash_table``'s scale (``hash_init_scale``),
    which atol 1e-9 was set for: a few float32 ulps of the terms."""
    rng = np.random.default_rng(seed)
    return [(1e-3 * rng.uniform(-1.0, 1.0, size=(cfg.level_rows(l), 8 * cfg.features_per_level)))
            .astype(np.float32) for l in range(cfg.levels)]


def _both(xt, tt, F, interpolation, dense, seed=0):
    kw = _cfg_kw(F, interpolation, dense)
    cfg_t, cfg_j = tenc.HashGridConfig(**kw), JHashGridConfig(**kw)
    x = _points(cfg_t, seed=seed)
    tabs = _tables(cfg_t, seed=seed + 1)
    g = np.random.default_rng(seed + 2).normal(
        size=(len(x), cfg_t.out_dim)).astype(np.float32)
    g[::5] = 0.0  # zero cotangents, as the budget pack's pad slots carry
    torch_x = torch.from_numpy(x).to(getattr(torch, xt))
    torch_t = [torch.from_numpy(t).to(getattr(torch, tt)) for t in tabs]
    jax_x = jnp.asarray(x).astype(getattr(jnp, xt))
    jax_t = [jnp.asarray(t).astype(getattr(jnp, tt)) for t in tabs]
    return cfg_t, cfg_j, (torch_x, torch_t, torch.from_numpy(g).to(getattr(torch, tt))), \
        (jax_x, jax_t, jnp.asarray(g).astype(getattr(jnp, tt)))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


def _magnitudes(cfg, x, tables, g):
    """The sums of the terms' magnitudes, in float64, by the plain versions:
    Σ_c |w_c · row_c| per output, Σ |w_c · g| per cotangent entry."""
    a = [t.to(torch.float64).abs() for t in tables]
    fwd = hg.hash_cell_fwd_plain(a, x, cfg)
    bwd = hg.hash_cell_bwd_tables_plain(x, g.to(torch.float64).abs(), cfg,
                                        [t.shape[0] for t in tables],
                                        [torch.float64] * cfg.levels)
    return fwd.numpy(), [b.numpy() for b in bwd]


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
@pytest.mark.parametrize("xt,tt,F", TYPES)
def test_plain_matches_jax_saved_forward_and_vjp(xt, tt, F, interpolation, dense):
    cfg_t, cfg_j, (x, tabs, g), (jx, jtabs, jg) = _both(xt, tt, F, interpolation, dense)
    for l in range(cfg_t.levels):  # the cell decisions: bit-equal
        h_t, frac_t = hg._cell_index(x, cfg_t, l)
        _, h_j, frac_j = jenc._cell_level_lookup(jtabs, jx, cfg_j, l)
        np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j), err_msg=f"h {l}")
        np.testing.assert_array_equal(_f32(frac_t), _f32(frac_j), err_msg=f"frac {l}")
    nrows = tuple(int(t.shape[0]) for t in tabs)
    want, vjp = jax.vjp(lambda t: jenc._hash_encode_cell_saved(t, jx, cfg_j, nrows),
                        jtabs)
    (want_t,) = vjp(jg)
    got = hg.hash_cell_fwd_plain(tabs, x, cfg_t)
    got_t = hg.hash_cell_bwd_tables_plain(x, g, cfg_t, nrows, [t.dtype for t in tabs])
    assert got.dtype == tabs[0].dtype and got.shape == (x.shape[0], cfg_t.out_dim)
    assert [t.dtype for t in got_t] == [t.dtype for t in tabs]
    if tt == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=1e-9)
        for l, (a, b) in enumerate(zip(got_t, want_t)):
            np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-6, rtol=1e-5,
                                       err_msg=f"level {l}")
        return
    mag_f, mag_t = _magnitudes(cfg_t, x, tabs, g)
    assert np.all(np.abs(_f32(got) - _f32(want)) <= 4 * BF16_EPS * mag_f + 1e-30)
    for l, (a, b) in enumerate(zip(got_t, want_t)):
        assert a.shape == b.shape
        assert np.all(np.abs(_f32(a) - _f32(b)) <= 4 * BF16_EPS * mag_t[l] + 1e-30), l


def test_the_encode_on_the_cpu_is_the_plain_version():
    """``_HashEncodeCellSaved`` on CPU tensors: the plain forward, the plain
    table cotangent, no launch counted; only x01 is kept for the backward."""
    cfg_t, _, (x, tabs, g), _ = _both("float32", "float32", 2, "Linear", True)
    tabs = [t.requires_grad_(True) for t in tabs]
    before = hg.launch_counts()
    out = tenc._HashEncodeCellSaved.apply(x, cfg_t, *tabs)
    assert len(out.grad_fn.saved_tensors) == 1
    assert torch.equal(out, hg.hash_cell_fwd_plain(tabs, x, cfg_t))
    got = torch.autograd.grad(out, tabs, g)
    want = hg.hash_cell_bwd_tables_plain(x, g, cfg_t, [t.shape[0] for t in tabs],
                                         [torch.float32] * cfg_t.levels)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert hg.launch_counts() == before


@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
def test_the_cotangents_backward_is_the_forward_on_its_cotangent(interpolation):
    cfg, _, (x, tabs, _), _ = _both("float32", "float32", 2, interpolation, True)
    x = x[:40].double()
    rng = np.random.default_rng(7)
    g = torch.tensor(rng.normal(size=(40, cfg.out_dim)), requires_grad=True)
    nrows = [int(t.shape[0]) for t in tabs]
    outs = hg.HashCellBwdTables.apply(g, x, cfg, nrows, [torch.float64] * cfg.levels)
    gg = [torch.tensor(rng.normal(size=t.shape)) for t in outs]
    (dg,) = torch.autograd.grad(outs, g, gg)
    assert torch.equal(dg, hg.hash_cell_fwd_plain(gg, x, cfg))


@pytest.mark.parametrize("interpolation", ["Linear", "Smoothstep"])
def test_hash_cell_bwd_tables_gradcheck_in_g_and_x(interpolation):
    """float64, in g and in x01 (off the faces: the weights are smooth
    inside a cell), on a 2-level grid of few rows, so that the Jacobian is
    small."""
    kw = dict(levels=2, min_res=3, max_res=5, log2_hashmap_size=4,
              features_per_level=2, layout="cell", dense_levels=False,
              interpolation=interpolation)
    cfg = tenc.HashGridConfig(**kw)
    rng = np.random.default_rng(8)
    x = torch.tensor(0.05 + 0.9 * rng.random((5, 3)), requires_grad=True)
    g = torch.tensor(rng.normal(size=(5, cfg.out_dim)), requires_grad=True)
    nrows = [cfg.level_rows(l) for l in range(cfg.levels)]
    f = lambda gg, xx: hg.HashCellBwdTables.apply(gg, xx, cfg, nrows,
                                                  [torch.float64] * cfg.levels)
    assert torch.autograd.gradcheck(f, (g, x))


def test_kernel_wrappers_refuse_cpu_tensors_and_other_types():
    cfg, _, (x, tabs, g), _ = _both("float32", "float32", 2, "Linear", True)
    with pytest.raises(ValueError, match="CUDA"):
        hg.hash_cell_fwd_kernel(tabs, x, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        hg.hash_cell_bwd_tables_kernel(x, g, cfg, [t.shape[0] for t in tabs],
                                       [torch.float32] * cfg.levels)
    with pytest.raises(TypeError, match="one type"):
        hg.hash_cell_bwd_tables_kernel(x, g.double(), cfg, [t.shape[0] for t in tabs],
                                       [torch.float32] * cfg.levels)


def test_each_source_builds_its_own_library():
    paths = {name: cuda_lib.library_path(source=name) for name in cuda_lib.SOURCES}
    assert set(paths) == {"segscan", "hashgrid"}
    assert paths["segscan"].name.startswith("libsegscan-")
    assert paths["hashgrid"].name.startswith("libhashgrid-")
    assert paths["segscan"] == cuda_lib.library_path()  # the scan's default
    assert cuda_lib.library_path(("SEGSCAN_ITEMS=4",)) != paths["segscan"]


# ------------------------------------------------------------------ the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return "cuda"


def _ulps_apart_bf16(a, b):
    """|a − b| in bf16 ulps of b (elementwise; ulp of the larger binade)."""
    a, b = a.float(), b.float()
    ulp = torch.where(b == 0, torch.full_like(b, 2.0**-133),
                      2.0 ** (torch.floor(torch.log2(b.abs())) - 7))
    return ((a - b).abs() / ulp)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
@pytest.mark.parametrize("xt,tt,F", TYPES)
def test_kernels_match_plain_on_card(xt, tt, F, interpolation):
    dev = _card()
    cfg, _, (x, tabs, g), _ = _both(xt, tt, F, interpolation, True, seed=3)
    xc, tc, gc = x.to(dev), [t.to(dev) for t in tabs], g.to(dev)
    nrows, dtypes = [t.shape[0] for t in tabs], [t.dtype for t in tabs]
    before = hg.launch_counts()
    got = hg.hash_cell_fwd_kernel(tc, xc, cfg)
    got_t = hg.hash_cell_bwd_tables_kernel(xc, gc, cfg, nrows, dtypes)
    torch.cuda.synchronize()
    assert hg.launch_counts() == (before[0] + 1, before[1] + 1)
    want = hg.hash_cell_fwd_plain(tc, xc, cfg)
    want_t = hg.hash_cell_bwd_tables_plain(xc, gc, cfg, nrows, dtypes)
    if tt == "float32":
        assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())
        for a, b in zip(got_t, want_t):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        return
    assert float(_ulps_apart_bf16(got, want).max()) <= 1.0
    # each bf16 add rounds by at most 2^-8 of the magnitudes' sum so far: an
    # element of n adds lies within n · 2^-8 · Σ|terms| of the float32 sum,
    # whatever their order (the plain version is held to the same)
    ref = hg.hash_cell_bwd_tables_plain(xc, gc.float(), cfg, nrows,
                                        [torch.float32] * cfg.levels)
    mag = hg.hash_cell_bwd_tables_plain(xc, gc.float().abs(), cfg, nrows,
                                        [torch.float32] * cfg.levels)
    for l, (a, b, r, m) in enumerate(zip(got_t, want_t, ref, mag)):
        n = int(torch.bincount(hg._cell_index(xc, cfg, l)[0]).max())
        for t in (a, b):
            assert bool(((t.float() - r).abs() <= n * BF16_EPS * m).all()), l


@pytest.mark.requires_cuda
@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
@pytest.mark.parametrize("xt,tt,F", [t for t in TYPES if t[1] == "bfloat16"])
def test_bf16_cotangent_no_farther_from_the_f32_sum_than_plain_on_card(
        xt, tt, F, interpolation):
    dev = _card()
    cfg = tenc.HashGridConfig(**_cfg_kw(F, interpolation, True))
    rng = np.random.default_rng(6)
    P = 32_768
    x = torch.from_numpy(rng.random((P, 3)).astype(np.float32)).to(dev, getattr(torch, xt))
    g = torch.from_numpy(rng.normal(size=(P, cfg.out_dim)).astype(np.float32)).to(dev)
    g[::5] = 0.0
    g = g.to(torch.bfloat16)
    nrows = [cfg.level_rows(l) for l in range(cfg.levels)]
    got = hg.hash_cell_bwd_tables_kernel(x, g, cfg, nrows, [torch.bfloat16] * cfg.levels)
    want = hg.hash_cell_bwd_tables_plain(x, g, cfg, nrows, [torch.bfloat16] * cfg.levels)
    ref = hg.hash_cell_bwd_tables_plain(x, g.float(), cfg, nrows,
                                        [torch.float32] * cfg.levels)
    for l, (a, b, r) in enumerate(zip(got, want, ref)):
        d_kernel, d_plain = float((a.float() - r).norm()), float((b.float() - r).norm())
        assert d_plain > 0 and d_kernel <= 1.5 * d_plain, (l, d_kernel, d_plain)


@pytest.mark.requires_cuda
def test_nearest_on_card_finds_the_row_and_the_corner_exactly():
    dev = _card()
    cfg = tenc.HashGridConfig(**_cfg_kw(4, "Nearest", True))
    x = torch.from_numpy(_points(cfg, seed=4)).to(dev)
    F = cfg.features_per_level
    tabs = []
    for l in range(cfg.levels):
        r = torch.arange(cfg.level_rows(l), dtype=torch.float32, device=dev)
        c = torch.arange(8, dtype=torch.float32, device=dev)
        tabs.append((8 * r[:, None, None] + c[None, :, None])
                    .expand(-1, 8, F).reshape(-1, 8 * F).contiguous())
    assert torch.equal(hg.hash_cell_fwd_kernel(tabs, x, cfg),
                       hg.hash_cell_fwd_plain(tabs, x, cfg))


@pytest.mark.requires_cuda
def test_double_backward_on_card_matches_plain():
    """forward kernel → cotangent kernel → forward kernel, through
    ``hash_encode``, against the same graph on the CPU."""
    dev = _card()
    cfg, _, (x, tabs, g), _ = _both("float32", "float32", 2, "Linear", True, seed=5)
    v = [torch.from_numpy(np.random.default_rng(l).normal(size=t.shape)
                          .astype(np.float32)) for l, t in enumerate(tabs)]

    def run(device):
        ts = [t.to(device).requires_grad_(True) for t in tabs]
        gd = g.to(device).requires_grad_(True)
        out = tenc.hash_encode(ts, x.to(device), cfg)
        grads = torch.autograd.grad(out, ts, gd, create_graph=True)
        (dg,) = torch.autograd.grad(grads, gd, [t.to(device) for t in v])
        return [t.cpu() for t in grads], dg.cpu()

    before = hg.launch_counts()
    (got_t, got_g), (want_t, want_g) = run(dev), run("cpu")
    assert hg.launch_counts() == (before[0] + 2, before[1] + 1)
    for a, b in zip(got_t, want_t):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-7)
