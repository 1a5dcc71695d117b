"""The port's cell-layout hash encode (acn_tpu_torch.ops.hashgrid): its plain
forward and table cotangent against acn_tpu's ``_hash_encode_cell_saved``
and its ``jax.vjp``; ``HashCellBwdTables`` as a function with a gradient;
the CUDA kernels against the plain versions on the card (``requires_cuda``).

The same numpy inputs, made from a seed, go through both packages at micro
shapes (4 levels, 2^12 rows, a few hundred points; F = 1, 2, 3, 4, 8 and 16,
and 37 levels), x01 and tables in
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

import time

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


def _cfg_kw(F=2, interpolation="Linear", dense=True, levels=4):
    # 4 levels: resolutions 16, 101, 645, 4095 (4096 in bf16); level 0 dense
    # when on
    return dict(levels=levels, min_res=16, max_res=4096, log2_hashmap_size=12,
                features_per_level=F, layout="cell", dense_levels=dense,
                interpolation=interpolation)


def _points(cfg, n=None, seed=0):
    """Random points, cell faces k/res of every level and k/64, the clamp
    ends: where floor and the fraction could round apart (320 points at 4
    levels, 32 more a level above)."""
    rng = np.random.default_rng(seed)
    res = cfg.level_resolutions()
    b = 32 * len(res)
    x = rng.random((n or b + 192, 3)).astype(np.float32)
    for i, r in enumerate(res):
        x[32 * i:32 * (i + 1)] = (rng.integers(0, r + 1, (32, 3)) / r).astype(np.float32)
    x[b:b + 32] = (rng.integers(0, 65, (32, 3)) / 64.0).astype(np.float32)
    x[b + 32:b + 48] = np.float32(1 - 1e-6)
    x[b + 48:b + 56] = np.float32(1e-6)
    x[b + 56:b + 64, 0] = np.float32(1 - 1e-6)  # one axis at the end
    return x


def _tables(cfg, seed=1):
    """U(−1e-3, 1e-3), ``init_hash_table``'s scale (``hash_init_scale``),
    which atol 1e-9 was set for: a few float32 ulps of the terms."""
    rng = np.random.default_rng(seed)
    return [(1e-3 * rng.uniform(-1.0, 1.0, size=(cfg.level_rows(l), 8 * cfg.features_per_level)))
            .astype(np.float32) for l in range(cfg.levels)]


def _both(xt, tt, F, interpolation, dense, seed=0, levels=4):
    kw = _cfg_kw(F, interpolation, dense, levels)
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
    _hold_plain_to_jax(*_both(xt, tt, F, interpolation, dense), tt)


# F with a kernel of its own beside 2, 4 and 8 (1: one bf16 lane a row; 16:
# 32 f32 lanes, 4 a corner), an odd F (the general kernels: a corner
# straddles 16-byte pieces), and 37 levels (a ragged last group of 4, above
# the 32 that the kernels' parameters once held)
F_AND_LEVELS = [(1, 4), (16, 4), (3, 4), (3, 37)]


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("xt,tt", [("float32", "float32"), ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("F,levels", F_AND_LEVELS)
def test_plain_matches_jax_at_every_f_and_level_count(F, levels, xt, tt, dense):
    """The plain forward and table cotangent against ``acn_tpu``'s at F =
    1, 3 and 16 and at 37 levels, dense and hashed levels, float32 and
    bfloat16: the tolerances of the kernels' widths before."""
    _hold_plain_to_jax(*_both(xt, tt, F, "Linear", dense, levels=levels), tt)


def _hold_plain_to_jax(cfg_t, cfg_j, torch_in, jax_in, tt):
    """The cell decisions bit-equal, then the plain versions against
    ``_hash_encode_cell_saved`` and its VJP (module docstring's
    tolerances)."""
    (x, tabs, g), (jx, jtabs, jg) = torch_in, jax_in
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
    assert set(paths) == {"segscan", "composite", "hashgrid", "ngp_net"}
    assert paths["segscan"].name.startswith("libsegscan-")
    assert paths["composite"].name.startswith("libcomposite-")
    assert paths["hashgrid"].name.startswith("libhashgrid-")
    assert paths["ngp_net"].name.startswith("libngp_net-")
    assert paths["segscan"] == cuda_lib.library_path()  # the scan's default
    assert cuda_lib.library_path(("SEGSCAN_ITEMS=4",)) != paths["segscan"]


FAKE_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
sleep "${FAKE_NVCC_SLEEP:-0.2}"
echo "ptxas info    : fake"
: > "$out"
"""


def _fake_nvcc(tmp_path, monkeypatch, sleep: str):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_lib, "_PENDING", {})
    monkeypatch.setenv("FAKE_NVCC_SLEEP", sleep)


def test_start_all_builds_in_the_background_and_each_waits_for_its_own(
        tmp_path, monkeypatch):
    """``start_all`` returns before any build ends; ``finish`` waits for one
    library, ``build`` (what ``load`` calls) for a started one rather than
    starting a second nvcc, and ``build_all`` then finds every library
    built (no nvcc, 0 s)."""
    _fake_nvcc(tmp_path, monkeypatch, "0.5")
    t0 = time.perf_counter()
    cuda_lib.start_all()
    assert time.perf_counter() - t0 < 0.4
    assert set(cuda_lib._PENDING) == set(cuda_lib.SOURCES)
    assert cuda_lib.finish("segscan") > 0.3
    assert cuda_lib.library_path(source="segscan").exists()
    assert cuda_lib.build(source="composite") > 0.3
    assert "composite" not in cuda_lib._PENDING
    assert "ptxas info" in cuda_lib.build_log(source="composite")
    first = cuda_lib.build_all()  # waits for the two still building
    assert first["segscan"] == first["composite"] == 0.0
    assert first["hashgrid"] > 0.3 and first["ngp_net"] > 0.3
    assert cuda_lib.build_all() == dict.fromkeys(cuda_lib.SOURCES, 0.0)
    assert all(cuda_lib.library_path(source=n).exists() for n in cuda_lib.SOURCES)
    assert not cuda_lib._PENDING
    assert not list((tmp_path / "build").glob("*.tmp*"))


def test_builds_nobody_waited_for_end_at_exit(tmp_path, monkeypatch):
    """A run that fails before waiting for its builds leaves no nvcc behind
    and no library or temporary output."""
    _fake_nvcc(tmp_path, monkeypatch, "30")
    cuda_lib.start_all()
    procs = [s[0] for s in cuda_lib._PENDING.values()]
    cuda_lib._cancel_pending()
    assert all(p.poll() is not None for p in procs) and not cuda_lib._PENDING
    assert not list((tmp_path / "build").iterdir())


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_cached_launch_constants_equal_fresh_ones(x_dtype, interpolation, dense):
    """What the wrappers cache per (config, x01 type) is what a fresh build
    gives, and what the cell math says: the scale rounded to x01's type
    (4095 → 4096 in bf16), the resolution, the dense flag, the ladder."""
    cfg = tenc.HashGridConfig(**_cfg_kw(4, interpolation, dense))
    cached, fresh = hg._consts(cfg, x_dtype), hg._consts.__wrapped__(cfg, x_dtype)
    assert hg._consts(cfg, x_dtype) is cached and fresh is not cached
    L = cfg.levels
    res = [int(r) for r in cfg.level_resolutions()]
    for c in (cached, fresh):
        assert list(c.scale) == [hg._res_as(r, x_dtype) for r in res]
        assert list(c.res) == res
        assert list(c.dense) == [int(hg._is_dense(cfg, l)) for l in range(L)]
        assert c.rows == tuple(cfg.level_rows(l) for l in range(L))
        assert c.tail == (L, 4, cfg.log2_hashmap_size, INTERPOLATIONS.index(interpolation))
        assert (c.x_bf16, c.width, c.out_dim) == (int(x_dtype == torch.bfloat16), 32, 4 * L)
    assert hg.level_rows(cfg) == cached.rows
    if x_dtype == torch.bfloat16:
        assert list(cached.scale)[-1] == 4096.0 and res[-1] == 4095


def test_launch_constants_refuse_configs_the_kernels_do_not_take():
    """F = 3 and 33 levels, once refused, are taken now with every F and
    level count (1, 16, 37 levels); a log2_hashmap_size of 0, or above 31
    (no card holds 2^32 rows), and an unknown interpolation are refused."""
    for kw in (dict(features_per_level=3), dict(levels=33), dict(features_per_level=1),
               dict(features_per_level=16), dict(features_per_level=5, levels=37)):
        cfg = tenc.HashGridConfig(**{**_cfg_kw(), **kw})
        c = hg._consts.__wrapped__(cfg, torch.float32)
        assert (c.width, c.out_dim) == (8 * cfg.features_per_level, cfg.out_dim)
    for kw in (dict(log2_hashmap_size=0), dict(interpolation="Cubic")):
        cfg = tenc.HashGridConfig(**{**_cfg_kw(), **kw})
        with pytest.raises(ValueError):
            hg._consts.__wrapped__(cfg, torch.float32)
    cfg = tenc.HashGridConfig(**{**_cfg_kw(), "log2_hashmap_size": 32})
    with pytest.raises(ValueError, match="fits on no card"):
        hg._consts.__wrapped__(cfg, torch.float32)


def test_table_checks_refuse_what_the_kernels_do_not_take():
    """``_check_tables`` on CPU tensors (device index −1): the tables the
    kernels take pass and give their pointers; each fault raises."""
    cfg = tenc.HashGridConfig(**_cfg_kw(4))
    c = hg._consts(cfg, torch.float32)
    good = [torch.zeros((r, 32)) for r in c.rows]
    dtype, ptrs = hg._check_tables(good, c, -1, "t")
    assert dtype == torch.float32 and list(ptrs) == [t.data_ptr() for t in good]
    hg._check_tables([torch.zeros((r + 5, 32)) for r in c.rows], c, -1, "t")  # more rows
    buf = torch.zeros(c.rows[1] * 32 + 1)
    faults = {
        "count": good[:-1],
        "type": [t.double() for t in good],
        "mixed types": good[:1] + [t.bfloat16() for t in good[1:]],
        "device": None,
        "contiguous": good[:1] + [torch.zeros((32, c.rows[1])).t()] + good[2:],
        "rows": good[:1] + [torch.zeros((c.rows[1] - 1, 32))] + good[2:],
        "width": good[:1] + [torch.zeros((c.rows[1], 16))] + good[2:],
        "aligned": good[:1] + [buf[1:].view(c.rows[1], 32)] + good[2:],
    }
    for what, tables in faults.items():
        with pytest.raises((ValueError, TypeError)):
            hg._check_tables(good if tables is None else tables, c,
                             0 if tables is None else -1, what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [2, 4, 8, 1, 3, 16])
def test_cotangent_tables_are_separate_aligned_blocks_of_one_allocation(F, dtype):
    nrows = (4096, 42875, 131072, 3)
    tables = hg._alloc_tables(nrows, 8 * F, dtype, "cpu")
    assert [tuple(t.shape) for t in tables] == [(r, 8 * F) for r in nrows]
    assert all(t.dtype == dtype and t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tables)
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for t in tables)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))  # no overlap
    for l, t in enumerate(tables):
        t.fill_(l + 1)
    assert all(bool((t == l + 1).all()) for l, t in enumerate(tables))


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


def _card_pair(xt, tt, F, P, levels=4, seed=9):
    """x01 (P, 3), tables, g (P, L·F) on the card from numpy draws."""
    kw = {**_cfg_kw(F), "levels": levels}
    cfg = tenc.HashGridConfig(**kw)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((P, 3)).astype(np.float32))
    tabs = [torch.from_numpy(t) for t in _tables(cfg, seed=seed)]
    g = torch.from_numpy(rng.normal(size=(P, cfg.out_dim)).astype(np.float32))
    dev = "cuda"
    return (cfg, x.to(dev, getattr(torch, xt)), [t.to(dev, getattr(torch, tt)) for t in tabs],
            g.to(dev, getattr(torch, tt)))


def _most_adds(h: torch.Tensor, real: torch.Tensor, nrows: int, run: int = 32) -> torch.Tensor:
    """(nrows,) float: at most how many adds the cotangent kernel makes into
    each row of a level, from the points' rows h and which of them carry a
    nonzero cotangent: one a point, but one for ``run`` aligned points that
    all carry one and all fall in the row: a warp's 32 where F has a kernel
    of its own (their runs end together and are summed first), a thread's
    8 in the general kernel."""
    h, real = h.reshape(-1).cpu(), real.reshape(-1).cpu()
    n = torch.bincount(h[real], minlength=nrows).float()
    whole = h.numel() // run * run
    seg, seg_real = h[:whole].view(-1, run), real[:whole].view(-1, run)
    one_row = (seg == seg[:, :1]).all(1) & seg_real.all(1)
    return n - (run - 1) * torch.bincount(seg[one_row, 0], minlength=nrows).float()


def _hold_to_plain(cfg, x, tabs, g):
    """The kernels against the plain versions at the card tests' limits:
    float32 forward within 2e-6 of the largest |out|, cotangent rtol 1e-5 /
    atol 1e-6; bfloat16 forward within one ulp, cotangent within n · 2^-8 of
    the terms' magnitudes, n the most adds the kernel can make into that
    row (``_most_adds``). Returns n per level."""
    nrows, dtypes = [t.shape[0] for t in tabs], [t.dtype for t in tabs]
    got = hg.hash_cell_fwd_kernel(tabs, x, cfg)
    got_t = hg.hash_cell_bwd_tables_kernel(x, g, cfg, nrows, dtypes)
    torch.cuda.synchronize()
    want = hg.hash_cell_fwd_plain(tabs, x, cfg)
    assert got.shape == want.shape == (x.shape[0], cfg.out_dim) and got.dtype == want.dtype
    if x.shape[0] == 0:
        assert all(not bool(t.any()) for t in got_t)
        return []
    F = cfg.features_per_level
    run = 32 if F in hg.FEATURES else 8
    adds = [_most_adds(hg._cell_index(x, cfg, l)[0], (g[:, l * F:(l + 1) * F] != 0).any(-1),
                       nrows[l], run) for l in range(cfg.levels)]
    if tabs[0].dtype == torch.float32:
        assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())
        for a, b in zip(got_t, hg.hash_cell_bwd_tables_plain(x, g, cfg, nrows, dtypes)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        return adds
    assert float(_ulps_apart_bf16(got, want).max()) <= 1.0
    # the float32 sum of the kernel's own terms, w and each product rounded
    # to bf16 as the plain version rounds them (a row of one add: the bound
    # is the rounding of its sum alone)
    ref = hg.hash_cell_bwd_tables_plain(x, g, cfg, nrows, [torch.float32] * cfg.levels)
    mag = hg.hash_cell_bwd_tables_plain(x, g.abs(), cfg, nrows, [torch.float32] * cfg.levels)
    for l, (a, r, m, n) in enumerate(zip(got_t, ref, mag, adds)):
        bound = n.to(m.device)[:, None] * BF16_EPS * m
        assert bool(((a.float() - r).abs() <= bound).all()), l
    return adds


@pytest.mark.requires_cuda
@pytest.mark.parametrize("levels", [4, 3, 37])
@pytest.mark.parametrize("P", [0, 1, 63, 65, 1000])
@pytest.mark.parametrize("tt", ["float32", "bfloat16"])
def test_kernels_at_ragged_and_empty_point_counts_on_card(tt, P, levels):
    """P off the block's points (64 at 4 levels a block), one point, none;
    3 and 37 levels leave a block's level group short."""
    _card()
    cfg, x, tabs, g = _card_pair("float32", tt, 4, P, levels=levels)
    before = hg.launch_counts()
    _hold_to_plain(cfg, x, tabs, g)
    assert hg.launch_counts() == (before[0] + (1 if P else 0), before[1] + 1)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("F", [2, 4, 8, 1, 16, 3, 5, 31])
@pytest.mark.parametrize("xt,tt", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                   ("float32", "bfloat16"), ("bfloat16", "float32")])
def test_every_row_width_on_card(xt, tt, F):
    """Rows of 64, 128 and 256 bytes in float32 (4, 8, 16 lanes a task; at
    F = 8 a corner spans two lanes), 32, 64 and 128 in bfloat16; F = 1 (one
    bf16 lane a task, 8 corners a lane) and 16 (32 f32 lanes, a corner over
    4); and the general kernels at F = 3, 5 and 31 (a corner straddles
    16-byte pieces, a bf16x2 pair two corners; 31 f32 rows of 992 bytes,
    4 a round in a warp's stage)."""
    _card()
    _hold_to_plain(*_card_pair(xt, tt, F, 777))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("F", [3, 16])
@pytest.mark.parametrize("tt", ["float32", "bfloat16"])
def test_many_levels_on_card(tt, F):
    """37 levels (ten groups of 4, the last of 1), the general kernel and
    a kernel of its own, over a few blocks of points."""
    _card()
    _hold_to_plain(*_card_pair("float32", tt, F, 300, levels=37))


def _hold_fwd_to_plain(cfg, x, tabs, got):
    """A forward against the plain version at the card tests' limits:
    float32 within 2e-6 of the largest |out|, bfloat16 within one ulp."""
    want = hg.hash_cell_fwd_plain(tabs, x, cfg)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.numel() == 0:
        return
    if got.dtype == torch.float32:
        assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())
    else:
        assert float(_ulps_apart_bf16(got, want).max()) <= 1.0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("P", [0, 1, 63, 65, 129, 1000])
@pytest.mark.parametrize("levels", [1, 8, 16, 37])
@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("tt", ["float32", "bfloat16"])
def test_f1_and_general_forward_on_and_off_their_tiling_on_card(tt, F, levels, P):
    """The F = 1 forward (128 points a block, grid rows of 8 levels in float32
    and 16 in bfloat16, two lanes a point) and the general one (8 points by 4
    levels a warp, 64 points a block) at point counts on and off a block and
    a warp, level counts of one, whole and ragged grid rows; the cotangent
    beside them."""
    _card()
    cfg, x, tabs, g = _card_pair("float32", tt, F, P, levels=levels)
    before = hg.launch_counts()
    _hold_to_plain(cfg, x, tabs, g)
    assert hg.launch_counts() == (before[0] + (1 if P else 0), before[1] + 1)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
@pytest.mark.parametrize("xt,tt", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                   ("float32", "bfloat16"), ("bfloat16", "float32")])
@pytest.mark.parametrize("F", [1, 3])
def test_f1_and_general_forward_every_interpolation_and_type_pair_on_card(
        F, xt, tt, interpolation, dense):
    """F = 1 and F = 3 on ``_points``' cell faces and clamp ends, in every
    interpolation, x01 and tables in each of the four type pairs, dense
    levels on and off."""
    dev = _card()
    cfg, _, (x, tabs, _), _ = _both(xt, tt, F, interpolation, dense, seed=13)
    xc, tc = x.to(dev), [t.to(dev) for t in tabs]
    got = hg.hash_cell_fwd_kernel(tc, xc, cfg)
    torch.cuda.synchronize()
    _hold_fwd_to_plain(cfg, xc, tc, got)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("F,levels", [(3, 37), (1, 37), (1, 16)])
@pytest.mark.parametrize("tt", ["float32", "bfloat16"])
def test_forward_into_the_second_experts_slice_on_card(tt, F, levels):
    """``out=`` as expert 1's slice of a (2, P, L·F) buffer, P = 63: at an
    odd L·F the slice and most points' rows are not 16-byte aligned (stores
    narrow to single values), at L = 16, F = 1 they are (16-byte vectors);
    expert 0's slice keeps its bits."""
    _card()
    cfg, x, tabs, _ = _card_pair("float32", tt, F, 63, levels=levels)
    buf = torch.full((2, 63, cfg.out_dim), 7.0, dtype=tabs[0].dtype, device="cuda")
    aligned = buf[1].data_ptr() % 16 == 0
    assert aligned == (levels * F % 4 == 0 if tt == "float32" else levels * F % 8 == 0)
    got = hg.hash_cell_fwd_kernel(tabs, x, cfg, out=buf[1])
    torch.cuda.synchronize()
    assert got.data_ptr() == buf[1].data_ptr()
    _hold_fwd_to_plain(cfg, x, tabs, buf[1])
    assert bool((buf[0] == 7.0).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("F", [1, 3])
@pytest.mark.parametrize("tt", ["float32", "bfloat16"])
def test_two_forward_launches_are_bit_equal_on_card(tt, F):
    """No atomics and a fixed order of every sum: two launches on the same
    inputs give the same bits."""
    _card()
    cfg, x, tabs, _ = _card_pair("float32", tt, F, 1000, levels=37)
    a = hg.hash_cell_fwd_kernel(tabs, x, cfg)
    b = hg.hash_cell_fwd_kernel(tabs, x, cfg)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("F", [2, 4, 8, 1, 16])
@pytest.mark.parametrize("tt", ["float32", "bfloat16"])
def test_a_warp_of_points_in_one_row_is_summed_first_on_card(tt, F):
    """96 neighbouring points in one level-0 cell (ray order on a coarse
    level), three whole warps of it: the cotangent sums each warp's runs in
    f32 before one add, at every group width (float32: 4, 8 and 16 lanes a
    task; bfloat16: 2, 4 and 8). Float32 within rtol 1e-5 of plain;
    bfloat16 within n · 2^-8 of the terms' magnitudes with n = 3 in that
    row (one add a warp), not 96."""
    _card()
    cfg, _, tabs, g = _card_pair("float32", tt, F, 96 + 32)
    rng = np.random.default_rng(11)
    x = np.concatenate([(3 + 0.1 + 0.8 * rng.random((96, 3))) / 16.0,
                        rng.random((32, 3))]).astype(np.float32)
    x = torch.from_numpy(x).cuda()
    row = int(hg._cell_index(x[:1], cfg, 0)[0])
    assert int(torch.bincount(hg._cell_index(x, cfg, 0)[0])[row]) >= 96
    adds = _hold_to_plain(cfg, x, tabs, g)
    assert 3 <= float(adds[0][row]) <= 4  # three warps, and a random point at most


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tt", ["float32", "bfloat16"])
def test_pad_slots_change_no_bit_on_card(tt):
    """Many zero-cotangent points in one cell (a budget pack's pad slots)
    beside real points at most two to a row: the kernel's tables equal the
    plain ``index_add_``'s bit for bit."""
    _card()
    cfg = tenc.HashGridConfig(**_cfg_kw(4))
    rng = np.random.default_rng(23)
    cells = rng.choice(16**3, size=200, replace=False)
    ijk = np.stack([cells // 256, (cells // 16) % 16, cells % 16], -1)
    real = (ijk + 0.05 + 0.9 * rng.random((200, 3))) / 16.0
    x = np.concatenate([real, np.repeat(real[:1], 3000, 0)]).astype(np.float32)
    g = rng.normal(size=(len(x), cfg.out_dim)).astype(np.float32)
    g[200:] = 0.0
    dt = getattr(torch, tt)
    x, g = torch.from_numpy(x).cuda(), torch.from_numpy(g).cuda().to(dt)
    for l in range(cfg.levels):
        assert int(torch.bincount(hg._cell_index(x[:200], cfg, l)[0]).max()) <= 2
    nrows = [cfg.level_rows(l) for l in range(cfg.levels)]
    got = hg.hash_cell_bwd_tables_kernel(x, g, cfg, nrows, [dt] * cfg.levels)
    want = hg.hash_cell_bwd_tables_plain(x, g, cfg, nrows, [dt] * cfg.levels)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_bench_ray_ordered_points_are_a_packed_march():
    """The ray-ordered set of ``ops/hashgrid_bench.py`` (phase 14 of the
    smoke), at 64 rays on the CPU: 32 slots a ray, real samples first and
    ray-major, x01 inside the clamp, neighbouring samples mostly in one
    level-0 cell."""
    from acn_tpu_torch.models.ngp import ENC_EPS
    from acn_tpu_torch.ops import hashgrid_bench as bh

    x, real = bh.ray_ordered_points(64, device="cpu")
    assert x.shape == (64 * 32, 3) and x.dtype == torch.float32 and x.is_contiguous()
    n = int(real.sum())
    assert 0 < n < x.shape[0] and bool(real[:n].all()) and not bool(real[n:].any())
    eps = float(torch.tensor(ENC_EPS, dtype=torch.float32))  # the clamp's float32 bound
    assert float(x.min()) >= eps and float(x.max()) <= 1 - eps
    h, _ = hg._cell_index(x[:n], bh.hash_config(), 0)
    assert float((h[1:] == h[:-1]).float().mean()) > 0.5


def test_most_adds_counts_a_point_each_but_one_a_whole_warp():
    h = torch.tensor([5] * 32 + [5] * 31 + [7] + [5] * 3)
    real = torch.ones(h.numel(), dtype=torch.bool)
    assert _most_adds(h, real, 8).tolist() == [0, 0, 0, 0, 0, 1 + 31 + 3, 0, 1]
    real[3] = False  # a pad slot: the warp's runs may end apart
    assert _most_adds(h, real, 8).tolist() == [0, 0, 0, 0, 0, 31 + 31 + 3, 0, 1]


def test_timing_copies_span_the_cold_bytes():
    """The timed runs cycle over copies of the inputs that together exceed
    the L2 four times; one copy where a call's bytes already do."""
    from acn_tpu_torch.ops import hashgrid_bench as hb

    assert hb.COLD_BYTES >= 4 * hb.L2_BYTES
    assert hb.copies_for(hb.COLD_BYTES) == hb.copies_for(10 * hb.COLD_BYTES) == 1
    assert hb.copies_for(hb.COLD_BYTES / 3) == 3 and hb.copies_for(hb.COLD_BYTES / 2.5) == 3
    assert hb.copies_for(1.0) == hb.copies_for(0) == hb.MAX_COPIES


def test_bench_configs_are_the_smoke_grid_or_a_flag_sets():
    """``f16`` is the smoke's grid at F = 16 (rows of 128 values, the widest
    the templates take), ``l16f2`` at 16 levels of F = 2; ``l40f3`` and
    ``f1`` are ``toy.flag_config``'s grids; other names are refused."""
    from acn_tpu_torch.ops import hashgrid_bench as hb

    smoke, f16 = hb.hash_config("smoke"), hb.hash_config("f16")
    assert (f16.levels, f16.features_per_level, f16.out_dim) == \
        (smoke.levels, 16, 16 * smoke.levels)
    assert [f16.level_rows(l) for l in range(f16.levels)] == \
        [smoke.level_rows(l) for l in range(smoke.levels)]
    l16f2 = hb.hash_config("l16f2")
    assert (l16f2.levels, l16f2.features_per_level) == (16, 2)
    for name, (L, F) in {"l40f3": (40, 3), "f1": (16, 1), "l16f8": (16, 8)}.items():
        h = hb.hash_config(name)
        assert (h.levels, h.features_per_level, h.log2_hashmap_size) == \
            (L, F, smoke.log2_hashmap_size), name
    assert {"f16", "l40f3", "f1"} <= set(hb.CONFIGS)
    with pytest.raises(ValueError, match="unknown hash config"):
        hb.hash_config("f32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bench_bounds_count_each_distinct_byte_once(dtype):
    """The byte bound: x01 and the output once a point, each distinct row
    once however many points gather it; the cotangent x01, g and one write
    of every table row."""
    from acn_tpu_torch.ops import hashgrid_bench as hb

    cfg = tenc.HashGridConfig(**_cfg_kw(4))
    L, F = cfg.levels, cfg.features_per_level
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((50, 3)).astype(np.float32))
    x = torch.cat([x, x[:10], x[:10]]).to(dtype)  # 20 repeats gather no new row
    rows = [cfg.level_rows(l) for l in range(L)]
    tabs = [torch.zeros((r, 8 * F), dtype=dtype) for r in rows]
    g = torch.zeros((70, L * F), dtype=dtype)
    d = sum(len(set(hg._cell_index(x[:50], cfg, l)[0].tolist())) for l in range(L))
    s = x.element_size()
    fwd, bwd, got_d = hb.work_bytes(x, g, tabs, rows, cfg)
    assert got_d == d
    assert fwd == 70 * 3 * s + d * 8 * F * s + 70 * L * F * s
    assert bwd == 70 * 3 * s + 70 * L * F * s + sum(rows) * 8 * F * s
    f_ms, b_ms, _ = hb.bounds_ms(x, g, tabs, rows, cfg)
    assert f_ms == pytest.approx(1e3 * fwd / hb.HBM_BYTES_PER_S)
    assert b_ms == pytest.approx(1e3 * bwd / hb.HBM_BYTES_PER_S)
