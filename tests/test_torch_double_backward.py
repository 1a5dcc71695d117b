"""Every ``torch.autograd.Function`` on the port's training path is twice
differentiable, as JAX's reverse-over-reverse makes its counterparts:
``SegExclSum`` and ``SegExclRSum`` (acn_tpu_torch.ops.segscan),
``_HashEncodeCellSaved`` (models.encodings), ``_TruncExp``
(models.trunc_exp) and ``_ClipHalfTies`` (models.nn); and the fixed-layout
transmittance's ``torch.cumprod`` is held to ``jnp.cumprod``'s second
derivative.

* ``torch.autograd.gradgradcheck`` in float64 (finite differences of the
  analytic first derivative against its analytic derivative). The cell
  encode's x path works in float32, as acn_tpu's ``_saved_bwd`` does, so its
  check takes steps of 1e-4 instead of 1e-6.
* The scan's backward under ``create_graph`` is a ``SegExclRSum`` node and
  that node's backward a ``SegExclSum`` one: the CPU takes the autograd path
  the card takes, where each is a kernel launch (the ``requires_cuda`` test
  counts them and holds the card's second derivative to the plain one).
* Against JAX: Hessian-vector products of trunc_exp (past and on its clamp,
  where JAX's derivative carries the clip's mask and ``jnp.clip``'s half
  share), of ``clip_half_ties`` at ties, of the scan, and of a cumprod
  transmittance, float32, rtol 1e-5.
* A first-order backward of the transmittance and of trunc_exp is the plain
  ops' own, bit for bit (the twice-differentiable form runs only under
  ``create_graph``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.models.trunc_exp import trunc_exp as jtrunc_exp
from acn_tpu.ops.segscan import seg_excl_sum as jseg
from acn_tpu_torch.models import encodings as tenc
from acn_tpu_torch.models import nn as tnn
from acn_tpu_torch.models.trunc_exp import trunc_exp
from acn_tpu_torch.ops import segscan as tseg
from torch_m9_util import one_thread  # noqa: F401  (pytestmark uses it)

pytestmark = pytest.mark.usefixtures("one_thread")


F64 = torch.float64


def _starts(n, seed=0, mean=4):
    s = np.random.default_rng(seed).random(n) < 1.0 / mean
    s[0] = True
    return torch.from_numpy(s)


# ------------------------------------------------------------- gradgradcheck


@pytest.mark.parametrize("fn", ["seg_excl_sum", "seg_excl_rsum"])
def test_scan_gradgradcheck(fn):
    x = torch.randn(37, dtype=F64, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    s = _starts(37)
    f = lambda v: getattr(tseg, fn)(v, s)
    assert torch.autograd.gradcheck(f, (x,))
    assert torch.autograd.gradgradcheck(f, (x,))


def test_scan_backward_is_the_reverse_function_and_its_backward_the_forward():
    x = torch.randn(20, requires_grad=True)
    g = torch.randn(20, requires_grad=True)
    s = _starts(20, seed=2)
    y = tseg.seg_excl_sum(x, s)
    (gx,) = torch.autograd.grad(y, x, g, create_graph=True)
    assert type(gx.grad_fn).__name__ == "SegExclRSumBackward"
    assert torch.equal(gx.detach(), tseg.seg_excl_rsum_plain(g.detach(), s))
    v = torch.randn(20, requires_grad=True)
    (gg,) = torch.autograd.grad(gx, g, v, create_graph=True)
    assert type(gg.grad_fn).__name__ == "SegExclSumBackward"
    assert torch.equal(gg.detach(), tseg.seg_excl_sum_plain(v.detach(), s))


def _cell_cfg(interpolation="Linear"):
    return tenc.HashGridConfig(levels=2, min_res=4, max_res=8, log2_hashmap_size=2,
                               features_per_level=2, layout="cell",
                               interpolation=interpolation)


@pytest.mark.parametrize("interpolation", ["Linear", "Smoothstep"])
def test_cell_hash_encode_gradgradcheck_in_the_tables(interpolation):
    cfg = _cell_cfg(interpolation)
    tabs = [t.to(F64).requires_grad_(True) for t in tenc.init_hash_table(
        cfg, generator=torch.Generator().manual_seed(0))]
    x = torch.rand(6, 3, dtype=F64, generator=torch.Generator().manual_seed(3))
    f = lambda *t: tenc.hash_encode(list(t), x, cfg)
    assert torch.autograd.gradgradcheck(f, tabs)


# the x path works in float64 when x01 is float64, so eps = 1e-4 differences
# float64 roundings at every seed
X_PATH_SEEDS = range(8)


@pytest.mark.parametrize("seed", X_PATH_SEEDS)
def test_cell_hash_encode_gradgradcheck_with_the_x_path(seed):
    """The output cotangents come from the test's own generator (seed), not
    from the global one, whose state depends on the tests run before."""
    cfg = _cell_cfg()
    tabs = [t.to(F64).requires_grad_(True) for t in tenc.init_hash_table(
        cfg, generator=torch.Generator().manual_seed(0))]
    x = torch.rand(5, 3, dtype=F64, generator=torch.Generator().manual_seed(3),
                   requires_grad=True)
    f = lambda xx, *t: tenc.hash_encode(list(t), xx, cfg)
    g = torch.randn((5, cfg.out_dim), dtype=F64,
                    generator=torch.Generator().manual_seed(seed)).requires_grad_(True)
    assert torch.autograd.gradgradcheck(f, (x, *tabs), grad_outputs=(g,), eps=1e-4)


def test_trunc_exp_gradgradcheck():
    x = torch.tensor([-800.0, -3.0, -0.2, 0.0, 0.7, 5.0, 800.0], dtype=F64,
                     requires_grad=True)
    assert torch.autograd.gradgradcheck(trunc_exp, (x,))


def test_clip_half_ties_gradgradcheck():
    x = torch.tensor([-2.0, -0.3, 0.1, 0.4, 0.9, 1.7], dtype=F64, requires_grad=True)
    f = lambda v: tnn.clip_half_ties(v, 0.0, 1.0) ** 3
    assert torch.autograd.gradgradcheck(f, (x,))


# ------------------------------------------------------- against JAX, float32


def _hvp_port(f, x, v):
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad(f(xt), xt, create_graph=True)
    (h,) = torch.autograd.grad(g, xt, torch.from_numpy(v))
    return g.detach().numpy(), h.numpy()


def _hvp_jax(f, x, v):
    """Reverse over reverse, as JAX differentiates a custom_vjp's backward."""
    g = jax.grad(f)
    h = jax.grad(lambda t: jnp.vdot(g(t), jnp.asarray(v)))
    return np.asarray(g(jnp.asarray(x))), np.asarray(h(jnp.asarray(x)))


def test_trunc_exp_second_derivative_matches_jax_past_and_on_the_clamp():
    x = np.array([-90.0, -88.0, -3.0, 0.5, 2.0, 88.0, 88.5, 120.0], np.float32)
    w = np.linspace(-1e-3, 2e-3, x.size).astype(np.float32) * np.float32(1e-30)
    v = np.ones_like(x)
    got = _hvp_port(lambda t: (torch.from_numpy(w) * trunc_exp(t)).sum(), x, v)
    want = _hvp_jax(lambda t: jnp.sum(jnp.asarray(w) * jtrunc_exp(t)), x, v)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    # past the clamp the second derivative is 0, on it half of exp(88)·w
    assert got[1][0] == 0.0 and got[1][-1] == 0.0 and got[1][-2] == 0.0
    assert got[1][5] == pytest.approx(0.5 * float(np.exp(np.float32(88)) * w[5]), rel=1e-5)


def test_clip_half_ties_second_derivative_matches_jnp_clip():
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.4, 0.99], np.float32)
    v = np.linspace(0.5, 1.5, x.size).astype(np.float32)
    got = _hvp_port(lambda t: (tnn.clip_half_ties(t, 0.0, 1.0) ** 2).sum(), x, v)
    want = _hvp_jax(lambda t: jnp.sum(jnp.clip(t, 0.0, 1.0) ** 2), x, v)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    assert got[1][1] == pytest.approx(0.5 * v[1])  # a tie: 2·(½)²


def test_scan_second_derivative_matches_jax():
    n = 64
    rng = np.random.default_rng(4)
    x = rng.normal(size=n).astype(np.float32) * 0.3
    v = rng.normal(size=n).astype(np.float32)
    s = _starts(n, seed=5)
    w = rng.normal(size=n).astype(np.float32)
    got = _hvp_port(lambda t: (torch.from_numpy(w) * torch.exp(tseg.seg_excl_sum(t, s))).sum(),
                    x, v)
    want = _hvp_jax(lambda t: jnp.sum(jnp.asarray(w) * jnp.exp(
        jseg(t, jnp.asarray(s.numpy()), "xla"))), x, v)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_transmittance_gradgradcheck():
    from acn_tpu_torch.nerfs.render import _exclusive_trans

    a = torch.rand(3, 6, dtype=F64, generator=torch.Generator().manual_seed(2))
    a[1, 2] = 1.0
    assert torch.autograd.gradgradcheck(_exclusive_trans, (a.requires_grad_(True),))


def test_cumprod_transmittance_second_derivative_matches_jnp_cumprod():
    from acn_tpu_torch.nerfs.render import _exclusive_trans

    rng = np.random.default_rng(6)
    a = rng.uniform(0.0, 0.9, (3, 7)).astype(np.float32)
    a[1, 2] = 0.999  # a near-opaque sample
    a[2, 3] = 1.0  # an opaque one: 1 − α + 1e-10 = 1e-10, which torch's own
    # cumprod backward divides by (its second derivative there is 0)
    w = rng.normal(size=(3, 7)).astype(np.float32)
    v = rng.normal(size=(3, 7)).astype(np.float32)

    def jtrans(al):
        t = jnp.cumprod(1.0 - al + 1e-10, axis=1)
        return jnp.concatenate([jnp.ones_like(t[:, :1]), t[:, :-1]], axis=1)

    got = _hvp_port(lambda t: (torch.from_numpy(w) * _exclusive_trans(t)).sum(), a, v)
    want = _hvp_jax(lambda t: jnp.sum(jnp.asarray(w) * jtrans(t)), a, v)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", ["transmittance", "trunc_exp"])
def test_first_order_backward_is_torch_autograds_to_the_bit(fn):
    """A backward that builds no graph takes the plain ops' own gradient
    (torch.cumprod's; g·exp(clamp(x)) from the saved output): the same bits
    as autograd over those ops, at an opaque sample and past the clamp."""
    from acn_tpu_torch.nerfs.render import _exclusive_trans

    gen = torch.Generator().manual_seed(9)
    if fn == "transmittance":
        x = torch.rand(16, 96, generator=gen) * 0.9
        x[3, 10], x[5, 0] = 1.0, 0.9999999

        def plain(a):
            t = torch.cumprod(1.0 - a + 1e-10, dim=1)
            return torch.cat([torch.ones_like(t[:, :1]), t[:, :-1]], dim=1)
        port = _exclusive_trans
    else:
        x = torch.randn(16, 96, generator=gen) * 40.0
        port = trunc_exp
    g = torch.randn(x.shape, generator=gen)
    xg = x.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(port(xg), xg, g)
    if fn == "transmittance":
        xg = x.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(plain(xg), xg, g)
    else:
        want = g * torch.exp(torch.clamp(x, -88.0, 88.0))
    assert torch.equal(got, want)


# ------------------------------------------------------------------ the card


@pytest.mark.requires_cuda
def test_scan_second_derivative_on_card_launches_both_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernels run only on the card")
    n = 3 * tseg.TILE + 77
    g = torch.Generator().manual_seed(7)
    x, gy, v = (torch.randn(n, generator=g) for _ in range(3))
    s = _starts(n, seed=8, mean=40)
    out = {}
    for dev in ("cuda", "cpu"):
        before = (tseg.seg_excl_sum_kernel.launches, tseg.seg_excl_rsum_kernel.launches)
        xt = x.to(dev).requires_grad_(True)
        gt = gy.to(dev).requires_grad_(True)
        y = tseg.seg_excl_sum(xt, s.to(dev))
        (gx,) = torch.autograd.grad(y, xt, gt, create_graph=True)
        (gg,) = torch.autograd.grad(gx, gt, v.to(dev))
        after = (tseg.seg_excl_sum_kernel.launches, tseg.seg_excl_rsum_kernel.launches)
        out[dev] = (y.detach().cpu(), gx.detach().cpu(), gg.cpu(),
                    (after[0] - before[0], after[1] - before[1]))
    assert out["cuda"][3] == (2, 1) and out["cpu"][3] == (0, 0)
    for a, b in zip(out["cuda"][:3], out["cpu"][:3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
