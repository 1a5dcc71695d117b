"""The port's segmented exclusive scan (acn_tpu_torch.ops.segscan) against
acn_tpu's: its plain versions, forward and reverse, against the Pallas kernel
in interpret mode and against the XLA associative_scan, forward and
gradient; the CUDA kernels against the plain versions on the card
(``requires_cuda``).

Tolerance: the three forms sum each segment in a different order (sequential,
Hillis–Steele, XLA's tree), so the error of an element is a few ulp of the
largest partial sum of its own segment, ``32·eps32·(|x|-sum of the
element's segment)``, plus rtol 1e-6.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from acn_tpu.ops.segscan import seg_excl_sum

# jitted: one compile per backend, where eager dispatch compiles op by op
jseg = jax.jit(seg_excl_sum, static_argnums=2)
from acn_tpu_torch.ops import segscan as tseg

EPS32 = float(np.finfo(np.float32).eps)


def _case(name, B=None):
    """Edge cases for the kernel's extents (``tseg.TILE`` elements per tile,
    ``tseg.WARP`` per warp, ``tseg.ITEMS`` per thread), of a length B that is
    not a multiple of a tile, a warp or a thread's 16-byte load; returned as
    (x f32 (B,), starts bool (B,))."""
    B = B or globals()["B"]
    T, Wp, I = tseg.TILE, tseg.WARP, tseg.ITEMS
    rng = np.random.default_rng(CASES.index(name))
    x = rng.normal(size=B).astype(np.float32)
    if name == "ragged_length":
        starts = rng.random(B) < 1 / 7
    elif name == "one_segment":  # one segment over every tile
        starts = np.zeros(B, bool)
    elif name == "single_samples":
        starts = np.ones(B, bool)
    elif name == "tile_warp_thread_edges":  # boundaries exactly on the edges
        starts = np.zeros(B, bool)
        starts[::T] = starts[Wp::4 * Wp] = starts[I::2 * Wp + 1] = True
        starts[T - 1::T] = True
    elif name == "opaque_scale":  # ≈ −23 per sample, up to 256 per segment
        starts = np.zeros(B, bool)
        starts[np.cumsum(rng.integers(1, 257, B // 64)).clip(max=B - 1)] = True
        x = (-23.0 + rng.normal(size=B)).astype(np.float32)
    elif name == "padded_tail":  # composite_packed's pad slots: ray-0 segment
        starts = rng.random(B) < 1 / 9
        starts[B - 300] = True
        x[B - 300:] = 0.0
    else:
        raise KeyError(name)
    starts[0] = True
    return x, starts


B = 4 * 1024 + 357  # the CPU parity tests (just over a tile)
B_CARD = 3 * tseg.TILE + 357  # the card tests: full tiles and a ragged tail
CASES = ["ragged_length", "one_segment", "single_samples",
         "tile_warp_thread_edges", "opaque_scale", "padded_tail"]


def _atol(x, starts):
    """Per element: 32 ulp of the |x| sum of the element's own segment."""
    seg = np.cumsum(starts) - 1
    return 32 * EPS32 * np.bincount(seg, np.abs(x))[seg]


def _assert_close(got, want, atol, rtol=1e-6):
    """|got − want| ≤ atol + rtol·|want| element by element (atol an array)."""
    err = np.abs(got - want)
    tol = atol + rtol * np.abs(want)
    i = int(np.argmax(err - tol))
    assert np.all(err <= tol), f"element {i}: |err| {err[i]} > tol {tol[i]}"


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("backend", ["interpret", "xla"])
def test_plain_matches_jax_forward(name, backend):
    x, starts = _case(name)
    want = np.asarray(jseg(jnp.asarray(x), jnp.asarray(starts), backend))
    got = tseg.seg_excl_sum(torch.from_numpy(x), torch.from_numpy(starts))
    _assert_close(got.numpy(), want, _atol(x, starts))


@pytest.mark.parametrize("name", ["ragged_length", "tile_warp_thread_edges",
                                  "padded_tail"])
@pytest.mark.parametrize("backend", ["interpret", "xla"])
def test_plain_matches_jax_gradient(name, backend):
    x, starts = _case(name)
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.asarray(g) * jseg(
        v, jnp.asarray(starts), backend)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (torch.from_numpy(g) * tseg.seg_excl_sum(xt, torch.from_numpy(starts))).sum().backward()
    _assert_close(xt.grad.numpy(), np.asarray(want), _atol(g, starts) * 2)


def test_cpu_tensor_takes_plain_version_and_is_not_counted():
    x, starts = _case("ragged_length")
    before = tseg.seg_excl_sum_kernel.launches
    got = tseg.seg_excl_sum(torch.from_numpy(x), torch.from_numpy(starts))
    want = tseg.seg_excl_sum_plain(torch.from_numpy(x), torch.from_numpy(starts))
    assert torch.equal(got, want)
    assert tseg.seg_excl_sum_kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tseg.seg_excl_sum_kernel(torch.zeros(4), torch.ones(4, dtype=torch.bool))


def _seg_mass(v, starts):
    """Per element: the |v| sum of the element's own segment."""
    seg = np.cumsum(starts) - 1
    return np.bincount(seg, np.abs(v))[seg]


@pytest.mark.parametrize("name,backend", [(n, "xla") for n in CASES] + [
    (n, "interpret") for n in ("ragged_length", "tile_warp_thread_edges")])
def test_reverse_plain_matches_jax_backward(name, backend):
    """seg_excl_rsum_plain(g) is acn_tpu's backward: jax.grad of
    sum(g * seg_excl_sum(x)) in x. Tolerance: 1e-6 of the segment's |g| sum
    (the two sum the segment in different orders) plus rtol 1e-6."""
    x, starts = _case(name)
    g = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.asarray(g) * jseg(
        v, jnp.asarray(starts), backend)))(jnp.asarray(x))
    got = tseg.seg_excl_rsum(torch.from_numpy(g), torch.from_numpy(starts))
    _assert_close(got.numpy(), np.asarray(want), 1e-6 * _seg_mass(g, starts))


@st.composite
def _buffers(draw):
    n = draw(st.integers(1, 300))
    starts = np.array(draw(st.lists(st.booleans(), min_size=n, max_size=n)))
    starts[0] = True
    g = np.array(draw(st.lists(st.floats(-50, 50, width=32), min_size=n,
                               max_size=n)), np.float32)
    return g, starts


@settings(max_examples=60, deadline=None)
@given(_buffers())
def test_reverse_plain_is_flip_scan_flip_and_the_reverse_sum(buf):
    """For any length 1-300 and any set of boundaries: the reverse plain
    version equals the plain scan of the flipped buffer with boundaries at
    segment ends, flipped back (bit for bit), and both equal the sum of the
    later elements of the segment taken in float64."""
    g, starts = buf
    gt, stt = torch.from_numpy(g), torch.from_numpy(starts)
    got = tseg.seg_excl_rsum_plain(gt, stt)
    end = np.append(starts[1:], True)
    flipped = tseg.seg_excl_sum_plain(torch.from_numpy(g[::-1].copy()),
                                      torch.from_numpy(end[::-1].copy()))
    assert torch.equal(got, flipped.flip(0))
    seg = np.cumsum(starts) - 1
    want = np.array([g[i + 1:][seg[i + 1:] == seg[i]].astype(np.float64).sum()
                     for i in range(len(g))])
    _assert_close(got.numpy(), want, 32 * EPS32 * _seg_mass(g, starts))


@settings(max_examples=40, deadline=None)
@given(_buffers())
def test_reverse_is_the_transpose_of_forward(buf):
    """<w, S x> = <S^T w, x> for the scan S and its reverse mode S^T."""
    g, starts = buf
    x = np.random.default_rng(len(g)).normal(size=g.shape).astype(np.float32)
    stt = torch.from_numpy(starts)
    fwd = tseg.seg_excl_sum_plain(torch.from_numpy(x), stt).double()
    rev = tseg.seg_excl_rsum_plain(torch.from_numpy(g), stt).double()
    lhs = float((torch.from_numpy(g).double() * fwd).sum())
    rhs = float((rev * torch.from_numpy(x).double()).sum())
    scale = float(np.abs(g).sum() * np.abs(x).sum())
    assert abs(lhs - rhs) <= 64 * EPS32 * scale + 1e-12


def test_cpu_backward_takes_plain_reverse_and_is_not_counted():
    x, starts = _case("padded_tail")
    g = torch.from_numpy(np.random.default_rng(3).normal(size=x.shape).astype(np.float32))
    before = (tseg.seg_excl_sum_kernel.launches, tseg.seg_excl_rsum_kernel.launches)
    xt = torch.from_numpy(x).requires_grad_(True)
    (g * tseg.seg_excl_sum(xt, torch.from_numpy(starts))).sum().backward()
    assert torch.equal(xt.grad, tseg.seg_excl_rsum_plain(g, torch.from_numpy(starts)))
    assert before == (tseg.seg_excl_sum_kernel.launches,
                      tseg.seg_excl_rsum_kernel.launches)


def _refusals():
    ok_x, ok_s = torch.zeros(8), torch.ones(8, dtype=torch.bool)
    return {
        "x_float64": (ok_x.double(), ok_s, TypeError, "float32"),
        "starts_uint8": (ok_x, ok_s.to(torch.uint8), TypeError, "bool"),
        "x_2d": (ok_x.reshape(2, 4), ok_s.reshape(2, 4), ValueError, "1-D"),
        "length_mismatch": (ok_x, ok_s[:7], ValueError, "matching"),
        "x_strided": (torch.zeros(16)[::2], ok_s, ValueError, "contiguous"),
        "starts_strided": (ok_x, torch.ones(16, dtype=torch.bool)[::2],
                           ValueError, "contiguous"),
        "cpu_tensors": (ok_x, ok_s, ValueError, "CUDA"),
        "two_devices": (ok_x, torch.ones(8, dtype=torch.bool, device="meta"),
                        ValueError, "one CUDA device"),
    }


@pytest.mark.parametrize("kernel", ["seg_excl_sum_kernel", "seg_excl_rsum_kernel"])
@pytest.mark.parametrize("what", sorted(_refusals()))
def test_kernel_wrappers_refuse(kernel, what):
    """The wrappers raise on what the kernel does not take, before they
    build or load anything, and count no launch."""
    x, starts, exc, match = _refusals()[what]
    fn = getattr(tseg, kernel)
    before = fn.launches
    with pytest.raises(exc, match=match):
        fn(x, starts)
    assert fn.launches == before


def _on_card(name, offset=0):
    """(x, starts, g) of a case on the card; with ``offset``, as views that
    many elements into larger buffers (contiguous, not 16-byte aligned)."""
    x, starts = _case(name, B_CARD)
    g = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    pad = lambda a: torch.from_numpy(np.concatenate([np.ones(offset, a.dtype), a]))
    return tuple(pad(a).cuda()[offset:] for a in (x, starts, g)) + (x, starts, g)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    xc, sc, gc, x, starts, g = _on_card(name)
    xc.requires_grad_(True)
    before = (tseg.seg_excl_sum_kernel.launches, tseg.seg_excl_rsum_kernel.launches)
    got = tseg.seg_excl_sum(xc, sc)
    (got * gc).sum().backward()
    torch.cuda.synchronize()
    # one forward launch, and the backward is one launch of the reverse kernel
    assert (tseg.seg_excl_sum_kernel.launches,
            tseg.seg_excl_rsum_kernel.launches) == (before[0] + 1, before[1] + 1)
    xp = torch.from_numpy(x).requires_grad_(True)
    want = tseg.seg_excl_sum(xp, torch.from_numpy(starts))
    (want * torch.from_numpy(g)).sum().backward()
    _assert_close(got.detach().cpu().numpy(), want.detach().numpy(),
                  _atol(x, starts))
    _assert_close(xc.grad.cpu().numpy(), xp.grad.numpy(), _atol(g, starts) * 2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("name", CASES)
def test_reverse_kernel_matches_plain_on_card(name, offset):
    """The reverse kernel against its plain version, on aligned buffers and
    on views 4 and 12 bytes off 16-byte alignment (the scalar path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    xc, sc, gc, x, starts, g = _on_card(name, offset)
    got_r = tseg.seg_excl_rsum_kernel(gc, sc)
    got_f = tseg.seg_excl_sum_kernel(xc, sc)
    torch.cuda.synchronize()
    gt, stt = torch.from_numpy(g), torch.from_numpy(starts)
    _assert_close(got_r.cpu().numpy(), tseg.seg_excl_rsum_plain(gt, stt).numpy(),
                  _atol(g, starts))
    _assert_close(got_f.cpu().numpy(),
                  tseg.seg_excl_sum_plain(torch.from_numpy(x), stt).numpy(),
                  _atol(x, starts))


@pytest.mark.requires_cuda
def test_scans_on_two_streams_use_two_scratch_buffers_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    xc, sc, gc, x, starts, g = _on_card("ragged_length")
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got, scratch = [], []
    for s in streams:
        with torch.cuda.stream(s):
            torch.cuda._sleep(20_000_000)  # both streams hold their scans back
            got.append((tseg.seg_excl_sum_kernel(xc, sc),
                        tseg.seg_excl_rsum_kernel(gc, sc)))
            scratch.append(tseg.scan_scratch(xc.device).data_ptr())
    torch.cuda.synchronize()
    assert scratch[0] != scratch[1]
    stt = torch.from_numpy(starts)
    for f, r in got:
        _assert_close(f.cpu().numpy(), tseg.seg_excl_sum_plain(
            torch.from_numpy(x), stt).numpy(), _atol(x, starts))
        _assert_close(r.cpu().numpy(), tseg.seg_excl_rsum_plain(
            torch.from_numpy(g), stt).numpy(), _atol(g, starts))


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_card_check_tolerance_is_per_segment():
    """chip_smoke's kernel check holds each element to its own segment's
    tolerance: an error in a short segment is caught even when a long
    segment elsewhere in the buffer (the serving pad tail) has a large sum."""
    compare = _chip_smoke().compare
    x, starts = _case("padded_tail")
    x[B - 300:] = 50.0  # a long segment with a large |x| sum
    xt, st = torch.from_numpy(x), torch.from_numpy(starts)
    want = tseg.seg_excl_sum_plain(xt, st)
    assert compare(want.clone(), want, xt, st)["ok"]
    bad = want.clone()
    i = int(np.flatnonzero(starts[:B - 300])[-2]) + 1  # inside a short segment
    bad[i] += 1e-3  # far below 32 ulp of the long segment's sum (≈ 57)
    res = compare(bad, want, xt, st)
    assert not res["ok"] and res["worst_err"] == pytest.approx(1e-3, rel=1e-3)


SMOKE_CASES = ["tiny_1", "tiny_31", "ragged_length", "length_not_multiple_of_4",
               "offset_view", "one_segment", "one_segment_long",
               "single_samples", "tile_warp_thread_edges",
               "boundary_at_tile_last", "boundary_at_tile_first",
               "opaque_scale", "multi_pass_aggregates",
               "one_segment_many_waves", "serving"]


@pytest.fixture(scope="module")
def smoke_cases():
    return {name: (x, s, off)
            for name, x, s, off in _chip_smoke().scan_cases(torch, tseg)}


def test_card_check_lists_the_cases(smoke_cases):
    assert list(smoke_cases) == SMOKE_CASES


@pytest.mark.parametrize("name", SMOKE_CASES)
def test_card_check_cases_are_what_they_say(smoke_cases, name):
    """The buffers chip_smoke scans on the card: float32 / bool of one
    length, a boundary at 0, and the property each case is named for, on
    the built kernel's own tile."""
    x, s, off = smoke_cases[name]
    T = tseg.TILE
    n = x.numel()
    assert x.dtype == torch.float32 and s.dtype == torch.bool
    assert s.shape == x.shape and bool(s[0])
    at = set(np.flatnonzero(s.numpy()).tolist())
    if name == "length_not_multiple_of_4":
        assert n % 4 != 0 and n % 16 != 0 and n > T
    elif name == "ragged_length":
        assert n % T != 0 and n > T
    elif name == "offset_view":
        assert off % 4 != 0 and n > T
    elif name.startswith("one_segment"):
        tiles = {"one_segment": 1, "one_segment_long": 32,
                 "one_segment_many_waves": 132 * 4}[name]
        assert at == {0} and n > tiles * T
    elif name == "single_samples":
        assert len(at) == n
    elif name == "boundary_at_tile_last":
        assert at == {0} | set(range(T - 1, n, T))
    elif name == "boundary_at_tile_first":
        assert at == set(range(0, n, T))
    elif name == "tile_warp_thread_edges":
        assert {T - 1, T, tseg.WARP, tseg.ITEMS} <= at
    elif name == "multi_pass_aggregates":
        assert n // T > 132 * 4  # more blocks than the card holds at once
    elif name in ("opaque_scale", "serving"):
        assert n == 983_040
        lens = np.diff(np.flatnonzero(np.append(s.numpy(), True)))
        if name == "serving":  # rays, then the pad tail: one long segment
            assert lens[-1] > 32 * T and lens[:-1].max() < 64
        else:
            assert lens.max() <= 256 + 64 and float(x.mean()) < -20
