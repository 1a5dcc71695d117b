"""The packed composite (acn_tpu_torch.ops.composite): its plain version
against acn_tpu's ``composite_packed`` (jitted, as
``tests/test_torch_march_render.py`` runs it) on hand-made layouts
(``ops/composite_bench.py``: rays with no samples, rays of 256 and 600
samples, the ray overflow cuts at B and the rays dropped whole after it, a
pad tail, N = 1, a ragged B, unaligned strided views), with and without a
background, alpha threshold 0 and 0.05, with and without the stats; the
dispatch rule of ``nerfs.render.composite_packed``; the CUDA kernel against
the plain version on the card (``requires_cuda``).

Tolerances (``tests/test_torch_march_render.py``'s): the composites go
through exp / log and segment sums in another order than XLA's, so rgb and
acc (values in [0, 1]) within atol 1e-5, depths within rtol 1e-5, wmax and
went within rtol and atol 1e-5 (``composite_bench.TOL``: rtol and atol 1e-5
on every output). The kernel sums each ray in its own fixed order: two
launches give the same bits.
"""

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.nerfs import render as jrender
from acn_tpu_torch.nerfs import render as trender
from acn_tpu_torch.ops import composite as comp
from acn_tpu_torch.ops import composite_bench as cb
from acn_tpu_torch.ops import segscan as tseg

THRES = (0.0, 0.05)
_jcomposite = jax.jit(jrender.composite_packed, static_argnums=(3, 5))


@pytest.fixture(scope="module")
def cases():
    return cb.cases()


@pytest.fixture(scope="module")
def jax_refs(cases):
    """acn_tpu's composite of every layout and threshold, with the
    background given (a zero background for the cases without one: rgb +
    (1 − acc)·0 is rgb)."""
    out = {}
    for name, c in cases.items():
        js = {k: jnp.asarray(v) for k, v in c["samples"].items()}
        for thre in THRES:
            for bg in (True, False):
                b = c["bg"] if bg else np.zeros_like(c["bg"])
                out[name, thre, bg] = jax.device_get(_jcomposite(
                    jnp.asarray(c["sigma"]), jnp.asarray(c["rgb"]), js, c["N"],
                    jnp.asarray(b), thre))
    return out


def _assert_matches(got, want, with_stats=True):
    rgb, depth, acc, extras = got
    np.testing.assert_allclose(rgb.numpy(), want[0], rtol=0, atol=1e-5, err_msg="rgb")
    np.testing.assert_allclose(depth.numpy(), want[1], rtol=1e-5, atol=1e-6, err_msg="depth")
    np.testing.assert_allclose(acc.numpy(), want[2], rtol=0, atol=1e-5, err_msg="acc")
    if not with_stats:
        assert extras == {}
        return
    for k in ("wmax", "went"):
        np.testing.assert_allclose(extras[k].numpy(), want[3][k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("with_stats", [True, False])
@pytest.mark.parametrize("bg", [True, False])
@pytest.mark.parametrize("thre", THRES)
@pytest.mark.parametrize("name", cb.LAYOUTS)
def test_plain_matches_jax(cases, jax_refs, name, thre, bg, with_stats):
    sig, rgb, s, N, bgt = cb.tensors(cases[name])
    got = comp.composite_plain(sig, rgb, s, N, bgt if bg else None, thre, with_stats)
    _assert_matches(got, jax_refs[name, thre, bg], with_stats)


NAN_RAYS = (1, 3)  # long_rays: 33 samples, and 600 (the NaN in a late warp step)


def _nan_density(c: dict) -> dict:
    """``c`` with σ NaN at the middle real slot of each ray of ``NAN_RAYS``
    (a diverged field): those rays' outputs are NaN, every other ray's are
    finite."""
    sigma = c["sigma"].copy()
    for r in NAN_RAYS:
        sigma[c["samples"]["ray_start"][r] + c["counts"][r] // 2] = np.nan
    return {**c, "sigma": sigma}


def _assert_nan_only_in(got, n_rays):
    bad = np.zeros(n_rays, bool)
    bad[list(NAN_RAYS)] = True
    for a in cb.outputs(got):
        a = a.cpu().numpy()
        nan = np.isnan(a) if a.ndim == 1 else np.isnan(a).all(axis=1)
        assert (nan == bad).all()
        assert np.isfinite(a[~bad]).all()


def test_plain_keeps_a_nan_density_as_jax_does(cases):
    """A NaN σ in a real slot makes its ray's rgb, depth, acc, wmax and went
    NaN in both packages (XLA's segment max and ``scatter_reduce_``'s
    "amax" keep the NaN), and no other ray's."""
    c = _nan_density(cases["long_rays"])
    js = {k: jnp.asarray(v) for k, v in c["samples"].items()}
    want = jax.device_get(_jcomposite(jnp.asarray(c["sigma"]), jnp.asarray(c["rgb"]), js,
                                      c["N"], jnp.asarray(c["bg"]), 0.0))
    sig, rgb, s, N, bgt = cb.tensors(c)
    got = comp.composite_plain(sig, rgb, s, N, bgt, 0.0)
    _assert_matches(got, want)  # assert_allclose holds NaN equal to NaN
    _assert_nan_only_in(got, N)


def test_layouts_are_what_they_say(cases):
    """Each layout as ``march_rays_budget`` writes one (real slots a prefix,
    ray-major from ``ray_start``, pad slots ray 0 at ray 0's first bin) and
    holding the edge it is named for."""
    for name, c in cases.items():
        s, counts, B, N = c["samples"], c["counts"], c["B"], c["N"]
        n_real = min(int(counts.sum()), B)
        assert c["n_real"] == n_real and s["slot_real"].sum() == n_real
        assert s["slot_real"][:n_real].all() and s["ray_start"].dtype == np.int64
        np.testing.assert_array_equal(s["ray_start"], np.cumsum(counts) - counts)
        np.testing.assert_array_equal(s["ray_id"][:n_real],
                                      np.repeat(np.arange(N), counts)[:n_real])
        assert (s["ray_id"][n_real:] == 0).all()
        if n_real < B:
            assert (s["t0_b"][n_real:] == s["t0_b"][n_real]).all()
        starts = s["ray_start"]
        if name == "empty_rays":
            assert counts[0] == counts[-1] == 0 and (counts == 0).sum() > 5 and n_real < B
        elif name == "long_rays":
            assert counts.max() >= 600 and (counts >= 256).sum() >= 2
        elif name == "overflow":
            cut = int(np.flatnonzero(starts < B)[-1])
            assert starts[cut] + counts[cut] > B and (starts[cut + 1:] >= B).sum() >= 2
            assert n_real == B
        elif name in ("pad_tail", "pad_after_ray0"):
            assert B - n_real > 32
            assert (s["ray_id"][n_real - 1] == 0) == (name == "pad_after_ray0")
        elif name == "one_ray":
            assert N == 1 and 32 < n_real < B
        elif name in ("ragged", "views"):
            assert all(B % k for k in (2, 3, 4, 8, 32))


def test_views_are_unaligned_strided_views(cases):
    sig, rgb, s, N, bg = cb.tensors(cases["views"])
    assert sig.stride() == (4,) and rgb.stride() == (4, 1) and bg.stride() == (4, 1)
    assert s["t0_b"].storage_offset() == 1 and s["t1_b"].storage_offset() == 1
    assert sig.storage_offset() % 4 == 3  # the σ column of the buffer's second row


def test_cpu_tensor_takes_plain_version_and_is_not_counted(cases):
    sig, rgb, s, N, bg = cb.tensors(cases["ragged"])
    before = (comp.composite_kernel.launches, tseg.seg_excl_sum_kernel.launches)
    with torch.no_grad():
        assert not comp.takes(sig, rgb, s)
        got = trender.composite_packed(sig, rgb, s, N, bg_rgb=bg, alpha_thre=0.05)
    want = comp.composite_plain(sig, rgb, s, N, bg, 0.05)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert all(torch.equal(got[3][k], want[3][k]) for k in ("wmax", "went"))
    assert (comp.composite_kernel.launches, tseg.seg_excl_sum_kernel.launches) == before


def test_kernel_wrapper_refuses_cpu_tensors(cases):
    sig, rgb, s, N, bg = cb.tensors(cases["one_ray"])
    with pytest.raises(ValueError, match="CUDA"):
        comp.composite_kernel(sig, rgb, s, N, bg)


def _like(device, dtype=torch.float32):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype)


def test_takes_is_float32_cuda_without_a_gradient():
    """The rule on stand-ins for tensors (this host has no card): every one
    of σ, rgb, t0 and t1 float32 on a CUDA device, and no gradient being
    recorded."""
    def rule(sig=("cuda", torch.float32), t1=("cuda", torch.float32)):
        s = {"t0_b": _like("cuda"), "t1_b": _like(*t1)}
        return comp.takes(_like(*sig), _like("cuda"), s)

    with torch.no_grad():
        assert rule()
        assert not rule(sig=("cpu", torch.float32))
        assert not rule(sig=("cuda", torch.bfloat16))
        assert not rule(t1=("cuda", torch.float64))
    with torch.enable_grad():
        assert not rule()


def test_recording_a_gradient_takes_the_composition(cases):
    """Under autograd composite_packed is the plain composition, with its
    gradient (the training loss's path)."""
    sig, rgb, s, N, bg = cb.tensors(cases["ragged"])
    sig.requires_grad_(True)
    with torch.enable_grad():
        got = trender.composite_packed(sig, rgb, s, N, bg_rgb=bg, with_stats=False)
        got[0].sum().backward()
    assert got[0].grad_fn is not None and got[3] == {}
    assert torch.isfinite(sig.grad).all() and sig.grad.abs().sum() > 0


def test_bytes_moved():
    # 24 B a real sample; 8 + 12 + 28 B a ray with a background and the stats
    assert comp.bytes_moved(100, 10, True) == 2400 + 480
    assert comp.bytes_moved(100, 10, False, with_stats=False) == 2400 + 280
    B, N = 983_040, 30_720
    assert abs(comp.bytes_moved(B, N, True) / 3.35e12 * 1e6 - 7.48) < 0.01


def test_library_lengths_sum_to_the_buffer(cases):
    """The library chain's segment lengths: each ray's real samples (0 for a
    ray dropped whole, the cut ray's part before B), then the rest of B."""
    for name, c in cases.items():
        _, _, s, N, _ = cb.tensors(c)
        lens = cb.lengths(s, N).numpy()
        want = np.clip(np.minimum(c["samples"]["ray_start"] + c["counts"], c["B"])
                       - c["samples"]["ray_start"], 0, None)
        np.testing.assert_array_equal(lens[:N], want, err_msg=name)
        assert lens.sum() == c["B"] and lens[N] == c["B"] - c["n_real"]


# ============================================================ on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")


def _plain_cpu(c, thre, bg, with_stats):
    sig, rgb, s, N, bgt = cb.tensors(c, views=False)
    return comp.composite_plain(sig, rgb, s, N, bgt if bg else None, thre, with_stats)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("with_stats", [True, False])
@pytest.mark.parametrize("bg", [True, False])
@pytest.mark.parametrize("thre", THRES)
@pytest.mark.parametrize("name", cb.LAYOUTS)
def test_kernel_matches_plain_on_card(cases, name, thre, bg, with_stats):
    _card()
    c = cases[name]
    sig, rgb, s, N, bgt = cb.tensors(c, "cuda")
    before = comp.composite_kernel.launches
    got = comp.composite_kernel(sig, rgb, s, N, bgt if bg else None, thre, with_stats)
    again = comp.composite_kernel(sig, rgb, s, N, bgt if bg else None, thre, with_stats)
    torch.cuda.synchronize()
    assert comp.composite_kernel.launches == before + 2
    want = _plain_cpu(c, thre, bg, with_stats)
    cpu = lambda o: (o[0].cpu(), o[1].cpu(), o[2].cpu(), {k: v.cpu() for k, v in o[3].items()})
    _assert_matches(cpu(got), (want[0].numpy(), want[1].numpy(), want[2].numpy(),
                               {k: v.numpy() for k, v in want[3].items()}), with_stats)
    # no atomics: every sum in one fixed order, so a second launch is bit-equal
    assert all(torch.equal(a, b) for a, b in zip(cb.outputs(got), cb.outputs(again)))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["pad_tail", "pad_after_ray0", "long_rays", "empty_rays"])
def test_kernel_never_reads_pad_slots_on_card(cases, name):
    """NaN in σ, rgb, t0 and t1 of every slot past the real ones changes
    nothing: those slots are never read."""
    _card()
    c = cases[name]
    sig, rgb, s, N, bg = cb.tensors(c, "cuda")
    want = comp.composite_kernel(sig, rgb, s, N, bg)
    n = c["n_real"]
    ends = np.minimum(c["samples"]["ray_start"] + c["counts"], c["B"])
    dead = np.ones(c["B"], bool)
    for r in range(N):
        dead[c["samples"]["ray_start"][r]:ends[r]] = False
    assert dead[n:].all()
    d = torch.from_numpy(dead).cuda()
    sig, rgb = sig.clone(), rgb.clone()
    sig[d], rgb[d] = float("nan"), float("nan")
    s = {**s, "t0_b": s["t0_b"].clone(), "t1_b": s["t1_b"].clone()}
    s["t0_b"][d], s["t1_b"][d] = float("nan"), float("nan")
    got = comp.composite_kernel(sig, rgb, s, N, bg)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(cb.outputs(got), cb.outputs(want)))


@pytest.mark.requires_cuda
def test_kernel_keeps_a_nan_density_on_card(cases):
    """A NaN σ in a real slot: the kernel's outputs equal the plain
    version's, NaN in its ray's rgb, depth, acc, wmax and went and in no
    other ray (its max keeps a NaN weight)."""
    _card()
    c = _nan_density(cases["long_rays"])
    sig, rgb, s, N, bgt = cb.tensors(c, "cuda")
    got = comp.composite_kernel(sig, rgb, s, N, bgt)
    torch.cuda.synchronize()
    want = _plain_cpu(c, 0.0, True, True)
    cpu = lambda o: (o[0].cpu(), o[1].cpu(), o[2].cpu(), {k: v.cpu() for k, v in o[3].items()})
    _assert_matches(cpu(got), (want[0].numpy(), want[1].numpy(), want[2].numpy(),
                               {k: v.numpy() for k, v in want[3].items()}))
    _assert_nan_only_in(got, N)


@pytest.mark.requires_cuda
def test_composite_packed_dispatch_on_card(cases):
    """On the card: under no_grad one launch of the composite kernel and no
    scan; under autograd the composition (one forward and, in the
    backward, one reverse scan) and no composite launch."""
    _card()
    sig, rgb, s, N, bg = cb.tensors(cases["ragged"], "cuda")
    counts = lambda: (comp.composite_kernel.launches, tseg.seg_excl_sum_kernel.launches,
                      tseg.seg_excl_rsum_kernel.launches)
    c0 = counts()
    with torch.no_grad():
        assert comp.takes(sig, rgb, s)
        trender.composite_packed(sig, rgb, s, N, bg_rgb=bg)
    c1 = counts()
    sig = sig.clone().requires_grad_(True)
    trender.composite_packed(sig, rgb, s, N, bg_rgb=bg, with_stats=False)[0].sum().backward()
    torch.cuda.synchronize()
    c2 = counts()
    assert tuple(b - a for a, b in zip(c0, c1)) == (1, 0, 0)
    assert tuple(b - a for a, b in zip(c1, c2)) == (0, 1, 1)
    with torch.no_grad():
        with pytest.raises(ValueError, match="ray_start"):
            comp.composite_kernel(sig, rgb, {**s, "ray_start": s["ray_start"].int()}, N)


# ============================================================ chip_smoke's cases


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE_CASES = list(cb.LAYOUTS) + ["dense_chunk", "routed_chunk"]


def test_card_check_cases_are_what_they_say(cases):
    """chip_smoke's composite check runs every layout as this file builds it
    (the same seed) and the two real chunks at their sizes; here the
    layouts are built on the CPU and the chunks named by their sizes."""
    smoke = _chip_smoke()
    got = smoke.composite_cases(torch, "cpu", chunks=False)
    assert list(got) + list(smoke.COMPOSITE_CHUNKS) == SMOKE_CASES
    assert smoke.COMPOSITE_CHUNKS == {"dense_chunk": cb.CHUNKS["dense"],
                                      "routed_chunk": cb.CHUNKS["routed"]}
    assert cb.CHUNKS == {"dense": (30_720, 983_040), "routed": (125_000, 4_000_000)}
    for name, (sig, rgb, s, N, bg) in got.items():
        ref = cb.tensors(cases[name])
        assert N == ref[3] and torch.equal(sig, ref[0]) and torch.equal(rgb, ref[1])
        assert sig.stride() == ref[0].stride() and rgb.stride() == ref[1].stride()
        assert all(torch.equal(s[k], ref[2][k]) for k in s)
    assert cb.TOL == {"rtol": 1e-5, "atol": 1e-5}
