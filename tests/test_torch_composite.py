"""The packed composite (acn_tpu_torch.ops.composite): its plain version
against acn_tpu's ``composite_packed`` (jitted, as
``tests/test_torch_march_render.py`` runs it) on hand-made layouts
(``ops/composite_bench.py``: rays with no samples, rays of 256 and 600
samples, the ray overflow cuts at B and the rays dropped whole after it, a
pad tail, N = 1, a ragged B, unaligned strided views, 300 rays of 0 to 3
samples), with and without a background, alpha threshold 0 and 0.05, with
and without the stats; the plain backward against ``jax.vjp`` of it (jitted)
with NaN in the pad slots' densities and colours, on rgb's
cotangent alone and on rgb's, depth's and acc's together; the autograd
``Function`` against torch's autograd of the plain composition, and its
``create_graph`` route's second derivative against JAX's grad of grad; the
dispatch rule of ``nerfs.render.composite_packed``; the CUDA kernels against
the plain versions on the card (``requires_cuda``).

Tolerances. Forward (``tests/test_torch_march_render.py``'s): the
composites go through exp / log and segment sums in another order than
XLA's, so rgb and acc (values in [0, 1]) within atol 1e-5, depths within
rtol 1e-5, wmax and went within rtol and atol 1e-5 (``composite_bench.TOL``:
rtol and atol 1e-5 on every output). Backward (``GRAD_RTOL``,
``GRAD_ATOL``, ``composite_bench.GRAD_TOL``): each gradient within rtol
1e-5 and an atol of 1e-5 of the array's largest magnitude: its terms go
through the same exp / log and two scans in another order, and ∂α's two
terms can cancel; the largest difference from jitted JAX on these layouts
is 2e-6 of that magnitude, and the plain float32 version lies within 7.2e-7
of it from a float64 evaluation of the same formulas, around which the
kernel is held on the card. The second derivative (products of reciprocals of
1 − α) within rtol 1e-4. The kernels sum each ray in their own fixed order:
two launches give the same bits.
"""

import functools
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
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5  # the atol relative to the array's largest magnitude
COTANGENTS = ("rgb", "all")  # rgb's alone; rgb's, depth's and acc's


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
        elif name == "short_rays":
            assert N == 300 and counts.max() <= 3 and (counts == 1).sum() >= 43
            assert (counts == 0).sum() > 30 and B - n_real == 40


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
    recorded (with the stats, the default)."""
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


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_takes_case_by_case(grad, with_stats, device, dtype):
    """float32 CUDA tensors take the kernels unless a gradient is recorded
    with the stats asked for; a CPU tensor or another type never does."""
    s = {"t0_b": _like(device), "t1_b": _like(device)}
    with torch.set_grad_enabled(grad):
        got = comp.takes(_like(device, dtype), _like(device), s, with_stats)
    assert got == (device == "cuda" and dtype == torch.float32 and not (grad and with_stats))


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
    # backward: 24 + 16 B a real sample, 16 + 1 B a pad slot, 8 + 24 B a
    # ray and 24 more with a background
    assert comp.bytes_moved_backward(100, 130, 10, True) == 4000 + 510 + 560
    assert comp.bytes_moved_backward(100, 100, 10, False) == 4000 + 320


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


# ============================================================ the backward


def _cotangents(N: int, which: str, seed: int = 0) -> tuple:
    """(g_rgb, g_depth, g_acc) as numpy float32; ``which`` "rgb": depth's
    and acc's are zero (None for the port)."""
    rng = np.random.default_rng(seed + N)
    g = rng.standard_normal((N, 3)).astype(np.float32)
    if which == "rgb":
        return g, np.zeros(N, np.float32), np.zeros(N, np.float32)
    return g, rng.standard_normal(N).astype(np.float32), rng.standard_normal(N).astype(np.float32)


def _port_cotangents(g: tuple, which: str, device="cpu", dtype=torch.float32) -> tuple:
    t = lambda x: torch.from_numpy(x).to(device=device, dtype=dtype)
    return (t(g[0]), None, None) if which == "rgb" else tuple(t(x) for x in g)


def _nan_pads(c: dict) -> dict:
    """``c`` with NaN in the densities and colours of every slot that is not
    real (the pad tail): no gradient may reach them or leave them."""
    real = c["samples"]["slot_real"]
    sigma, rgb = c["sigma"].copy(), c["rgb"].copy()
    sigma[~real], rgb[~real] = np.nan, np.nan
    return {**c, "sigma": sigma, "rgb": rgb}


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jvjp(sig, rgb, b, samples, N, thre, g):
    def f(sig, rgb, b):
        return jrender.composite_packed(sig, rgb, samples, N, b, thre)[:3]

    out, vjp = jax.vjp(f, sig, rgb, b)
    return out, vjp(g)


def _jax_vjp(c: dict, thre: float, bg: bool, g: tuple) -> tuple:
    """acn_tpu's (rgb, depth, acc) of the layout and its vjp at ``g``
    (σ, rgb, bg), jitted; without a background a zero one (rgb + (1 −
    acc)·0 is rgb, and the gradients of σ and rgb are the same)."""
    js = {k: jnp.asarray(v) for k, v in c["samples"].items()}
    b = c["bg"] if bg else np.zeros_like(c["bg"])
    return jax.device_get(_jvjp(jnp.asarray(c["sigma"]), jnp.asarray(c["rgb"]), jnp.asarray(b),
                                js, c["N"], thre, tuple(jnp.asarray(x) for x in g)))


@pytest.fixture(scope="module")
def jax_grads(cases):
    return {(name, thre, bg, which): _jax_vjp(_nan_pads(c), thre, bg,
                                              _cotangents(c["N"], which))
            for name, c in cases.items() for thre in THRES for bg in (True, False)
            for which in COTANGENTS}


def _assert_grads(got, want, what="") -> None:
    for k, (a, b) in enumerate(zip(got, want)):
        a = a.detach().cpu().double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.detach().cpu().double().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert np.isfinite(a).all(), f"{what} gradient {k} not finite"
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * max(float(np.abs(b).max(initial=0)), 1e-30),
                                   err_msg=f"{what} gradient {k}")


@pytest.mark.parametrize("which", COTANGENTS)
@pytest.mark.parametrize("bg", [True, False])
@pytest.mark.parametrize("thre", THRES)
@pytest.mark.parametrize("name", cb.LAYOUTS)
def test_backward_plain_matches_jax_vjp(cases, jax_grads, name, thre, bg, which):
    """∂σ, ∂rgb (and ∂bg with a background) of the plain backward against
    ``jax.vjp`` of acn_tpu's composite, with NaN in the pad slots; every
    slot that is not real gets 0."""
    c = _nan_pads(cases[name])
    out, want = jax_grads[name, thre, bg, which]
    sig, rgb, s, N, bgt = cb.tensors(c)
    got = comp.composite_backward_plain(
        sig, rgb, s, N, bgt if bg else None, thre, torch.tensor(np.asarray(out[2])),
        *_port_cotangents(_cotangents(N, which), which))
    assert (got[2] is not None) == bg
    _assert_grads(got[:3] if bg else got[:2], want[:3] if bg else want[:2], name)
    pads = ~s["slot_real"]
    assert (got[0][pads] == 0).all() and (got[1][pads] == 0).all()


def _linear_loss(out, g) -> torch.Tensor:
    return sum((o * gi).sum() for o, gi in zip(out[:3], g) if gi is not None)


@pytest.mark.parametrize("bg", [True, False])
@pytest.mark.parametrize("thre", THRES)
@pytest.mark.parametrize("name", cb.LAYOUTS)
def test_autograd_function_matches_plain_autograd(cases, name, thre, bg):
    """``composite_autograd``'s forward equals the plain composition's and
    its gradient torch's autograd of it (on the CPU both run the plain
    versions; no kernel is counted and no graph is rebuilt)."""
    c = cases[name]
    g = _port_cotangents(_cotangents(c["N"], "all"), "all")
    grads = []
    before = (comp.launch_counts(), comp.CompositePacked.graph_backwards)
    for fn in (comp.composite_autograd, functools.partial(comp.composite_plain,
                                                          with_stats=False)):
        sig, rgb, s, N, bgt = cb.tensors(c)
        ins = [sig.clone().requires_grad_(), rgb.clone().requires_grad_()]
        if bg:
            ins.append(bgt.clone().requires_grad_())
        out = fn(ins[0], ins[1], s, N, ins[2] if bg else None, thre)
        grads.append((out[:3], torch.autograd.grad(_linear_loss(out, g), ins)))
    (fo, fg), (po, pg) = grads
    assert all(torch.equal(a, b) for a, b in zip(fo, po))
    _assert_grads(fg, pg, name)
    assert (comp.launch_counts(), comp.CompositePacked.graph_backwards) == before


def _tiny_layout() -> dict:
    """Five rays of 3, 0, 4, 1 and 2 samples and a pad tail (B 14), smooth
    densities (one exactly 0), for second derivatives."""
    rng = np.random.default_rng(7)
    counts = np.array([3, 0, 4, 1, 2], np.int64)
    B, N = 14, 5
    n = int(counts.sum())
    rid = np.zeros(B, np.int64)
    rid[:n] = np.repeat(np.arange(N), counts)
    t0 = np.zeros(B, np.float32)
    t0[:n] = np.concatenate([np.sort(rng.uniform(0.5, 3.0, k)) for k in counts])
    t1 = t0 + rng.uniform(0.01, 0.1, B).astype(np.float32)
    sigma = rng.uniform(0.5, 12.0, B).astype(np.float32)
    sigma[5] = 0.0
    return {"sigma": sigma, "rgb": rng.random((B, 3)).astype(np.float32),
            "bg": rng.random((N, 3)).astype(np.float32), "N": N, "B": B, "n_real": n,
            "counts": counts,
            "samples": {"t0_b": t0, "t1_b": t1.astype(np.float32), "ray_id": rid,
                        "slot_real": np.arange(B) < n,
                        "ray_start": np.cumsum(counts) - counts}}


def test_create_graph_route_matches_jax_second_derivative():
    """Under ``create_graph`` the Function's backward is the plain
    composition's VJP, differentiable again: a Hessian-vector product of a
    linear loss of (rgb, depth, acc) in (σ, rgb, bg) against JAX's grad of
    grad, at alpha threshold 0.05; the route is counted, no kernel is."""
    c = _tiny_layout()
    N, thre = c["N"], 0.05
    rng = np.random.default_rng(3)
    g = _cotangents(N, "all", seed=1)
    v = [rng.standard_normal(np.shape(c[k])).astype(np.float32) for k in ("sigma", "rgb", "bg")]
    js = {k: jnp.asarray(x) for k, x in c["samples"].items()}

    def jloss(sig, rgb, b):
        out = jrender.composite_packed(sig, rgb, js, N, b, thre)
        return sum(jnp.vdot(o, jnp.asarray(gi)) for o, gi in zip(out[:3], g))

    jargs = tuple(jnp.asarray(c[k]) for k in ("sigma", "rgb", "bg"))
    want = jax.device_get(jax.jit(jax.grad(lambda *a: sum(
        jnp.vdot(d, jnp.asarray(vi)) for d, vi in zip(jax.grad(jloss, argnums=(0, 1, 2))(*a), v)),
        argnums=(0, 1, 2)))(*jargs))

    sig, rgb, s, N, bgt = cb.tensors(c)
    ins = [t.clone().requires_grad_() for t in (sig, rgb, bgt)]
    before = (comp.launch_counts(), comp.CompositePacked.graph_backwards)
    out = comp.composite_autograd(ins[0], ins[1], s, N, ins[2], thre)
    first = torch.autograd.grad(_linear_loss(out, _port_cotangents(g, "all")), ins,
                                create_graph=True)
    got = torch.autograd.grad(sum((d * torch.from_numpy(vi)).sum()
                                  for d, vi in zip(first, v)), ins)
    assert comp.launch_counts() == before[0]
    assert comp.CompositePacked.graph_backwards == before[1] + 1
    for k, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6 * np.abs(b).max(),
                                   err_msg=f"second derivative {k}")
        assert np.abs(b).max() > 0


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
    """On the card: under no_grad one launch of the forward kernel and no
    scan; under autograd without the stats one forward and, in the
    backward, one backward launch and no scan; under autograd with the
    stats the composition (one forward and, in the backward, one reverse
    scan) and no composite launch."""
    _card()
    sig, rgb, s, N, bg = cb.tensors(cases["ragged"], "cuda")
    counts = lambda: (*comp.launch_counts(), tseg.seg_excl_sum_kernel.launches,
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
    trender.composite_packed(sig, rgb, s, N, bg_rgb=bg)[0].sum().backward()
    torch.cuda.synchronize()
    c3 = counts()
    assert tuple(b - a for a, b in zip(c0, c1)) == (1, 0, 0, 0)
    assert tuple(b - a for a, b in zip(c1, c2)) == (1, 1, 0, 0)
    assert tuple(b - a for a, b in zip(c2, c3)) == (0, 0, 1, 1)
    with torch.no_grad():
        with pytest.raises(ValueError, match="ray_start"):
            comp.composite_kernel(sig, rgb, {**s, "ray_start": s["ray_start"].int()}, N)
    with pytest.raises(ValueError, match="acc"):
        comp.composite_backward_kernel(sig.detach(), rgb, s, N, bg, 0.0,
                                       torch.zeros(N + 1, device="cuda"), None)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("which", COTANGENTS)
@pytest.mark.parametrize("bg", [True, False])
@pytest.mark.parametrize("thre", THRES)
@pytest.mark.parametrize("name", cb.LAYOUTS)
def test_backward_kernel_matches_plain_on_card(cases, name, thre, bg, which):
    """The backward kernel against the plain backward in float64 (the
    module docstring's tolerance, which the plain float32 version meets
    too), a second launch bit-equal, and NaN in every pad slot's σ, rgb,
    t0 and t1 changing no bit: those slots are never read."""
    _card()
    c = cases[name]
    sig, rgb, s, N, bgt = cb.tensors(c, "cuda")
    b = bgt if bg else None
    acc = comp.composite_kernel(sig, rgb, s, N, b, thre, False)[2]
    g = _port_cotangents(_cotangents(N, which), which, "cuda")
    before = comp.launch_counts()
    got = comp.composite_backward_kernel(sig, rgb, s, N, b, thre, acc, *g)
    again = comp.composite_backward_kernel(sig, rgb, s, N, b, thre, acc, *g)
    torch.cuda.synchronize()
    assert comp.launch_counts() == (before[0], before[1] + 2)
    want = cb.backward_f64(sig, rgb, s, N, b, thre, acc, g)
    assert (got[2] is not None) == bg
    _assert_grads([x for x in got if x is not None], [x for x in want if x is not None], name)
    plain = comp.composite_backward_plain(sig, rgb, s, N, b, thre, acc, *g)
    _assert_grads([x for x in plain if x is not None], [x for x in want if x is not None],
                  "plain float32")
    assert all(torch.equal(x, y) for x, y in zip(got, again) if x is not None)
    real = s["slot_real"]
    nan = float("nan")
    dirty = {**s, "t0_b": s["t0_b"].clone().masked_fill_(~real, nan),
             "t1_b": s["t1_b"].clone().masked_fill_(~real, nan)}
    got_nan = comp.composite_backward_kernel(
        sig.clone().masked_fill_(~real, nan), rgb.clone().masked_fill_(~real[:, None], nan),
        dirty, N, b, thre, acc, *g)
    assert all(torch.equal(x, y) for x, y in zip(got, got_nan) if x is not None)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bg", [True, False])
@pytest.mark.parametrize("name", cb.LAYOUTS)
def test_autograd_function_on_card(cases, name, bg):
    """``composite_autograd`` on the card, σ and rgb the columns of one
    (B, 4) buffer as the network gives them: one forward and one backward
    launch, no scan, the forward the kernel's and the gradient within the
    module docstring's tolerance of the plain backward in float64; under
    ``create_graph`` the route is counted and its second derivative equals
    the plain composition's on the card."""
    _card()
    c = cases[name]
    sig, rgb, s, N, bgt = cb.tensors(c, "cuda")
    buf = torch.cat([rgb, sig[:, None]], dim=1).requires_grad_()
    b = bgt.clone().requires_grad_() if bg else None
    g = _port_cotangents(_cotangents(N, "all"), "all", "cuda")
    counts = lambda: (*comp.launch_counts(), tseg.seg_excl_sum_kernel.launches,
                      tseg.seg_excl_rsum_kernel.launches)
    c0 = counts()
    out = comp.composite_autograd(buf[:, 3], buf[:, :3], s, N, b, 0.05)
    ins = [buf] + ([b] if bg else [])
    got = torch.autograd.grad(_linear_loss(out, g), ins)
    torch.cuda.synchronize()
    assert tuple(y - x for x, y in zip(c0, counts())) == (1, 1, 0, 0)
    with torch.no_grad():
        fwd = comp.composite_kernel(buf[:, 3], buf[:, :3], s, N, b, 0.05, False)
    assert all(torch.equal(x, y) for x, y in zip(out[:3], fwd[:3]))
    want = cb.backward_f64(buf[:, 3].detach(), buf[:, :3].detach(), s, N,
                           None if b is None else b.detach(), 0.05, out[2].detach(), g)
    _assert_grads([got[0][:, 3], got[0][:, :3]] + ([got[1]] if bg else []),
                  [x for x in want if x is not None], name)
    # create_graph: the plain composition's VJP, differentiated again
    routes = comp.CompositePacked.graph_backwards
    second = []
    for fn in (comp.composite_autograd, functools.partial(comp.composite_plain,
                                                          with_stats=False)):
        x = buf.detach().clone().requires_grad_()
        out = fn(x[:, 3], x[:, :3], s, N, None, 0.05)
        d, = torch.autograd.grad(_linear_loss(out, g), (x,), create_graph=True)
        second.append(torch.autograd.grad((d * d).sum(), (x,))[0])
    assert comp.CompositePacked.graph_backwards == routes + 1
    _assert_grads([second[0]], [second[1]], f"{name} second derivative")


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
