"""The port's eval op with test-time optimization (acn_tpu_torch.pipelines.
online_stage.runtime_adapt, nerfs.losses.ssim, models.lpips and
runner.op_eval) against acn_tpu's.

* One ``make_tto_step`` step of each package from one converted state
  (the micro scene of ``test_torch_train_step``), JAX's draws replayed
  through the port's ``draws`` function, in the occupancy (strided) render
  with the background MLP or a white background, and the stratified one:
  loss rtol 1e-5; the step's clipped gradient (read from the optimizer's
  first moment, (1 − β1)·g) entry by entry atol 1e-8 / rtol 1e-4 (an
  entry is a float32 sum of terms that cancel; measured 1.2e-9); every
  parameter after the Adam step atol 1e-6 / rtol 1e-4 (as the loop test)
  where its gradient is at least 1e-6. The first Adam step is
  lr·g/(|g| + 1e-8): where |g| is near 1e-8 (the background head's
  gradient in the stratified render is ~1e-11, pure rounding) it turns the
  gradient's rounding into most of the update, so those entries are held
  by their gradient alone (measured: gradients within 7e-9, such updates
  apart by up to 1.9e-5 at lr 2e-3).
* ``runtime_evaluate`` of both packages on one checkpoint, on a
  ``toy.write_dataset_dir`` dataset (2 experts, 2 val views of 24 × 32),
  at ``tto`` 0 and 2 with JAX's draws replayed: each batch's last TTO loss
  rtol 1e-4, and per view PSNR atol 0.05 dB and SSIM atol 2e-3. The frames
  are u8 (``render_image``), and a color may differ by one quantization step
  where it sits on a rounding edge (test_torch_renderer.py); the adapted
  weights differ in their last bits.
* SSIM on random and near-constant images: atol 1e-5 (float32 sums in
  another order), and inside [-1, 1]; LPIPS with the fallback weights, per
  image: rtol 1e-4.
* ``--tto 0,2,0`` through the port's ``main``: the two ``tto=0`` legs equal
  bit for bit (the base weights are restored before each setting).
* The card's tests are in ``test_torch_eval_card.py``, which shares this
  file's micro run.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu import runner as jrunner
from acn_tpu.models import container as jcont
from acn_tpu.models import lpips as jlpips
from acn_tpu.nerfs import losses as jlosses
from acn_tpu.pipelines.online_stage import runtime_adapt as jrt
from acn_tpu.utils import optim as joptim
from acn_tpu.utils.config import parse_args as jparse
from acn_tpu_torch import convert, toy
from acn_tpu_torch import runner as trunner
from acn_tpu_torch.data import dataset as tds
from acn_tpu_torch.data import tasks as ttasks
from acn_tpu_torch.models import container as tcont
from acn_tpu_torch.models import lpips as tlpips
from acn_tpu_torch.models.nn import tree_map
from acn_tpu_torch.nerfs import losses as tlosses
from acn_tpu_torch.pipelines.online_stage import runtime_adapt as trt
from acn_tpu_torch.utils import checkpoint as tck
from acn_tpu_torch.utils import optim as toptim
from acn_tpu_torch.utils.config import parse_args as tparse
from test_torch_eval_card import _eval_argv, _pairs, eval_run  # noqa: F401 (a fixture)
from test_torch_train_step import K, T, make_P, micro_scene, optax_to_port

REPO = Path(__file__).resolve().parent.parent
N_RAYS = 64


# --------------------------------------------------------------- one step


def jax_render_draws(key, use_occ, n, P):
    """The render draws of a JAX TTO step with ``key``: the loss splits it
    into (background, render); the occupancy render splits its key into
    (jitter, phase), the stratified one draws its jitter from it."""
    _, k_render = jax.random.split(key)
    if not use_occ:
        return torch.from_numpy(np.array(jax.random.uniform(
            k_render, (n, int(P.ray_samples)), dtype=jnp.float32)))
    k_jit, k_phase = jax.random.split(k_render)
    u = np.array(jax.random.uniform(k_jit, (n, int(P.occ_s_max)), dtype=jnp.float32))
    phase = np.asarray(jax.random.randint(k_phase, (n,), 0, 1 << 30)).astype(np.int64)
    return torch.from_numpy(u), torch.from_numpy(phase)


@pytest.mark.parametrize("render,bg", [("occ", "mlp"), ("occ", "white"),
                                       ("stratified", "mlp")])
def test_tto_step_matches_jax(render, bg):
    sc = micro_scene(use_bg_nerf=bg == "mlp")
    P = make_P()
    use_occ = render == "occ"
    batch = toy.training_batch(K, T, N_RAYS, 8, seed=4)
    rays, rgbs = batch["support_rays"][0, 0], batch["support_rgbs"][0, 0]
    key = jax.random.PRNGKey(21)

    jopt = joptim.build_optimizer(P, jcont.param_group_labels(sc.jvars, sc.jcfg), grad_clip=1.0)
    jstep = jrt.make_tto_step(sc.jcfg, P, jopt, sc.jocc_cfg, use_occ)
    jparams = jax.tree.map(jnp.asarray, sc.jvars["params"])
    jocc = sc.jocc if use_occ else jnp.zeros(())
    jparams, jstate, jloss = jstep(jparams, jopt.init(jparams), sc.jvars["buffers"], jocc,
                                   jnp.asarray(rays), jnp.asarray(rgbs), key)

    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    topt = toptim.build_optimizer(P, tcont.param_group_labels(model.params()), grad_clip=1.0)
    tstep = trt.make_tto_step(sc.tcfg, P, topt, sc.tocc_cfg, use_occ)
    state, tloss = tstep(model, topt.init(model.params()), sc.tocc if use_occ else None,
                         torch.from_numpy(rays), torch.from_numpy(rgbs),
                         jax_render_draws(key, use_occ, N_RAYS, P))
    assert int(state["count"]) == 1
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    start = convert.to_jax_variables(convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu"))
    jmu = optax_to_port(jstate, topt)["mu"]
    moved = []

    def check(got, want, before, mu, jax_mu):
        got, want = got.detach().numpy(), np.asarray(want)
        g, jg = mu.numpy() / 0.1, jax_mu.numpy() / 0.1  # the clipped gradient
        np.testing.assert_allclose(g, jg, atol=1e-8, rtol=1e-4)
        big = np.abs(jg) >= 1e-6
        np.testing.assert_allclose(got[big], want[big], atol=1e-6, rtol=1e-4)
        moved.append(bool(np.any(got != before)))

    tree_map(check, model.params(), jax.device_get(jparams), start["params"], state["mu"], jmu)
    assert all(moved)


# --------------------------------------------------------- runtime_evaluate


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tds, "RAY_CACHE", tmp_path / "port_rays")
    monkeypatch.setattr(ttasks, "ROUTE_CACHE", tmp_path / "routes")
    monkeypatch.setenv("ACN_TPU_RAY_CACHE", str(tmp_path / "jax_rays"))


def jax_eval_draws(P):
    """``acn_tpu.runtime_evaluate``'s TTO draws as ``TTODraws`` asks for
    them: ``PRNGKey(seed)`` split once per metadata batch, that key once per
    step, then as ``jax_render_draws``."""
    cache = {}

    def fn(what, b, i, shape):
        if (b, i) not in cache:
            key = jax.random.PRNGKey(int(P.seed))
            for _ in range(b + 1):
                key, kb = jax.random.split(key)
            for _ in range(i + 1):
                kb, k = jax.random.split(kb)
            cache[b, i] = jax_render_draws(k, True, shape[0], P)
        u, phase = cache[b, i]
        return u if what == "u" else phase

    return fn


def _recording(monkeypatch, mod, name, store):
    orig = getattr(mod, name)

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        store.append(out)
        return out

    monkeypatch.setattr(mod, name, wrapped)


def test_runtime_evaluate_matches_jax(eval_run, monkeypatch):
    argv = _eval_argv(eval_run, "--fname", "ev")
    tctx = trunner.build_context(tparse(argv), "eval", device="cpu")
    jctx = jrunner.build_context(jparse(argv), "eval")
    assert tctx["occ_states"] is not None and jctx["occ_states"] is not None
    jpsnr, jssim, jadapt = [], [], []
    _recording(monkeypatch, jrt, "psnr_fn", jpsnr)
    _recording(monkeypatch, jrt, "ssim_fn", jssim)
    _recording(monkeypatch, jrt, "runtime_adapt", jadapt)
    for tto in (0, 2):
        jpsnr.clear(), jssim.clear(), jadapt.clear()
        want = jrt.runtime_evaluate(jctx, tto)
        got = trt.runtime_evaluate(tctx, tto, draws=jax_eval_draws(tctx["P"]))
        assert got["n_views"] == want["n_views"] == 2
        np.testing.assert_allclose([v["psnr"] for v in got["views"]],
                                   [float(x) for x in jpsnr], atol=0.05)
        np.testing.assert_allclose([v["ssim"] for v in got["views"]],
                                   [float(x) for x in jssim], atol=2e-3)
        np.testing.assert_allclose(got["tto_losses"], [a[2] for a in jadapt], rtol=1e-4)
        assert len(got["tto_losses"]) == (2 if tto else 0)
        assert np.isnan(got["lpips"]) and np.isnan(want["lpips"])  # no pretrained weights
        out = Path(tctx["logger"].logdir) / "rendered"
        assert sorted(p.name for p in (out / f"pred{tto}").iterdir()) == ["000000.png",
                                                                         "000001.png"]


def test_tto_sweep_restores_the_base_weights_between_settings(eval_run):
    res = trunner.main(_eval_argv(eval_run, "--tto", "0,2,0", "--fname", "sweep"),
                       device="cpu")
    assert [r["tto"] for r in res] == [0, 2, 0]
    scores = lambda r: [(v["psnr"], v["ssim"]) for v in r["views"]]
    assert scores(res[0]) == scores(res[2])
    assert res[1]["psnr"] != res[0]["psnr"] and np.isfinite(res[1]["tto_losses"]).all()


def test_an_eval_from_params_only_renders_stratified(eval_run, tmp_path):
    """A ``best`` checkpoint has no grids: the eval renders stratified (as
    acn_tpu does) and launches no scan."""
    payload = tck.load_checkpoint(eval_run / "run", "last")
    P = tparse(_eval_argv(eval_run))
    model, _ = tck.restore_model(payload, trunner.build_model_configs(
        P, tds.load_clustering_meta(eval_run / "data" / "out" / "example" / "masks"
                                    / P.mask_dirname)), "cpu")
    tck.save_checkpoint(tmp_path / "best_only", "best", model, P=P, step=8, best=1.0)
    argv = _eval_argv(eval_run, "--fname", "b")
    argv[argv.index("--prefix") + 1] = "best"
    argv[argv.index("--checkpoint_path") + 1] = str(tmp_path / "best_only")
    ctx = trunner.build_context(tparse(argv), "eval", device="cpu")
    assert ctx["occ_cfg"] is not None and ctx["occ_states"] is None
    res = trt.runtime_evaluate(ctx, 0)
    assert np.isfinite(res["psnr"])


# ------------------------------------------------------------ SSIM, LPIPS


@pytest.mark.parametrize("i", range(4))
def test_ssim_matches_jax(i):
    x, y = _pairs()[i]
    got = float(tlosses.ssim(torch.from_numpy(x), torch.from_numpy(y)))
    want = float(jlosses.ssim(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert -1.0 <= got <= 1.0


def test_lpips_fallback_matches_jax_per_image():
    assert not tlpips.LPIPS(device="cpu").pretrained  # no weights on this host
    ours, theirs = tlpips.LPIPS(device="cpu"), jlpips.LPIPS()
    for x, y in _pairs():
        np.testing.assert_allclose(ours(x, y), theirs(x, y), rtol=1e-4, atol=1e-9)
    x, _ = _pairs()[0]
    assert ours(x, x) == 0.0


def test_lpips_reads_weights_from_its_path(tmp_path):
    params = tlpips._rand_params(seed=0)
    params = {k: v * (2.0 if k.startswith("lin") else 1.0) for k, v in params.items()}
    np.savez(tmp_path / "w.npz", **params)
    scaled = tlpips.LPIPS(tmp_path / "w.npz", device="cpu")
    base = tlpips.LPIPS(tmp_path / "missing.npz", device="cpu")
    assert scaled.pretrained and not base.pretrained and scaled.name == "lpips"
    x, y = _pairs()[0]
    np.testing.assert_allclose(scaled(x, y), 2.0 * base(x, y), rtol=1e-6)


