"""The port's serving renderer (acn_tpu_torch.pipelines.renderer) against
acn_tpu's Renderer on the same weights and occupancy, through its three
soft-MoE paths (packed budget, strided per-ray march with budget 0, and
stratified without an ``OccConfig``); and the port's isolation from JAX.

Tolerances: ``render_image`` returns u8 colors and f16 depth/acc, so rgb
may differ by one quantization step (1/255) where a value sits on a
rounding edge, and depth/acc by one f16 rounding (rtol 1e-3);
``render_rays`` returns f32, held at atol 1e-5 (f32 MLPs, exp/log and
segment sums in another order). The JAX renderer is jitted, so XLA fuses
multiply-adds the port rounds separately: a sample position may differ by an
ulp, which is why these checks are tolerances and the exact integer checks
live in test_torch_march_render.py.
"""

import ast
import os
import types
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from acn_tpu.pipelines.renderer import Renderer as JRenderer
from acn_tpu_torch import convert, toy
from acn_tpu_torch.pipelines import renderer as trenderer
from acn_tpu_torch.pipelines.renderer import Renderer as TRenderer
from test_torch_models import small_scene

REPO = Path(__file__).resolve().parent.parent
H, W = 12, 16


@pytest.fixture(scope="module")
def scene():
    return small_scene(sigma_bias=2.0, alpha_thre=1e-2, budget=6, s_max=64)


PATHS = ("budget", "strided", "stratified")


def _renderers(scene, path="budget"):
    """(JAX, port) renderers of one path; 64-ray chunks: a 12×16 frame is
    three chunks of 4 rows. The strided path keeps 16 of 64 bins per ray,
    the stratified one takes 24 samples."""
    P, jocc, tocc = scene.P, scene.jocc_cfg, scene.tocc_cfg
    if path == "strided":
        P = types.SimpleNamespace(**{**vars(P), "occ_budget_per_ray": 0,
                                     "occ_s_kept": 16})
    if path == "stratified":
        P = types.SimpleNamespace(**{**vars(P), "ray_samples": 24})
        jocc = tocc = None
    j = JRenderer(scene.jcfg, P, jocc, chunk_rays=64)
    t = TRenderer(scene.tcfg, P, tocc, chunk_rays=64, device="cpu")
    return j, t


def test_chunk_size_matches_jax_at_full_width():
    cfg, P, occ_cfg = toy.train_occ_config()
    r = TRenderer(cfg, P, occ_cfg, device="cpu")
    assert r.chunk_rays == 31_250
    rows = r.chunk_rays // 1920
    assert (rows, rows * 1920, rows * 1920 * 32) == (16, 30_720, 983_040)
    assert -(-1080 // rows) == 68  # chunks per 1080p frame


@pytest.mark.parametrize("path,chunk,s_kept", [("strided", 15_625, 64),
                                               ("stratified", 10_416, None)])
def test_chunk_size_of_the_other_paths_at_full_width(path, chunk, s_kept):
    """acn_tpu's sizing: 4,000,000 point-expert evaluations over K = 4 and
    the kept samples (min(occ_s_kept, ray_samples) = 64) or the 96
    stratified samples."""
    cfg, P, occ_cfg = toy.train_occ_config()
    P = types.SimpleNamespace(**{**vars(P), "occ_budget_per_ray": 0})
    r = TRenderer(cfg, P, occ_cfg if path == "strided" else None, device="cpu")
    j = JRenderer(cfg, P, occ_cfg if path == "strided" else None)
    assert r.chunk_rays == j.chunk_rays == chunk
    assert getattr(r, "s_kept", None) == s_kept


@pytest.mark.parametrize("path", PATHS)
def test_render_image_matches_jax(scene, path):
    jr, tr = _renderers(scene, path)
    cam = toy.overhead_camera(H, W)
    want = jr.render_image(scene.jvars, scene.jocc, H=H, W=W, **cam)
    got = tr.render_image(scene.model, scene.tocc, H=H, W=W, **cam)
    assert got[0].shape == (H, W, 3) and np.isfinite(got[0]).all()
    assert float(np.asarray(want[2]).max()) > 0.3  # content, not only sky
    np.testing.assert_allclose(got[0], want[0], atol=1.0 / 255 + 1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-3, atol=1e-3)
    # the download=False path renders and returns nothing
    assert tr.render_image(scene.model, scene.tocc, H=H, W=W, download=False,
                           **cam) == (None, None, None)


@pytest.mark.parametrize("path", PATHS)
def test_render_rays_matches_jax(scene, path):
    jr, tr = _renderers(scene, path)
    cam = toy.overhead_camera(H, W)
    rays = trenderer._pinhole_block_rays(
        H, W, *(torch.from_numpy(np.asarray(a, np.float32)) for a in
                (cam["c2w"], cam["intrinsics"], cam["aabb"])),
        torch.tensor([-np.inf, np.inf]), 0.0, 0.0).numpy()
    rays = rays[np.random.default_rng(0).permutation(len(rays))[:150]]
    want = jr.render_rays(scene.jvars, scene.jocc, rays, with_stats=True)
    got = tr.render_rays(scene.model, scene.tocc, rays, with_stats=True)
    for name, w, g in zip(("rgb", "depth", "acc", "wmax", "went"), want, got):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


def test_default_device_is_the_card(monkeypatch):
    cfg, P, occ_cfg = toy.train_occ_config()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TRenderer(cfg, P, occ_cfg)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("path", ("strided", "stratified"))
def test_render_rays_on_card_matches_plain(scene, path):
    """The strided and stratified paths on the card against the CPU; they
    launch no kernel of the port (no packed scan)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from acn_tpu_torch.ops import segscan
    _, cpu = _renderers(scene, path)
    card = TRenderer(cpu.cfg, cpu.P, cpu.occ_cfg, chunk_rays=64)
    cam = toy.overhead_camera(H, W)
    rays = trenderer._pinhole_block_rays(
        H, W, *(torch.from_numpy(np.asarray(a, np.float32)) for a in
                (cam["c2w"], cam["intrinsics"], cam["aabb"])),
        torch.tensor([-np.inf, np.inf]), 0.0, 0.0).numpy()
    before = segscan.seg_excl_sum_kernel.launches
    got = card.render_rays(convert.from_jax_variables(scene.jvars, scene.tcfg, "cuda"),
                           {k: v.cuda() for k, v in scene.tocc.items()}, rays,
                           with_stats=True)
    assert segscan.seg_excl_sum_kernel.launches == before
    want = cpu.render_rays(scene.model, scene.tocc, rays, with_stats=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def _port_files():
    return sorted((REPO / "acn_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax():
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "acn_tpu"), f"{path}: {n}"


def test_port_imports_with_jax_and_acn_tpu_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'acn_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import acn_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(acn_tpu_torch.__path__, "
        "'acn_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'acn_tpu') and sys.modules[k]"
        " for k in list(sys.modules))\n"
        "print(len(mods))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 14


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the script would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
