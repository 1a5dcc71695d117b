"""The viewer's frames and helpers (acn_tpu_torch.viewer.{viewer,utils,
colormap}, nerfs.scene_box's oriented boxes) against acn_tpu's, on the
micro run of ``test_torch_viewer_util``.

* ``render_frame`` of both packages from the same checkpoint, through a
  ``Controller`` in view mode (the port's frame reads the leased snapshot),
  at 12 × 16 pixels from a validation camera moved into the viewer's world:
  rgb at full and preview samples, exposure and gamma, the crop box on,
  depth (turbo) and opacity, a near/far override, one active module, and the
  baked table (bake of the port at 16³, which both packages read), also with
  the crop box and one module set, which a baked frame ignores in both
  packages (ROADMAP Queue C): there it equals the plain baked frame. The u8
  frames agree within one step (a color on a rounding edge may round either
  way, ``test_torch_renderer.py``), but for up to 3 % of the pixels of the
  uncropped live frames: there a ray crosses a cell edge where XLA's fused
  multiply-add flips a bin test of the jitted march (ROADMAP Queue C; 1
  pixel of 192 measured, 4 with one module). Depth and opacity are drawn in
  the crop box's frame, which crosses no such edge: their colormaps
  normalize by the frame's minimum and maximum, so one flipped sample
  shifts every pixel.
* The colormaps (gray, turbo, viridis, pca, depth with opacity), the
  sanitizers, ``look_at_pose``, ``_rot_to_wxyz``, ``_load_snap_views``,
  ``crop_render_aabb`` and the oriented-box helpers: atol 1e-6 (float32
  3 × 3 products summed in another order), the rest exact.
* ``verify_continual_batch_dir`` on the run's batch and on three broken
  copies, the same verdicts and messages in both.
"""

import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acn_tpu.nerfs import scene_box as jbox
from acn_tpu.pipelines.baking import BakedRenderer as JBaked
from acn_tpu.pipelines.baking import load_baked as jload_baked
from acn_tpu.pipelines.renderer import Renderer as JRenderer
from acn_tpu.viewer import colormap as jcm
from acn_tpu.viewer import utils as jutils
from acn_tpu.viewer import viewer as jviewer
from acn_tpu.viewer.engine.controller import Controller as JController
from acn_tpu_torch.nerfs import scene_box as tbox
from acn_tpu_torch.pipelines.baking import BakedRenderer as TBaked
from acn_tpu_torch.pipelines.baking import bake_container, load_baked, save_baked
from acn_tpu_torch.pipelines.renderer import Renderer as TRenderer
from acn_tpu_torch.viewer import colormap as tcm
from acn_tpu_torch.viewer import utils as tutils
from acn_tpu_torch.viewer import viewer as tviewer
from acn_tpu_torch.viewer.engine.controller import Controller as TController
from test_torch_viewer_util import contexts, isolated, view_argv, viewer_run  # noqa: F401

FH, FW = 12, 16
CASES = {
    "rgb": {},
    "rgb_preview_exposure_gamma": {"preview": True, "exposure": 0.7, "gamma": 2.2},
    "crop": {"crop_enabled": True, "crop_pos_m": (0.0, 0.3, -0.2),
             "crop_rpy_deg": (0.0, 0.0, 30.0), "crop_size_m": (2.0, 1.2, 1.0)},
    "depth_crop": {"display": "depth", "crop_enabled": True, "crop_pos_m": (0.0, 0.3, -0.2),
             "crop_rpy_deg": (0.0, 0.0, 30.0), "crop_size_m": (2.0, 1.2, 1.0)},
    "opacity_crop": {"display": "opacity", "crop_enabled": True, "crop_pos_m": (0.0, 0.3, -0.2),
             "crop_rpy_deg": (0.0, 0.0, 30.0), "crop_size_m": (2.0, 1.2, 1.0)},
    "near_far": {"near_override_m": 0.4, "far_override_m": 1.9},
    "module_1": {"active_module": 1},
    "baked": {"baked": True},
    "baked_crop_module": {"baked": True, "crop_enabled": True, "crop_pos_m": (0.0, 0.3, -0.2),
                          "crop_rpy_deg": (0.0, 0.0, 30.0), "crop_size_m": (2.0, 1.2, 1.0),
                          "active_module": 1},
}
# the frames whose rays cross a cell edge where XLA's fused multiply-add
# flips a bin test (ROADMAP Queue C): a sample in one package, none in the
# other, at 1 pixel of 192 (4 with one module)
FLIPS = ("rgb", "rgb_preview_exposure_gamma", "module_1")


def _viewer_pose(ctx):
    """A validation camera in the viewer's RUB world (render_frame's map,
    inverted)."""
    from acn_tpu_torch.data.dataset import get_image_metadata

    md = get_image_metadata(ctx["data_path"], ctx["P"].downscale)[1][0]
    c2w = np.asarray(md.c2w, np.float32)
    psf = float(ctx["coordinate_info"]["pose_scale_factor"])
    origin = np.asarray(ctx["coordinate_info"]["origin_drb"], np.float32)
    return np.concatenate([tutils.RUB_TO_DRB.T @ c2w[:, :3],
                           (tutils.RUB_TO_DRB.T @ (c2w[:, 3] * psf + origin))[:, None]],
                          1).astype(np.float32)


@pytest.fixture(scope="module")
def baked_asset(viewer_run, tmp_path_factory):
    """The port's bake of the run's ``last`` at 16³."""
    from acn_tpu_torch import runner as trunner
    from acn_tpu_torch.utils.config import parse_args as tparse

    path = tmp_path_factory.mktemp("baked") / "baked_16.npz"
    with pytest.MonkeyPatch.context() as mp:  # as ``isolated`` sets up a test
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.chdir(path.parent)
        tctx = trunner.build_context(tparse(view_argv(viewer_run)), "view", device="cpu")
    save_baked(path, bake_container(tctx["model"], resolution=16,
                                    aabb=np.asarray(tctx["global_aabb"]), chunk=4096))
    return path


def _frames(viewer_run, baked_asset, case):
    opts = dict(CASES[case])
    preview, baked = opts.pop("preview", False), opts.pop("baked", False)
    jctx, tctx = contexts(viewer_run)
    out = []
    for ctx, ctrl, rend, baked_cls, load, mod in (
            (jctx, JController, JRenderer(jctx["cfg"], jctx["P"], jctx["occ_cfg"]),
             JBaked, jload_baked, jviewer),
            (tctx, TController, TRenderer(tctx["cfg"], tctx["P"], tctx["occ_cfg"], device="cpu"),
             TBaked, lambda p: load_baked(p, device="cpu"), tviewer)):
        P = ctx["P"]
        if baked:  # as launch_viewer builds it for --baked_asset
            ctx["baked_renderer"] = baked_cls(
                load(baked_asset), budget_per_ray=int(P.occ_budget_per_ray or 24),
                chunk_points=int(P.chunk_points), bg_color=P.bg_color_default)
        state = mod.ViewerState(P)
        state.use_baked = baked
        for k, v in opts.items():
            setattr(state, k, v)
        c2w = _viewer_pose(tctx)
        out.append(mod.render_frame(ctx, ctrl(ctx), rend, state, c2w_rub_world=c2w, H=FH,
                                    W=FW, fx=14.0, fy=14.0, cx=FW / 2, cy=FH / 2,
                                    preview=preview))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_render_frame_matches_jax(viewer_run, baked_asset, case):
    want, got = _frames(viewer_run, baked_asset, case)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (FH, FW, 3)
    off = np.abs(got.astype(int) - want.astype(int)).max(-1) > 1
    assert off.sum() <= (0.03 * FH * FW if case in FLIPS else 0), off.sum()
    assert got.std() > 0  # the frame has content


def test_a_baked_frame_ignores_the_crop_box_and_the_module(viewer_run, baked_asset):
    """ROADMAP Queue C: ``acn_tpu/viewer/viewer.py:130-139`` hands the baked
    renderer neither the crop's box nor the active module, and the port
    does the same: in each package the cropped single-module baked frame is
    the plain baked frame, bit for bit."""
    plain = _frames(viewer_run, baked_asset, "baked")
    cropped = _frames(viewer_run, baked_asset, "baked_crop_module")
    for got, want in zip(cropped, plain):
        np.testing.assert_array_equal(got, want)


def test_colormaps_match_jax():
    rng = np.random.default_rng(0)
    x = rng.random((9, 11, 1)).astype(np.float32)
    feats = rng.normal(size=(9, 11, 5)).astype(np.float32)
    acc = rng.random((9, 11, 1)).astype(np.float32)
    for name in ("gray", "turbo", "viridis", "default"):
        for invert in (False, True):
            np.testing.assert_array_equal(
                tcm.apply_colormap(x, tcm.ColormapOptions(colormap=name, invert=invert)),
                jcm.apply_colormap(x, jcm.ColormapOptions(colormap=name, invert=invert)))
    np.testing.assert_array_equal(tcm.apply_colormap(feats), jcm.apply_colormap(feats))
    np.testing.assert_array_equal(tcm.apply_pca_colormap(feats), jcm.apply_pca_colormap(feats))
    for kw in ({}, {"near_plane": 0.2, "far_plane": 0.7}):
        np.testing.assert_array_equal(tcm.apply_depth_colormap(x, acc, **kw),
                                      jcm.apply_depth_colormap(x, acc, **kw))


def test_helpers_match_jax():
    for p in ("white", "Black", "random", "none", "last_sample", "pink", 3):
        assert tutils.sanitize_bg_policy(p) == jutils.sanitize_bg_policy(p)
    for v in (None, "all", "All", -1, "-1", "0", 1, "3", "x", 2.0):
        assert tutils.sanitize_module_selection(v, 3) == jutils.sanitize_module_selection(v, 3)
    img = np.linspace(-0.5, 1.5, 30, dtype=np.float32).reshape(10, 3)
    np.testing.assert_array_equal(tutils.srgb_u8(img), jutils.srgb_u8(img))
    np.testing.assert_array_equal(tutils.RUB_TO_DRB, jutils.RUB_TO_DRB)
    rng = np.random.default_rng(1)
    for _ in range(5):
        pos, target = rng.normal(size=3), rng.normal(size=3)
        up = np.array([0.0, 1.0, 0.0])
        pose = tutils.look_at_pose(pos, target, up)
        np.testing.assert_array_equal(pose, jutils.look_at_pose(pos, target, up))
        for R in (pose[:, :3].astype(np.float64), -np.eye(3) * [1, 1, -1],
                  np.diag([1.0, -1.0, -1.0])):
            np.testing.assert_array_equal(tviewer._rot_to_wxyz(R), jviewer._rot_to_wxyz(R))


def test_snap_views_and_crop_box_match_jax(viewer_run):
    jctx, tctx = contexts(viewer_run)
    got, want = tviewer._load_snap_views(tctx), jviewer._load_snap_views(jctx)
    assert len(got) == len(want) == 2
    for (p, q), (jp, jq) in zip(got, want):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(q, jq)
    assert tviewer._load_snap_views({"data_path": "/nonexistent", "P": tctx["P"]}) == []
    gaabb = np.asarray(tctx["global_aabb"])
    for pos, rpy, size, origin, psf in (((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                         np.zeros(3, np.float32), 1.0),
                                        ((3.0, -2.0, 5.0), (10.0, -20.0, 35.0),
                                         (40.0, 25.0, 30.0),
                                         np.array([1.0, 2.0, -1.0], np.float32), 20.0)):
        np.testing.assert_allclose(
            tviewer.crop_render_aabb(gaabb, origin, psf, pos, rpy, size),
            jviewer.crop_render_aabb(gaabb, origin, psf, pos, rpy, size), atol=1e-6)


def test_oriented_box_helpers_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(4):
        pos = rng.normal(size=3).astype(np.float32)
        rpy = tuple(rng.uniform(-np.pi, np.pi, 3))
        scale = rng.uniform(0.5, 2.0, 3).astype(np.float32)
        tobb, jobb = tbox.obb_from_params(pos, rpy, scale), jbox.obb_from_params(pos, rpy, scale)
        for a, b in zip(tobb, jobb):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        np.testing.assert_allclose(tbox.obb_to_aabb(tobb).numpy(),
                                   np.asarray(jbox.obb_to_aabb(jobb)), atol=1e-6)
        pts = rng.uniform(-2.5, 2.5, (500, 3)).astype(np.float32)
        inside = tbox.obb_within(tobb, torch.from_numpy(pts)).numpy()
        np.testing.assert_array_equal(inside, np.asarray(jbox.obb_within(jobb, jnp.asarray(pts))))
        assert 0 < inside.sum() < len(pts)


def _broken_batches(batch, tmp_path):
    """Three broken copies of a good batch: an image gone, no metadata
    files, a camera out of the normalized range."""
    import torch as _torch

    out = {}
    for name in ("image_gone", "no_metadata", "out_of_range"):
        d = tmp_path / "out" / "continual" / name
        shutil.copytree(batch, d)
        out[name] = d
    (tmp_path / "out" / "coordinates.pt").write_bytes(b"")  # the prepared root above
    next(iter(sorted((out["image_gone"] / "rgbs").iterdir()))).unlink()
    for p in (out["no_metadata"] / "metadata").iterdir():
        p.unlink()
    for p in (out["out_of_range"] / "metadata").iterdir():
        md = _torch.load(p, weights_only=False)
        md["c2w"][:, 3] = 2.0
        _torch.save(md, p)
    return out


def test_verify_continual_batch_dir_matches_jax(viewer_run, tmp_path):
    batch = viewer_run / "data" / "out" / "example" / "continual" / "b000"
    ok, msgs = tutils.verify_continual_batch_dir(batch)
    assert ok and (ok, msgs) == jutils.verify_continual_batch_dir(batch)
    verdicts = {}
    for name, d in _broken_batches(batch, tmp_path).items():
        got = tutils.verify_continual_batch_dir(d)
        assert got == jutils.verify_continual_batch_dir(d)
        verdicts[name] = got[0]
    assert verdicts == {"image_gone": False, "no_metadata": False, "out_of_range": False}
    assert tutils.verify_continual_batch_dir(tmp_path / "missing") == \
        jutils.verify_continual_batch_dir(tmp_path / "missing")
