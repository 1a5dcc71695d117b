"""The port's video path (acn_tpu_torch.pipelines.video_gen) and the
runner's ``--op video`` against acn_tpu's.

* The five camera paths (and the turntable's tilt): f32 atol 1e-6 (the same
  numpy; the poses are host float32 arithmetic).
* ``suppress_fog``: the masks and the stats exactly.
* ``_write_video``: an MP4 through imageio where it can; a GIF through
  Pillow when imageio's import fails or its writer raises; an ImportError
  naming both when neither imports. Each logs the encoder it used.
* ``render_video`` on the micro run of ``test_torch_eval_card`` (a
  ``toy.write_dataset_dir`` dataset of 24 × 32 views), live and from a
  baked asset, against ``acn_tpu.pipelines.video_gen.render_video``'s
  frames: u8 within one step (1/255): the live frames are f32 renders
  quantized after fog suppression, the baked ones u8 frames.
* ``python -m acn_tpu_torch --op video`` through ``runner.main`` on the
  CPU, live and with ``--baked_asset``: a file with the asked-for frames.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from acn_tpu import runner as jrunner
from acn_tpu.pipelines import baking as jbake
from acn_tpu.pipelines import video_gen as jvg
from acn_tpu.utils.config import parse_args as jparse
from acn_tpu_torch import runner as trunner
from acn_tpu_torch.data import dataset as tds
from acn_tpu_torch.pipelines import video_gen as tvg
from acn_tpu_torch.utils.config import parse_args as tparse
from test_torch_eval_card import _eval_argv, eval_run  # noqa: F401 (a fixture)

CENTER = np.array([0.0, 0.1, -0.2], np.float32)
EXTENT = np.array([0.4, 2.0, 2.0], np.float32)


@pytest.mark.parametrize("path", ["turntable", "turntable_tilt", "east_west", "north_south",
                                  "spiral_in", "full_coverage", "full_coverage_short"])
def test_poses_match_jax(path):
    if path.startswith("turntable"):
        kw = dict(n_poses=24, tilt_deg=7.0 if path.endswith("tilt") else 0.0)
        want = jvg.poses_turntable(CENTER, 1.5, **kw)
        got = tvg.poses_turntable(CENTER, 1.5, **kw)
    else:
        name = path.replace("_short", "")
        n = 20 if path.endswith("short") else 137  # cut, and padded with the last pose
        want = jvg.PATH_GENERATORS[name](CENTER, EXTENT, n)
        got = tvg.PATH_GENERATORS[name](CENTER, EXTENT, n)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_suppress_fog_exact():
    rng = np.random.default_rng(0)
    n = 4000
    rgb = rng.random((n, 3)).astype(np.float32)
    acc = rng.random(n).astype(np.float32) * 0.2
    wmax = rng.random(n).astype(np.float32) * 0.2
    went = rng.random(n).astype(np.float32) * 3.0
    a, b = rgb.copy(), rgb.copy()
    want = jvg.suppress_fog(a, acc, wmax, went, 1.0)
    got = tvg.suppress_fog(b, acc, wmax, went, 1.0)
    assert got == want and 0 < want["pct_fog"] < 1
    np.testing.assert_array_equal(b, a)


class _Log:
    def __init__(self):
        self.lines = []

    def log(self, m):
        self.lines.append(m)


FRAMES = [np.full((8, 8, 3), i * 40, np.uint8) for i in range(4)]


def _frame_count(path, fps=30):
    """Frames in the video: a GIF's total duration over one frame's (Pillow
    merges identical neighbours into one longer frame)."""
    if str(path).endswith(".gif"):
        from PIL import Image

        # a merged frame lasts k frames' time, stored in whole centiseconds
        d = max(int(1000 / fps), 20)
        with Image.open(path) as im:
            n = 0
            for i in range(im.n_frames):
                im.seek(i)
                n += round(im.info["duration"] / d)
        return n
    import imageio.v3 as iio

    return iio.imread(path).shape[0]


def test_write_video_falls_back_to_a_gif_without_imageio(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    log = _Log()
    out = tvg._write_video(str(tmp_path / "clip.mp4"), FRAMES, 10, log)
    assert out == str(tmp_path / "clip.gif") and _frame_count(out, 10) == 4
    assert "imageio is not importable" in log.lines[0]
    assert "Pillow GIF" in log.lines[-1]


def test_write_video_falls_back_when_the_mp4_writer_fails(tmp_path, monkeypatch):
    import imageio.v3 as iio

    def fail(*a, **kw):
        raise RuntimeError("no backend")

    monkeypatch.setattr(iio, "imwrite", fail)
    log = _Log()
    out = tvg._write_video(str(tmp_path / "clip.mp4"), FRAMES, 10, log)
    assert out.endswith(".gif") and _frame_count(out, 10) == 4
    assert "mp4 encode unavailable (RuntimeError)" in log.lines[0]


def test_write_video_raises_naming_both_without_either(tmp_path, monkeypatch):
    for mod in ("imageio", "imageio.v3", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(ImportError, match="imageio.*Pillow"):
        tvg._write_video(str(tmp_path / "clip.mp4"), FRAMES, 10, _Log())


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tds, "RAY_CACHE", tmp_path / "port_rays")
    monkeypatch.setenv("ACN_TPU_RAY_CACHE", str(tmp_path / "jax_rays"))


def _captured_frames(monkeypatch, mod):
    got = []

    def capture(out_path, frames, fps, logger):
        got.append((out_path, np.stack(frames)))
        return out_path

    monkeypatch.setattr(mod, "_write_video", capture)
    return got


@pytest.mark.parametrize("baked", [False, True])
def test_render_video_matches_jax(eval_run, isolated, monkeypatch, tmp_path, baked):
    flags = ["--op", "video", "--camera_path", "turntable", "--fname", "v"]
    if baked:
        asset = tmp_path / "asset.npz"
        jctx = jrunner.build_context(jparse(_eval_argv(eval_run, "--op", "bake",
                                                       "--fname", "b")), "bake")
        jbake.save_baked(asset, jbake.bake_container(
            jctx["variables"], jctx["cfg"], resolution=16, aabb=np.asarray(
                jctx["global_aabb"])))
        flags += ["--baked_asset", str(asset), "--occ_budget_per_ray", "8"]
    argv = _eval_argv(eval_run, *flags)
    jframes = _captured_frames(monkeypatch, jvg)
    tframes = _captured_frames(monkeypatch, tvg)
    jvg.render_video(jrunner.build_context(jparse(argv), "video"), n_poses=3)
    tvg.render_video(trunner.build_context(tparse(argv), "video", device="cpu"), n_poses=3)
    (jpath, want), (tpath, got) = jframes[0], tframes[0]
    assert Path(tpath).name == Path(jpath).name == (
        "turntable_baked.mp4" if baked else "turntable.mp4")
    assert got.shape == want.shape == (3, 24, 32, 3) and got.dtype == np.uint8
    assert np.ptp(want) > 50  # content, not a blank frame
    np.testing.assert_allclose(got.astype(np.int16), want.astype(np.int16), atol=1)


@pytest.mark.parametrize("baked", [False, True])
def test_op_video_writes_the_frames(eval_run, isolated, baked):
    flags = ["--op", "video", "--video_frames", "3", "--fname", "vid"]
    if baked:
        path = trunner.main(_eval_argv(eval_run, "--op", "bake", "--bake_resolution", "12",
                                       "--fname", "bk"), device="cpu")
        flags += ["--baked_asset", path]
    out = trunner.main(_eval_argv(eval_run, *flags), device="cpu")
    assert Path(out).exists() and _frame_count(out) == 3
    assert Path(out).stem == ("full_coverage_baked" if baked else "full_coverage")
