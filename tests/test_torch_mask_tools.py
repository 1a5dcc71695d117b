"""The port's mask and dataset audits (acn_tpu_torch.scripts.{log_mask_info,
log_dataset_info, visualize_clustering}) against acn_tpu's.

* ``log_mask_info``: the same text on strict (margin 1) and overlapping
  (margin 1.1) masks that the port's ``create_clusters`` wrote, and on the
  ``toy`` dataset's masks, with ``--max_images`` and ``--expect_exclusive``
  (exit 1 in both on the tool's masks: a ray whose samples cross a boundary
  belongs to both cells even at margin 1); ``load_mask`` reads plain and zipped files as
  ``acn_tpu``'s does.
* ``log_dataset_info``: the same ``info.txt`` on a COLMAP-prepared dataset
  (with its altitude band) and on the ``toy`` one.
* ``visualize_clustering``: the arrays it plots, not PNG bytes. The region
  map and the camera scatter's points and colors are captured from
  matplotlib's ``imshow`` and ``scatter`` in both packages and compared
  exactly; the overlay PNGs decode to the same pixels; ``region_image``
  is the array the figure shows.
"""

import argparse

import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from acn_tpu.scripts import log_dataset_info as jldi
from acn_tpu.scripts import log_mask_info as jlmi
from acn_tpu.scripts import visualize_clustering as jviz
from acn_tpu_torch import toy
from acn_tpu_torch.scripts import create_clusters as tcc
from acn_tpu_torch.scripts import log_dataset_info as tldi
from acn_tpu_torch.scripts import log_mask_info as tlmi
from acn_tpu_torch.scripts import prepare_dataset as tprep
from acn_tpu_torch.scripts import visualize_clustering as tviz
from test_torch_dataset_tools import _prepare, _scene

matplotlib.use("Agg")


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """(a COLMAP-prepared set with the port's strict and margin-1.1 masks,
    a ``toy`` set of 4 experts with its own masks)."""
    root = tmp_path_factory.mktemp("audits")
    _scene(root / "colmap", np.random.default_rng(2), ["a.png", "b.png", "c.png"], [1, 2, 3])
    _prepare(tprep, root / "colmap", root / "data")
    for name, margin in (("strict", "1.0"), ("bm110", "1.1")):
        tcc.main(tcc.build_parser().parse_args(
            ["--data_path", str(root / "data"), "--output", name, "--grid_dim", "2", "2",
             "--cluster_2d", "--boundary_margin", margin, "--ray_samples", "32",
             "--center_pixels", "--device", "cpu"]))
    data = toy.write_dataset_dir(root / "toy", K=4, train_cams=5, val_cams=3, H=24, W=32)
    return root / "data", data


def _text(mod, capsys, argv):
    """(exit code, printed text) of ``mod.main``."""
    try:
        mod.main(mod.build_parser().parse_args(argv))
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


@pytest.mark.parametrize("which", ["strict", "bm110", "toy"])
def test_log_mask_info_prints_what_acn_tpu_prints(sets, capsys, which):
    mask_dir = (sets[1] / "masks" / "g22_grid_bm110_ss11" if which == "toy"
                else sets[0] / "masks" / which)
    for extra in ([], ["--max_images", "2"], ["--expect_exclusive"]):
        argv = ["--mask_dir", str(mask_dir), *extra]
        got, want = _text(tlmi, capsys, argv), _text(jlmi, capsys, argv)
        assert got == want and "overlap" in got[1]
    # a ray's samples may cross a boundary, so even margin-1 masks overlap;
    # the toy views see no overlap
    assert got[0] == (which != "toy") and ("[VIOLATION]" in got[1]) == (which != "toy")


def test_load_mask_reads_plain_and_zipped_files(tmp_path):
    m = np.random.default_rng(0).random((5, 7)) < 0.5
    torch.save(torch.from_numpy(m), tmp_path / "plain.pt")
    tcc.save_zip_mask(tmp_path / "zipped.pt", m)
    for name in ("plain.pt", "zipped.pt"):
        got, want = tlmi.load_mask(tmp_path / name), jlmi.load_mask(tmp_path / name)
        assert got.dtype == want.dtype == bool
        np.testing.assert_array_equal(got, m)
        np.testing.assert_array_equal(want, m)


@pytest.mark.parametrize("which", [0, 1])
def test_log_dataset_info_writes_what_acn_tpu_writes(sets, tmp_path, capsys, which):
    data = sets[which]
    got, want = tldi.dataset_info(data), jldi.dataset_info(data)
    assert got == want
    assert ("altitude_range_enu" in got) == (which == 0) and "split train" in got
    for mod, name in ((tldi, "port.txt"), (jldi, "jax.txt")):
        mod.main(mod.build_parser().parse_args(
            ["--data_path", str(data), "--out", str(tmp_path / name)]))
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


def _plotted(mod, h, monkeypatch):
    """What ``run_visualize`` handed to ``imshow`` and ``scatter``."""
    from matplotlib.axes import Axes

    calls = []
    imshow, scatter = Axes.imshow, Axes.scatter

    def rec_imshow(self, X, *a, **k):
        calls.append(("imshow", np.array(X), k.get("extent")))
        return imshow(self, X, *a, **k)

    def rec_scatter(self, x, y, *a, **k):
        col = k.get("color", k.get("c"))
        calls.append(("scatter", np.array(x), np.array(y), np.array(col, dtype=object)))
        return scatter(self, x, y, *a, **k)

    monkeypatch.setattr(Axes, "imshow", rec_imshow)
    monkeypatch.setattr(Axes, "scatter", rec_scatter)
    out = mod.run_visualize(h)
    monkeypatch.setattr(Axes, "imshow", imshow)
    monkeypatch.setattr(Axes, "scatter", scatter)
    return calls, out


def test_visualize_clustering_plots_what_acn_tpu_plots(sets, tmp_path, monkeypatch):
    data = sets[1]
    h = lambda name: argparse.Namespace(
        data_path=data, mask_dirname="g22_grid_bm110_ss11", out_dir=tmp_path / name,
        num_overlays=2, downscale=0.25)
    got, out_t = _plotted(tviz, h("port"), monkeypatch)
    want, out_j = _plotted(jviz, h("jax"), monkeypatch)
    assert [c[0] for c in got] == [c[0] for c in want]
    assert [c[0] for c in got].count("scatter") == 2 + 4 + 1
    for a, b in zip(got, want):
        for x, y in zip(a[1:], b[1:]):
            if isinstance(y, np.ndarray) and y.dtype != object:
                np.testing.assert_array_equal(x, y)
            else:
                assert str(x) == str(y)
    # the region map the figure shows is region_image's, shown transposed
    params = torch.load(data / "masks" / "g22_grid_bm110_ss11" / "params.pt",
                        weights_only=False)
    img, owner, _, _ = tviz.region_image(params["centroids"].numpy(),
                                         params["aabb_global"].numpy(), 1.1)
    np.testing.assert_array_equal(np.transpose(img, (1, 0, 2)), got[0][1])
    plain = (img.reshape(-1, 1, 3) == tviz.CELL_COLORS[None]).all(-1).any(-1)
    assert set(np.unique(owner)) == {0, 1, 2, 3} and not plain.all()  # bands darkened
    pngs = sorted(p.relative_to(out_t) for p in out_t.rglob("*_assign.png"))
    assert pngs == sorted(p.relative_to(out_j) for p in out_j.rglob("*_assign.png"))
    assert len(pngs) == 4
    for rel in pngs:
        np.testing.assert_array_equal(np.asarray(Image.open(out_t / rel)),
                                      np.asarray(Image.open(out_j / rel)))
    for name in ("regions.png", "scatter_cameras.png"):
        assert (out_t / name).stat().st_size > 0


def test_color_overlay_and_owners_equal_jax():
    rng = np.random.default_rng(5)
    rgb = rng.random((6, 9, 3))
    masks = rng.random((4, 6, 9)) < 0.4
    np.testing.assert_array_equal(tviz.color_overlay(rgb, masks),
                                  jviz.color_overlay(rgb, masks))
    cents = rng.uniform(-1, 1, (4, 3))
    cams = rng.uniform(-1, 1, (20, 3))
    for c2d in (True, False):
        sub = (1, 2) if c2d else (0, 1, 2)
        want = np.linalg.norm(cams[:, None, sub] - cents[None, :, sub], axis=-1).argmin(1)
        np.testing.assert_array_equal(tviz.camera_owners(cents, cams, c2d), want)
