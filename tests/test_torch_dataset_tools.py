"""The port's host tooling for datasets (acn_tpu_torch.data.{colmap,
transformations}, scripts.{prepare_dataset,update_dataset}) against
acn_tpu's, exactly.

* The COLMAP readers on a binary and a text model that this file writes
  (PINHOLE, OPENCV with distortion and SIMPLE_RADIAL cameras, two images
  with 2-D points, 3-D points with tracks), the quaternion pair and
  ``get_cam_intrinsics``; the geodetic, ECEF and ENU transformations, the
  bases and the origin policies: the same values, bit for bit.
* ``prepare_dataset.main`` on a synthetic 3-image model (images written with
  cv2), then ``update_dataset.main`` with 2 new images, in each package:
  the outputs equal file for file (``coordinates.pt`` and every metadata
  file's tensors exactly, every image's bytes, ``mappings.txt``,
  ``manifest.json``).
* A new camera outside the normalized range: ``--on_overflow abort`` raises
  in both, ``clip`` clips it in both, to the same files.
"""

import json
import struct
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from acn_tpu.data import colmap as jcolmap
from acn_tpu.data import transformations as jtf
from acn_tpu.scripts import prepare_dataset as jprep
from acn_tpu.scripts import update_dataset as jupd
from acn_tpu_torch.data import colmap as tcolmap
from acn_tpu_torch.data import transformations as ttf
from acn_tpu_torch.scripts import prepare_dataset as tprep
from acn_tpu_torch.scripts import update_dataset as tupd

CAMERAS = [(1, "PINHOLE", 48, 32, [40.0, 41.0, 24.0, 16.0]),
           (2, "OPENCV", 48, 32, [38.0, 39.0, 23.5, 16.5, -0.05, 0.01, 0.001, -0.002]),
           (3, "SIMPLE_RADIAL", 48, 32, [40.0, 24.0, 16.0, -0.03])]


def _rotation(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


def _images(rng, names, cam_ids, far=False, centers=None):
    """Cameras about 20 m up over a 60 m square (or at ``centers``), in any
    orientation; shifted 5 km away when asked."""
    out = []
    for i, (name, cam) in enumerate(zip(names, cam_ids)):
        q = _rotation(rng)
        R = jcolmap.qvec2rotmat(q)
        C = np.array([rng.uniform(-30, 30), rng.uniform(-30, 30), 20 + rng.uniform(-2, 2)])
        if centers is not None:
            C = np.asarray(centers[i], np.float64)
        if far:
            C = C + np.array([5000.0, 0.0, 0.0])
        out.append((i + 1, q, -R @ C, cam, name, rng.uniform(0, 40, (3, 2)),
                    np.array([1, -1, 2], np.int64)))
    return out


def _points(rng, n=40):
    return [(i + 1, rng.uniform([-40, -40, -5], [40, 40, 5]), rng.integers(0, 255, 3),
             float(rng.random()), [(1, 0), (2, 1)]) for i in range(n)]


def write_model_bin(d, cameras, images, points):
    d.mkdir(parents=True, exist_ok=True)
    ids = {name: mid for mid, (name, _) in jcolmap.CAMERA_MODELS.items()}
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cid, model, w, h, params in cameras:
            f.write(struct.pack("<iiQQ", cid, ids[model], w, h))
            f.write(struct.pack(f"<{len(params)}d", *params))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, q, t, cid, name, xys, pids in images:
            f.write(struct.pack("<i4d3di", iid, *q, *t, cid) + name.encode() + b"\0")
            f.write(struct.pack("<Q", len(xys)))
            for (x, y), pid in zip(xys, pids):
                f.write(struct.pack("<ddq", x, y, pid))
    with open(d / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pid, xyz, rgb, err, track in points:
            f.write(struct.pack("<Q3d3BdQ", pid, *xyz, *rgb, err, len(track)))
            for img, idx in track:
                f.write(struct.pack("<ii", img, idx))


def write_model_txt(d, cameras, images, points):
    d.mkdir(parents=True, exist_ok=True)
    num = lambda v: " ".join(repr(float(x)) for x in v)
    (d / "cameras.txt").write_text("# camera list\n" + "".join(
        f"{cid} {model} {w} {h} {num(p)}\n" for cid, model, w, h, p in cameras))
    (d / "images.txt").write_text("# image list\n" + "".join(
        f"{iid} {num(q)} {num(t)} {cid} {name}\n"
        + " ".join(f"{float(x)!r} {float(y)!r} {int(p)}" for (x, y), p in zip(xys, pids)) + "\n"
        for iid, q, t, cid, name, xys, pids in images))
    (d / "points3D.txt").write_text("".join(
        f"{pid} {num(xyz)} {' '.join(str(int(c)) for c in rgb)} {err!r} "
        + " ".join(f"{a} {b}" for a, b in track) + "\n"
        for pid, xyz, rgb, err, track in points))


def _same(a, b):
    """Two reader outputs (dataclasses of numpy fields), field by field."""
    assert type(a).__name__ == type(b).__name__
    for k, v in vars(b).items():
        got = getattr(a, k)
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got, v)
            assert got.dtype == v.dtype
        else:
            assert got == v, k


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_readers_match_jax(tmp_path, ext):
    rng = np.random.default_rng(0)
    images = _images(rng, ["a.png", "b.png"], [1, 2])
    (write_model_bin if ext == ".bin" else write_model_txt)(tmp_path, CAMERAS, images,
                                                            _points(rng))
    got, want = tcolmap.read_model(tmp_path), jcolmap.read_model(tmp_path)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and len(g) > 0
        for k in w:
            _same(g[k], w[k])
    for cam in want[0].values():
        for a, b in zip(tcolmap.get_cam_intrinsics(cam), jcolmap.get_cam_intrinsics(cam)):
            np.testing.assert_array_equal(a, b)
    for im in want[1].values():
        R = jcolmap.qvec2rotmat(im.qvec)
        np.testing.assert_array_equal(tcolmap.qvec2rotmat(im.qvec), R)
        np.testing.assert_array_equal(tcolmap.rotmat2qvec(R), jcolmap.rotmat2qvec(R))


def test_transformations_match_jax():
    for name in ("RDF_TO_DRB", "ENU_TO_DRB", "RDF_TO_RUB", "WGS84_A", "WGS84_B", "WGS84_E2"):
        np.testing.assert_array_equal(getattr(ttf, name), getattr(jtf, name))
    rng = np.random.default_rng(1)
    lat, lon, alt = rng.uniform(-60, 60, 20), rng.uniform(-180, 180, 20), rng.uniform(0, 500, 20)
    ref = (45.1, 7.6, 230.0)
    for fn, args in (("geodetic_to_ecef", (lat, lon, alt)),
                     ("ecef_to_geodetic", jtf.geodetic_to_ecef(lat, lon, alt)),
                     ("geodetic_to_enu", (lat, lon, alt, *ref)),
                     ("enu_to_geodetic", (lat * 100, lon * 100, alt, *ref)),
                     ("ecef_to_enu_rot", ref[:2]),
                     ("enu_span_meters", (44.9, 45.3, 7.4, 7.9, *ref))):
        for a, b in zip(np.atleast_1d(getattr(ttf, fn)(*args)),
                        np.atleast_1d(getattr(jtf, fn)(*args))):
            np.testing.assert_array_equal(a, b)
    hp = SimpleNamespace(enu_ref_lat=1.0, enu_ref_lon=2.0, enu_ref_alt=3.0)
    for policy in ("first", "mean", "median", "custom", "MEDIAN"):
        assert ttf.choose_enu_origin(policy, lat, lon, alt, [3, 1], hp) == \
            jtf.choose_enu_origin(policy, lat, lon, alt, [3, 1], hp)
    for mod in (ttf, jtf):
        with pytest.raises(ValueError, match="enu_ref"):
            mod.choose_enu_origin("nearest", lat, lon, alt, [0], hp)
    centers = np.stack(jtf.geodetic_to_ecef(lat, lon, alt), 1)
    assert ttf.is_likely_ecef(centers) == jtf.is_likely_ecef(centers) is True
    assert ttf.is_likely_ecef(centers / 1e4) == jtf.is_likely_ecef(centers / 1e4) is False


def _scene(root, rng, names, cam_ids, far=False):
    """A COLMAP model dir (``model/`` binary, ``images/`` PNGs by cv2)."""
    imgs = _images(rng, names, cam_ids, far=far)
    write_model_bin(root / "model", CAMERAS, imgs, _points(rng))
    (root / "images").mkdir(parents=True, exist_ok=True)
    for name in names:
        cv2.imwrite(str(root / "images" / name),
                    rng.integers(0, 255, (32, 48, 3)).astype(np.uint8))
    return imgs


def _files(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def _same_outputs(got, want):
    assert _files(got) == _files(want) and _files(got)
    for rel in _files(want):
        a, b = got / rel, want / rel
        if rel.endswith(".pt"):
            da = torch.load(a, weights_only=False)
            db = torch.load(b, weights_only=False)
            assert sorted(da) == sorted(db)
            for k in db:
                if isinstance(db[k], torch.Tensor):
                    assert da[k].dtype == db[k].dtype and torch.equal(da[k], db[k]), (rel, k)
                else:
                    assert da[k] == db[k], (rel, k)
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def _prepare(mod, src, out):
    mod.main(mod.build_parser().parse_args(
        ["--data_path", str(src), "--output_path", str(out), "--val_split", "0.34", "--yes"]))


def _update(mod, src, out, *extra):
    mod.main(mod.build_parser().parse_args(
        ["--update_model_path", str(src), "--prepared_dir", str(out), "--batch_tag", "b000",
         *extra]))


def test_prepare_then_update_dataset_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    base = ["view_a.png", "view_b.png", "view_c.png"]
    _scene(tmp_path / "colmap", rng, base, [1, 2, 3])
    upd = _scene(tmp_path / "colmap_update", np.random.default_rng(2), base, [1, 2, 3])
    # the update's model holds the 3 registered images and 2 new ones, the
    # new ones between the old (inside the frozen normalization's range)
    C = [-jcolmap.qvec2rotmat(im[1]).T @ im[2] for im in upd]
    new = _images(rng, ["view_d.png", "view_e.png"], [2, 1],
                  centers=[(C[0] + C[1]) / 2, (C[1] + C[2]) / 2])
    new = [(4 + i, *im[1:]) for i, im in enumerate(new)]
    write_model_bin(tmp_path / "colmap_update" / "model", CAMERAS, upd + new, _points(rng))
    for im in new:
        cv2.imwrite(str(tmp_path / "colmap_update" / "images" / im[4]),
                    rng.integers(0, 255, (32, 48, 3)).astype(np.uint8))
    for mod, name in ((jprep, "jax"), (tprep, "port")):
        _prepare(mod, tmp_path / "colmap", tmp_path / name)
    _same_outputs(tmp_path / "port", tmp_path / "jax")
    for mod, name in ((jupd, "jax"), (tupd, "port")):
        _update(mod, tmp_path / "colmap_update", tmp_path / name)
    _same_outputs(tmp_path / "port", tmp_path / "jax")
    manifest = json.loads((tmp_path / "port" / "continual" / "b000" / "manifest.json").read_text())
    assert manifest["count"] == 2 and [i["id"] for i in manifest["items"]] == ["000003", "000004"]
    assert len((tmp_path / "port" / "mappings.txt").read_text().splitlines()) == 5


def test_a_camera_out_of_range_aborts_or_clips_in_both(tmp_path):
    rng = np.random.default_rng(3)
    _scene(tmp_path / "colmap", rng, ["a.png", "b.png", "c.png"], [1, 1, 1])
    _scene(tmp_path / "far", rng, ["z.png"], [1], far=True)
    for mod, name in ((jprep, "jax"), (tprep, "port")):
        _prepare(mod, tmp_path / "colmap", tmp_path / name)
    for mod, name in ((jupd, "jax"), (tupd, "port")):
        with pytest.raises(RuntimeError, match="exceeds normalized range"):
            _update(mod, tmp_path / "far", tmp_path / name)
    for name in ("jax", "port"):  # an aborted batch leaves its empty directories
        (tmp_path / name / "mappings.txt").write_text(
            (tmp_path / "jax" / "mappings.txt").read_text())
    for mod, name in ((jupd, "jax"), (tupd, "port")):
        _update(mod, tmp_path / "far", tmp_path / name, "--on_overflow", "clip")
    _same_outputs(tmp_path / "port", tmp_path / "jax")
    md = torch.load(next((tmp_path / "port" / "continual" / "b000" / "metadata").iterdir()),
                    weights_only=False)
    assert float(md["c2w"][:, 3].abs().max()) == 1.0
