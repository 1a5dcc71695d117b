"""The port's dataset loaders (acn_tpu_torch.data: png, ray_prep,
image_metadata, ram_rays, dataset) against acn_tpu's, on a prepared
dataset directory that ``toy.write_dataset_dir`` writes in ``tmp_path``
(2 experts, 4 train and 2 val images of 24 × 32, PNG images, zipped masks).

Exact throughout: the PNG codec gives PIL's pixels for every row filter,
``ray_prep`` is bit-equal (hypothesis), and every loader's output, down to
``get_dataset``'s per-expert ``rays`` / ``rgbs`` / ``img_indices`` with the
validation balancing, is bit-equal to acn_tpu's (which reads the PNGs
through PIL). Both packages' ray caches point into ``tmp_path``.
"""

import io
import shutil
import struct
import sys
import types
import zlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

from acn_tpu.data import dataset as jds
from acn_tpu.data import image_metadata as jim
from acn_tpu.data import ram_rays as jrr
from acn_tpu.data import ray_prep as jrp
from acn_tpu_torch import toy
from acn_tpu_torch.data import dataset as tds
from acn_tpu_torch.data import image_metadata as tim
from acn_tpu_torch.data import png
from acn_tpu_torch.data import ram_rays as trr
from acn_tpu_torch.data import ray_prep as trp

K, TRAIN, VAL, H, W = 2, 4, 2, 24, 32


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    toy.write_dataset_dir(root, K=K, train_cams=TRAIN, val_cams=VAL, H=H, W=W)
    return root


@pytest.fixture(autouse=True)
def caches(tmp_path, monkeypatch):
    monkeypatch.setattr(tds, "RAY_CACHE", tmp_path / "port_rays")
    monkeypatch.setenv("ACN_TPU_RAY_CACHE", str(tmp_path / "jax_rays"))


def _P(root, **over):
    return types.SimpleNamespace(**{**dict(
        dataset="drz", data_path=str(root), data_dirname="example",
        mask_dirname="g22_grid_bm110_ss11", num_submodules=K, downscale=0.25,
        cap_images=None, num_workers=1), **over})


# ------------------------------------------------------------------ PNG


def _filters_of(data: bytes, width: int, bpp: int) -> set:
    idat, pos = b"", 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    stride = width * bpp + 1
    return {raw[i] for i in range(0, len(raw), stride)}


def _image(channels, seed=0):
    """Noise beside smooth ramps: PIL's adaptive filtering picks every
    filter type for such rows."""
    rng = np.random.default_rng(seed)
    img = (rng.random((31, 45, channels)) * 255).astype(np.uint8)
    img[:, :20] = (np.arange(20)[None, :, None] * 7 + np.arange(31)[:, None, None] * 3) % 256
    img[10:20] = img[9:10]
    return img


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("channels", (3, 4))
def test_png_each_filter_reads_as_pil_reads_it(filter_type, channels):
    img = _image(channels)
    data = png.encode_png(img, filter_type)
    assert _filters_of(data, 45, channels) == {filter_type}
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pil, img)
    np.testing.assert_array_equal(png.decode_png(data), img)


@pytest.mark.parametrize("channels", (3, 4))
def test_png_written_by_pil_decodes_to_pils_pixels(tmp_path, channels):
    seen = set()
    for seed, kw in enumerate(({}, {"optimize": True}, {"compress_level": 1})):
        img = _image(channels, seed)
        path = tmp_path / f"{seed}.png"
        Image.fromarray(img).save(path, **kw)
        seen |= _filters_of(path.read_bytes(), 45, channels)
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(png.read_png(path), want)
    assert seen >= {1, 2, 3, 4}  # PIL wrote every filter but None


@pytest.mark.parametrize("channels", (3, 4))
def test_png_rows_of_mixed_filters_read_as_pil_reads_them(channels):
    """One filter per row, each of the five types on some row: the rows
    with Average or Paeth send the whole image through the diagonal
    decoder, which then undoes the other types too."""
    img = _image(channels, 3)
    types = np.random.default_rng(1).integers(0, 5, 31)
    data = png.encode_png(img, types)
    assert _filters_of(data, 45, channels) == set(range(5))
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    np.testing.assert_array_equal(png.decode_png(data), img)


def test_png_refuses_what_it_cannot_read(tmp_path):
    gray = tmp_path / "g.png"
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(gray)
    with pytest.raises(ValueError, match="8-bit RGB/RGBA"):
        png.read_png(gray)
    pal = tmp_path / "p.png"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("P").save(pal)
    with pytest.raises(ValueError, match="8-bit RGB/RGBA"):
        png.read_png(pal)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a")


# -------------------------------------------------------------- ray_prep


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 9), w=st.integers(1, 9), seed=st.integers(0, 2**16),
       center=st.booleans(), use_aabb=st.booleans(),
       near=st.one_of(st.none(), st.floats(0, 2)), far=st.one_of(st.none(), st.floats(0, 4)))
def test_ray_prep_bit_equal(h, w, seed, center, use_aabb, near, far):
    rng = np.random.default_rng(seed)
    fx, fy = rng.uniform(3, 50, 2)
    cx, cy = rng.uniform(0, w), rng.uniform(0, h)
    dj = jrp.get_ray_directions_np(h, w, fx, fy, cx, cy, center)
    dt = trp.get_ray_directions_np(h, w, fx, fy, cx, cy, center)
    np.testing.assert_array_equal(dt, dj)
    c2w = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                          rng.normal(size=(3, 1))], 1).astype(np.float32)
    aabb = np.sort(rng.normal(size=(2, 3)), axis=0).astype(np.float32) if use_aabb else None
    kw = {} if use_aabb else {"near": 0.1, "far": 5.0}
    rj = jrp.get_rays_np(dj, c2w, aabb=aabb, **kw).reshape(-1, 8)
    rt = trp.get_rays_np(dt, c2w, aabb=aabb, **kw).reshape(-1, 8)
    np.testing.assert_array_equal(rt, rj)
    for override in (None, (near, far)):
        (a, va), (b, vb) = (trp.clamp_rays_near_far_np(rt, override),
                            jrp.clamp_rays_near_far_np(rj, override))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(va, vb)


# --------------------------------------------------------------- loaders


def _same_md(a, b):
    assert a.image_path == b.image_path and a.image_index == b.image_index
    assert (a.W, a.H, a.is_val, a.mask_dir) == (b.W, b.H, b.is_val, b.mask_dir)
    np.testing.assert_array_equal(a.c2w, b.c2w)
    np.testing.assert_array_equal(a.intrinsics, b.intrinsics)


def test_metadata_images_and_masks_equal_acn_tpus(data_root):
    data = data_root / "out" / "example"
    assert tds.load_coordinates(data).keys() == jds.load_coordinates(data).keys()
    mask_root = data / "masks" / "g22_grid_bm110_ss11"
    assert tds.discover_cluster_cells(mask_root) == jds.discover_cluster_cells(mask_root) == K
    tc, jc = tds.load_clustering_meta(mask_root), jds.load_clustering_meta(mask_root)
    assert tc.keys() == jc.keys()
    np.testing.assert_array_equal(tc["centroids"], jc["centroids"])
    for a, b in zip(tds.load_scene_boxes(mask_root), jds.load_scene_boxes(mask_root)):
        np.testing.assert_array_equal(a, b)
    for cell in (None, mask_root / "1"):
        (tt, tv), (jt, jv) = (tds.get_image_metadata(data, 0.25, cell),
                              jds.get_image_metadata(data, 0.25, cell))
        assert (len(tt), len(tv)) == (len(jt), len(jv)) == (TRAIN, VAL)
        for a, b in zip(tt + tv, jt + jv):
            _same_md(a, b)
            assert (a.H, a.W) == (H, W)
            np.testing.assert_array_equal(a.load_image(), b.load_image())
            ma, mb = a.load_mask(), b.load_mask()
            assert (ma is None) == (mb is None) == (cell is None)
            if ma is not None:
                np.testing.assert_array_equal(ma, mb)
    # only_test, and a random cap
    assert tds.get_image_metadata(data, 0.25, only_test=True)[0] == []
    capped = tds.cap_metadata(tt, 3)
    want = jds.cap_metadata(jt, 3)
    assert [m.image_index for m in capped] == [m.image_index for m in want]


def test_mask_at_another_size_and_plain_pt(tmp_path):
    import torch

    md = tim.ImageMetadata(tmp_path / "a.png", np.eye(3, 4, dtype=np.float32), 6, 4,
                           np.ones(4, np.float32), 0, mask_dir=tmp_path)
    jmd = jim.ImageMetadata(**vars(md))
    m = np.random.default_rng(0).random((8, 12)) < 0.5
    torch.save(torch.from_numpy(m), tmp_path / "a.pt")  # plain, twice the size
    np.testing.assert_array_equal(md.load_mask(), jmd.load_mask())
    assert md.load_mask().shape == (4, 6)
    torch.save(torch.from_numpy(m.reshape(-1)[:24]), tmp_path / "a.pt")  # flat (H·W,)
    np.testing.assert_array_equal(md.load_mask(), jmd.load_mask())


def test_jpeg_and_resize_go_through_pil(tmp_path, monkeypatch):
    img = _image(3)[:, :, :3]
    Image.fromarray(img).save(tmp_path / "a.jpg", quality=90)
    Image.fromarray(img).save(tmp_path / "b.png")
    for name, (w, h) in (("a.jpg", (45, 31)), ("a.jpg", (20, 14)), ("b.png", (20, 14))):
        md = tim.ImageMetadata(tmp_path / name, np.eye(3, 4, dtype=np.float32), w, h,
                               np.ones(4, np.float32), 0)
        np.testing.assert_array_equal(md.load_image(),
                                      jim.ImageMetadata(**vars(md)).load_image())
    # without PIL the PNG at its record's size still loads; the rest names PIL
    monkeypatch.setitem(sys.modules, "PIL", None)
    ok = tim.ImageMetadata(tmp_path / "b.png", np.eye(3, 4, dtype=np.float32), 45, 31,
                           np.ones(4, np.float32), 0)
    np.testing.assert_array_equal(ok.load_image(), img)
    for name, (w, h) in (("a.jpg", (45, 31)), ("b.png", (20, 14))):
        md = tim.ImageMetadata(tmp_path / name, np.eye(3, 4, dtype=np.float32), w, h,
                               np.ones(4, np.float32), 0)
        with pytest.raises(ImportError, match="PIL"):
            md.load_image()


def _same_store(a, b):
    assert a.num_images == b.num_images and len(a) == len(b) > 0
    np.testing.assert_array_equal(a.rays, b.rays)
    np.testing.assert_array_equal(a.rgbs, b.rgbs)
    np.testing.assert_array_equal(a.img_indices, b.img_indices)
    assert a.rays.dtype == np.float32 and a.img_indices.dtype == np.int32


@pytest.mark.parametrize("cap", (None, 3))
def test_get_dataset_per_expert_arrays_bit_equal(data_root, cap):
    P = _P(data_root, cap_images=cap)
    mask_root = data_root / "out" / "example" / "masks" / P.mask_dirname
    gaabb, eaabbs = tds.load_scene_boxes(mask_root)
    kw = dict(expert_aabbs=eaabbs, global_aabb=gaabb, near_far_override=(0.0, 1e5))
    got = tds.get_dataset(P, **kw)
    want = jds.get_dataset(P, **kw)
    for g_sets, w_sets in zip(got, want):
        assert len(g_sets) == len(w_sets) == K
        for a, b in zip(g_sets, w_sets):
            _same_store(a, b)
    # the validation stores are balanced: no kept ray from an image's right half
    assert all(len(v) < VAL * H * W for v in got[1])
    # the second call reads the cache, to the same arrays
    again = tds.get_dataset(P, **kw)
    for a, b in zip(again[0] + again[1], got[0] + got[1]):
        _same_store(a, b)
    # only_test
    none, val = tds.get_dataset(P, only_test=True, **kw)
    assert none is None and len(val) == K


def test_ray_cache_rebuilds_an_unreadable_file(data_root, tmp_path):
    P = _P(data_root)
    kw = dict(global_aabb=toy.SCENE_AABB, near_far_override=(0.0, 1e5))
    built = tds.get_dataset(P, **kw)[0]
    files = sorted((tmp_path / "port_rays").glob("*.npz"))
    assert files
    for f in files:
        f.write_bytes(b"truncated")
    again = tds.get_dataset(P, **kw)[0]
    for a, b in zip(again, built):
        _same_store(a, b)


def test_flat_layout(data_root, tmp_path):
    """The continual-batch layout: ``{metadata,rgbs}`` at the dataset's root,
    every image a val image; ``--mask_dirname`` unset gives one flat store."""
    src = data_root / "out" / "example"
    flat = tmp_path / "flat" / "out" / "example"
    flat.mkdir(parents=True)
    shutil.copy(src / "coordinates.pt", flat)
    for sub in ("metadata", "rgbs"):
        shutil.copytree(src / "train" / sub, flat / sub)
    (tt, tv), (jt, jv) = tds.get_image_metadata(flat, 0.25), jds.get_image_metadata(flat, 0.25)
    assert tt == jt == [] and len(tv) == len(jv) == TRAIN
    for a, b in zip(tv, jv):
        _same_md(a, b)
    P = _P(tmp_path / "flat", mask_dirname=None)
    kw = dict(global_aabb=toy.SCENE_AABB, near_far_override=(0.0, 1e5))
    got, want = tds.get_dataset(P, **kw), jds.get_dataset(P, **kw)
    assert len(got[0]) == len(want[0]) == 1 and len(got[0][0]) == len(want[0][0]) == 0
    assert len(got[1]) == len(want[1]) == 1
    _same_store(got[1][0], want[1][0])


def test_ram_rays_worker_pool_equals_serial(data_root):
    """More than 8 images and 2 workers: the spawn pool gives the serial
    build's arrays."""
    data = data_root / "out" / "example"
    train, val = tds.get_image_metadata(data, 0.25, data / "masks" / "g22_grid_bm110_ss11" / "0")
    items = (train + val) * 2
    kw = dict(val_balancing=True, aabb=toy.SCENE_AABB, near_far_override=(0.0, 1e5))
    pooled = trr.RamRaysDataset(items, num_workers=2, **kw)
    serial = trr.RamRaysDataset(items, num_workers=1, **kw)
    _same_store(pooled, serial)
    _same_store(serial, jrr.RamRaysDataset(items, num_workers=1, **kw))


def test_val_balancing_equals_acn_tpus():
    rng = np.random.default_rng(0)
    for h, w in ((5, 8), (6, 7), (1, 3)):
        m = rng.random((h, w)) < 0.4
        np.testing.assert_array_equal(
            trr.apply_meganerf_val_balancing(m, h, w, np.random.default_rng(3)),
            jrr.apply_meganerf_val_balancing(m, h, w, np.random.default_rng(3)))
