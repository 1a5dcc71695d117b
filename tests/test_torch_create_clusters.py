"""The port's cluster-mask tool (acn_tpu_torch.scripts.create_clusters)
against acn_tpu's.

* ``grid_centroids`` and ``kmeans_plusplus`` (both initializations, with and
  without weights): bit for bit, the same seed.
* The routing (``make_voronoi_kernel``) on the CPU against JAX's jitted
  router on the same rays: deep rays, rays on a Voronoi boundary, invalid
  (near > far) and infinite rays, a padded tail chunk; margins 1.0 and 1.1,
  ``cluster_2d`` on and off, 4 and 9 cells. Masks and counts equal except at
  ties; under ``jit`` XLA fuses ``o + d·t`` into a multiply-add, so a sample
  may move by an ulp, and one within rounding of a boundary may change cell.
  A differing pixel must be such a tie (``|d² − m²·d²min| / d²min`` below
  ``TIE_RTOL`` for one of its samples); the boxes agree to ``BOX_ULPS``
  float32 ulps of the
  operands' scale. On these inputs no pixel differs.
* ``main`` of both packages on the COLMAP model that
  ``tests/test_torch_dataset_tools.py`` prepares (grid and k-means++
  centroids): the masks byte for byte, ``params.pt`` equal,
  ``scene_boxes.pt`` equal but its boxes (within ``BOX_ATOL``) and
  ``scene_boxes.txt`` equal; a 2-rank run of the port byte-identical to its
  single run; ``--resume`` routes only the image whose masks are missing.
* ``--op train`` of the port for 2 steps on a ``toy`` dataset whose masks
  the port's tool rewrote.
"""

import numpy as np
import pytest
import torch

from acn_tpu.scripts import create_clusters as jcc
from acn_tpu_torch import runner as trunner
from acn_tpu_torch import toy
from acn_tpu_torch.data import dataset as tds
from acn_tpu_torch.data import tasks as ttasks
from acn_tpu_torch.data.ray_prep import get_ray_directions_np, get_rays_np
from acn_tpu_torch.scripts import create_clusters as tcc
from acn_tpu_torch.scripts import prepare_dataset as tprep
from acn_tpu_torch.scripts.log_mask_info import load_mask
from test_torch_dataset_tools import _prepare, _scene

TIE_RTOL = 1e-5  # relative distance of a sample from a cell's boundary
# boxes: a coordinate is o + d·t with |o|, |d·t| ≤ 2 here, so a fused or an
# unfused multiply-add differ by an ulp of 2 however small the sum; allowed:
# BOX_ULPS float32 ulps of 2 (9.5e-7; measured ≤ 2 ulps)
BOX_ULPS = 4
BOX_ATOL = BOX_ULPS * float(np.spacing(np.float32(2.0)))


def test_centroids_equal_jax():
    rng = np.random.default_rng(0)
    cams = rng.uniform(-1, 1, (23, 3)).astype(np.float32)
    for dims, c2d in (((1, 2, 2), True), ((1, 3, 3), True), ((2, 2, 2), False)):
        np.testing.assert_array_equal(tcc.grid_centroids(cams, *dims, c2d),
                                      jcc.grid_centroids(cams, *dims, c2d))
    np.testing.assert_array_equal(tcc.grid_centroids(cams[:0], 1, 2, 2, True),
                                  jcc.grid_centroids(cams[:0], 1, 2, 2, True))
    w = rng.uniform(1, 5, 23)
    for init in ("kmeans++", "random"):
        for weights in (None, w):
            for pts in (cams, cams[:, 1:]):
                got = tcc.kmeans_plusplus(pts, 4, 10, 3, weights, init)
                want = jcc.kmeans_plusplus(pts, 4, 10, 3, weights, init)
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(got, want)


def _d2(points, cents, cluster_2d):
    s = 1 if cluster_2d else 0
    return ((points[..., None, s:] - cents[:, s:]) ** 2).sum(-1)


def tie_rays(rays, cents, cluster_2d, margin, S):
    """Per ray, the number of its (sample, cell) pairs within ``TIE_RTOL``
    of the cell's boundary at ``margin`` (float64): where two roundings may
    decide otherwise."""
    r = rays.astype(np.float64)
    z = np.linspace(0.0, 1.0, S)
    t = r[:, 6:7] * (1 - z) + r[:, 7:8] * z
    x = r[:, None, :3] + r[:, None, 3:6] * t[..., None]
    d2 = _d2(x, cents.astype(np.float64), cluster_2d)  # (R, S, C)
    d2min = d2.min(-1, keepdims=True)
    gap = np.abs(d2 - margin ** 2 * d2min) / np.maximum(d2min, 1e-30)
    if margin == 1.0:  # the nearest cell itself is no tie
        gap[np.arange(len(r))[:, None], np.arange(S)[None], d2.argmin(-1)] = np.inf
    valid = np.isfinite(r[:, 6]) & np.isfinite(r[:, 7]) & (r[:, 7] > r[:, 6])
    return np.where(valid, (gap < TIE_RTOL).sum(axis=(1, 2)), 0)


def assert_boxes_close(got, want):
    assert got.dtype == want.dtype == np.float32
    assert (np.isinf(got) == np.isinf(want)).all()
    diff = np.where(got == want, 0.0, np.abs(got.astype(np.float64) - want))
    assert diff.max() <= BOX_ATOL, diff


def _rays(rng, n, cents):
    """Rays falling through the scene (X is Down): random ones; three on the
    boundary plane between cells 0 and 1; invalid and infinite ones."""
    o = np.concatenate([np.full((n, 1), -1.5), rng.uniform(-1, 1, (n, 2))], 1)
    d = rng.normal(size=(n, 3))
    d[:, 0] = np.abs(d[:, 0]) + 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nf = np.stack([rng.uniform(0.2, 0.8, n), rng.uniform(1.5, 3.0, n)], 1)
    rays = np.concatenate([o, d, nf], 1).astype(np.float32)
    mid = 0.5 * (cents[0] + cents[1])
    rays[:3, :3] = mid - [1.0, 0.0, 0.0]
    rays[:3, 3:6] = [1.0, 0.0, 0.0]  # straight down through the midpoint
    rays[3:6, 6], rays[3:6, 7] = 1.0, 0.0  # near > far
    rays[6:9, 6] = np.inf
    rays[9:12, 7] = np.inf
    return rays


@pytest.mark.parametrize("C", [4, 9])
@pytest.mark.parametrize("cluster_2d", [True, False])
@pytest.mark.parametrize("margin", [1.0, 1.1])
def test_routing_matches_jax(C, cluster_2d, margin):
    rng = np.random.default_rng(C + 10 * cluster_2d + int(100 * margin))
    cents = rng.uniform(-0.8, 0.8, (C, 3)).astype(np.float32)
    cents[1, 1:] = -cents[0, 1:]  # cells 0 and 1 about the vertical axis
    cents[1, 0] = cents[0, 0]
    rays = _rays(rng, 2500, cents)  # 3 chunks of 1,024, the last padded
    S = 32
    got = tcc.make_voronoi_kernel(cents, cluster_2d, margin, S, chunk=1024, device="cpu")(rays)
    want = jcc.make_voronoi_kernel(cents, cluster_2d, margin, S, chunk=1024)(rays)
    mask, mins, maxs, counts = got
    assert mask.shape == (2500, C) and mask.dtype == bool and counts.dtype == np.int64
    assert not mask[3:12].any()  # invalid and infinite rays assign nothing
    assert mask[:3].sum(1).min() >= 1
    ties = tie_rays(rays, cents, cluster_2d, margin, S) > 0
    differ = (mask != want[0]).any(1)
    assert not (differ & ~ties).any(), np.nonzero(differ & ~ties)
    assert differ.sum() == 0  # stated: no tie flipped on these inputs
    np.testing.assert_array_equal(counts, want[3])
    assert counts.sum() > 0
    assert_boxes_close(mins, want[1])
    assert_boxes_close(maxs, want[2])


def test_routing_of_a_boundary_ray_in_both():
    """A ray down the plane between two cells: at margin 1 both packages give
    it to the first cell (argmin's first of tied values), at margin 1.5 to
    both (``tests/test_data_tools.py``'s case)."""
    cents = np.array([[0.0, -0.5, 0.0], [0.0, 0.5, 0.0]], np.float32)
    rays = np.array([[-2, -0.5, 0, 1, 0, 0, 0.0, 4.0], [-2, 0.5, 0, 1, 0, 0, 0.0, 4.0],
                     [-2, 0.0, 0, 1, 0, 0, 0.0, 4.0]], np.float32)
    for margin, boundary in ((1.0, [True, False]), (1.5, [True, True])):
        got = tcc.make_voronoi_kernel(cents, True, margin, 16, chunk=4, device="cpu")(rays)
        want = jcc.make_voronoi_kernel(cents, True, margin, 16, chunk=4)(rays)
        assert got[0][2].tolist() == boundary
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("margin", [1.0, 1.1])
def test_routing_on_the_card_matches_the_cpu(margin):
    """The card against the CPU at the tool's defaults (256 samples, chunks
    of 8,192, a tail chunk): differing rays only at ties, counts apart by no
    more than the tie samples, boxes within ``BOX_ATOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    cents = rng.uniform(-0.8, 0.8, (4, 3)).astype(np.float32)
    rays = _rays(rng, 20_000, cents)
    got = tcc.make_voronoi_kernel(cents, True, margin, 256, device="cuda")(rays)
    want = tcc.make_voronoi_kernel(cents, True, margin, 256, device="cpu")(rays)
    ties = tie_rays(rays, cents, True, margin, 256)
    differ = (got[0] != want[0]).any(1)
    assert not (differ & (ties == 0)).any()
    assert np.abs(got[3] - want[3]).sum() <= ties.sum()
    for i in (1, 2):
        assert_boxes_close(got[i], want[i])


def test_the_router_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcc.make_voronoi_kernel(np.zeros((2, 3), np.float32), True, 1.0, 4)


def _flags(data, out, *extra, mode="grid"):
    return ["--data_path", str(data), "--output", out, "--centroid_mode", mode,
            "--grid_dim", "2", "2", "--cluster_2d", "--boundary_margin", "1.1",
            "--ray_samples", "32", "--center_pixels", "--scene_scale", "1.1",
            "--ray_chunk_size", "1024", *extra]


def _run(mod, argv):
    return mod.main(mod.build_parser().parse_args(argv))


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The COLMAP model of ``test_torch_dataset_tools.py`` (3 views of
    48 × 32), prepared by the port's tool."""
    root = tmp_path_factory.mktemp("cc")
    _scene(root / "colmap", np.random.default_rng(2), ["a.png", "b.png", "c.png"], [1, 2, 3])
    _prepare(tprep, root / "colmap", root / "data")
    return root / "data"


def _masks(d):
    return sorted(p.relative_to(d) for p in d.rglob("*.pt") if p.parent.name.isdigit())


def _image_rays(data, mask_dir, name):
    """The rays ``main`` routed for image ``name`` (downscale 1)."""
    md = torch.load(next(data.glob(f"*/metadata/{name}")), weights_only=False)
    params = torch.load(mask_dir / "params.pt", weights_only=False)
    fx, fy, cx, cy = [float(v) for v in md["intrinsics"][:4]]
    dirs = get_ray_directions_np(int(md["H"]), int(md["W"]), fx, fy, cx, cy, True)
    return get_rays_np(dirs, np.asarray(md["c2w"], np.float32),
                       aabb=params["aabb_global"].numpy()).reshape(-1, 8)


@pytest.mark.parametrize("mode", ["grid", "kmeans"])
def test_main_writes_what_acn_tpu_writes(prepared, mode):
    out_t, out_j = f"port_{mode}", f"jax_{mode}"
    _run(tcc, _flags(prepared, out_t, "--device", "cpu", mode=mode))
    _run(jcc, _flags(prepared, out_j, mode=mode))
    t, j = prepared / "masks" / out_t, prepared / "masks" / out_j
    files = _masks(j)
    assert _masks(t) == files and len(files) == 4 * 3
    params = torch.load(j / "params.pt", weights_only=False)
    ties = 0
    for rel in files:
        a, b = (t / rel).read_bytes(), (j / rel).read_bytes()
        if a == b:
            continue
        ma, mb = load_mask(t / rel), load_mask(j / rel)
        tie = tie_rays(_image_rays(prepared, j, rel.name), params["centroids"].numpy(),
                       True, 1.1, 32).reshape(ma.shape) > 0
        assert not ((ma != mb) & ~tie).any(), rel
        ties += int((ma != mb).sum())
    assert ties == 0  # stated: every mask byte-equal on this dataset
    pt, pj = (torch.load(d / "params.pt", weights_only=False) for d in (t, j))
    assert sorted(pt) == sorted(pj)
    for k in pj:
        if isinstance(pj[k], torch.Tensor):
            assert torch.equal(pt[k], pj[k]), k
        else:
            assert pt[k] == pj[k], k
    bt, bj = (torch.load(d / "scene_boxes.pt", weights_only=False) for d in (t, j))
    assert sorted(bt) == sorted(bj)
    for k in bj:
        if k in ("mins", "maxs"):
            assert_boxes_close(bt[k].numpy(), bj[k].numpy())
        elif isinstance(bj[k], torch.Tensor):
            assert bt[k].dtype == bj[k].dtype and torch.equal(bt[k], bj[k]), k
        else:
            assert bt[k] == bj[k], k
    # the grid leaves one expert empty here, so its ε-box is compared too
    assert bt["counts"].dtype == torch.int64 and int(bt["counts"].sum()) > 0
    assert (t / "scene_boxes.txt").read_text() == (j / "scene_boxes.txt").read_text()


def test_two_ranks_write_the_single_run_and_resume_skips_done_images(prepared):
    base = _flags(prepared, "sp", "--device", "cpu")
    single = _run(tcc, base)
    assert single["images"] == 3
    mp = _flags(prepared, "mp", "--device", "cpu")
    assert _run(tcc, mp + ["--rank", "1", "--world_size", "2"])["images"] == 1
    assert _run(tcc, mp + ["--rank", "0", "--world_size", "2",
                           "--merge_timeout", "60"])["images"] == 2
    sp, mpd = prepared / "masks" / "sp", prepared / "masks" / "mp"
    files = _masks(sp)
    assert _masks(mpd) == files and len(files) == 12
    for rel in files:
        assert (sp / rel).read_bytes() == (mpd / rel).read_bytes(), rel
    for name in ("params.pt", "scene_boxes.pt"):
        a, b = (torch.load(d / name, weights_only=False) for d in (sp, mpd))
        for k in b:
            assert (torch.equal(a[k], b[k]) if isinstance(b[k], torch.Tensor)
                    else a[k] == b[k]), (name, k)
    # --resume: only the image whose mask went missing is routed again
    victim = sp / files[0]
    want = victim.read_bytes()
    victim.unlink()
    assert _run(tcc, base + ["--resume"])["images"] == 1
    assert victim.read_bytes() == want


def test_rank_outside_the_world_is_refused(prepared):
    with pytest.raises(ValueError, match="outside world"):
        _run(tcc, _flags(prepared, "bad", "--device", "cpu", "--rank", "2",
                         "--world_size", "2"))


def test_port_trains_on_the_ports_masks(tmp_path, monkeypatch):
    from test_torch_runner import _argv  # imports acn_tpu's runner (flax)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tds, "RAY_CACHE", tmp_path / "rays")
    monkeypatch.setattr(ttasks, "ROUTE_CACHE", tmp_path / "routes")
    root = tmp_path / "ds"
    data = toy.write_dataset_dir(root, K=2, train_cams=6, val_cams=2, H=24, W=32)
    mask_dir = data / "masks" / "g22_grid_bm110_ss11"
    before = (mask_dir / "0" / "000000.pt").read_bytes()
    _run(tcc, ["--data_path", str(data), "--output", "g22_grid_bm110_ss11",
               "--grid_dim", "2", "1", "--cluster_2d", "--boundary_margin", "1.1",
               "--ray_samples", "32", "--center_pixels", "--downscale", "0.25",
               "--altitude_range", "-1", "1", "--device", "cpu"])
    assert (mask_dir / "0" / "000000.pt").read_bytes() != before
    boxes = torch.load(mask_dir / "scene_boxes.pt", weights_only=False)
    assert int(boxes["counts"].min()) > 0
    out = trunner.main(_argv(root, "train_occ", "--fname", "on_masks", "--outer_steps", "2",
                             "--occ_warmup", "2", "--eval_step", "2", "--save_step", "2",
                             "--print_step", "1", "--watchdog_timeout", "0"), device="cpu")
    steps = out["loop"]["steps"]
    assert [s["step"] for s in steps] == [1, 2]
    assert all(np.isfinite(float(s["metrics"]["loss_total"])) for s in steps)
    np.testing.assert_array_equal(out["model"].expert_aabbs.numpy(),
                                  np.stack([boxes["mins"], boxes["maxs"]], 1))
