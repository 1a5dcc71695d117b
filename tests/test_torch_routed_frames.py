"""The port's routed frames (``render_image_routed``, its rects, feathers and
dispatch) against acn_tpu's, continued from tests/test_torch_routed.py
(split from it so that the test run spreads them over its workers): the
scene, frame size and tolerances are that file's.
"""

import numpy as np
import pytest

from acn_tpu.pipelines.renderer import Renderer as JRenderer
from acn_tpu_torch import toy
from acn_tpu_torch.pipelines.renderer import Renderer as TRenderer
from test_torch_routed import H, U8, W, _cmp_frames, _P, scene  # noqa: F401  (fixture)


# ------------------------------------------------------------ routed frames


def _quad_rects_jax_vs_port(aabbs, c2w, intr, h, w, pad):
    want = JRenderer._expert_rects(aabbs, c2w, intr, h, w, pad_px=pad)
    got = TRenderer._expert_rects(aabbs, c2w, intr, h, w, pad_px=pad)
    np.testing.assert_array_equal(got, want)
    for rect in got:
        for blend in (pad, 8):
            np.testing.assert_array_equal(TRenderer._feather_weights(rect, h, w, blend),
                                          JRenderer._feather_weights(rect, h, w, blend))
    return got


def test_expert_rects_and_feathers_exact():
    boxes, _ = toy.quadrant_layout(4)
    h = w = 64
    intr = np.array([0.7 * h, 0.7 * h, w / 2, h / 2], np.float32)
    cam = np.array([[0.0, 0.0, -1.0, -2.0], [0.0, 1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]],
                   np.float32)  # overhead at x = −2, looking down
    rects = _quad_rects_jax_vs_port(boxes, cam, intr, h, w, 2)
    areas = (rects[:, 1] - rects[:, 0]) * (rects[:, 3] - rects[:, 2])
    assert (areas < h * w).all()  # every quadrant crops
    inside = cam.copy()
    inside[:, 3] = (0.0, 0.5, 0.5)  # inside box 3
    rects = _quad_rects_jax_vs_port(boxes, inside, intr, h, w, 0)
    assert tuple(rects[3]) == (0, h, 0, w)
    behind = cam.copy()
    behind[:, 3] = (-2.0, 0.0, 0.7)  # the far z quadrants' corners behind the plane
    behind[:, :3] = np.array([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]],
                             np.float32) @ np.array(
        [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]], np.float32)
    rects = _quad_rects_jax_vs_port(boxes, behind, intr, h, w, 2)
    full = [tuple(r) == (0, h, 0, w) for r in rects]
    assert any(full) and not all(full)


@pytest.mark.parametrize("case", ["crop", "sky", "coarse"])
def test_render_image_routed_matches_jax(scene, case):
    """Quadrant rects that crop (blend 2 px), a far camera whose frame is
    mostly sky (the uncovered-pixel fallback), and the budget path with a
    16-bin pre-pass (the strided single-expert chunks are held by
    ``test_single_expert_frames_match_jax``)."""
    P = _P(scene, occ_budget_per_ray=8,
           occ_render_s_coarse=16 if case == "coarse" else 0)
    jr = JRenderer(scene.jcfg, P, scene.jocc_cfg)
    tr = TRenderer(scene.tcfg, P, scene.tocc_cfg, device="cpu")
    cam = toy.overhead_camera(H, W, lift=3.0 if case == "sky" else 1.0)
    rects = tr.routed_rects(scene.boxes, cam["c2w"], cam["intrinsics"], H, W, 2)
    if case == "crop":
        assert ((rects[:, 1] - rects[:, 0]) * (rects[:, 3] - rects[:, 2]) < H * W).all()
    if case == "sky":
        assert any(tuple(r) == (0, H, 0, W) for r in rects)  # the fallback
    want = jr.render_image_routed(scene.jvars, scene.jocc, H=H, W=W, blend_px=2, **cam)
    got = tr.render_image_routed(scene.model, scene.tocc, H=H, W=W, blend_px=2, **cam)
    _cmp_frames(got, want)
    if case == "sky":
        assert float(np.asarray(want[2]).min()) < 0.05 < float(np.asarray(want[2]).max())


def test_routed_dispatch_quantizes_crops_and_rows():
    """A crop is a multiple of 128 px re-anchored inside the frame, a chunk's
    rows the rect's height rounded up to 64 at most, and chunks carry K×
    the dense chunk's rays."""
    cfg, P, occ_cfg = toy.train_occ_config()
    r = TRenderer(cfg, P, occ_cfg, device="cpu")
    rects = np.array([[0, 649, 0, 1069], [500, 530, 1800, 1920], [0, 1080, 0, 1920]])
    plan = r.routed_dispatch(rects, 1920, True)
    by_k = {k: [p for p in plan if p[0] == k] for k in range(3)}
    assert {p[4] for p in by_k[0]} == {1152} and by_k[0][0][5] == 125_000 // 1152
    assert sum(p[2] for p in by_k[0]) == 649
    (k, r0, rows_this, c0, w_crop, rows), = by_k[1]
    assert (r0, rows_this, c0, w_crop, rows) == (500, 30, 1792, 128, 64)
    assert {p[4] for p in by_k[2]} == {1920} and by_k[2][0][5] == 125_000 // 1920


@pytest.mark.parametrize("budget", [64, 0])
def test_routed_equals_dense_with_identical_experts(scene, budget):
    """Every expert expert 0's weights, box and grid; the rects from the
    true quadrant boxes: the routed frame is the dense one (at a budget of
    every bin, so that no chunk overflows: a dense and a routed chunk hold
    other rays and would drop other samples)."""
    P = _P(scene, occ_budget_per_ray=budget)
    tr = TRenderer(scene.tcfg, P, scene.tocc_cfg, device="cpu")
    model, occ = toy.identical_experts(scene.model), toy.identical_occ(scene.tocc)
    cam = toy.overhead_camera(H, W, lift=1.0)
    dense = tr.render_image(model, occ, H=H, W=W, **cam)
    routed = tr.render_image_routed(model, occ, H=H, W=W, blend_px=2,
                                    expert_aabbs=scene.boxes, **cam)
    assert float(dense[2].max()) > 0.5
    np.testing.assert_allclose(routed[0], dense[0], atol=U8)
    for g, w in zip(routed[1:], dense[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)


def test_mesh_is_refused(scene):
    tr = TRenderer(scene.tcfg, _P(scene), scene.tocc_cfg, device="cpu")
    for fn in (tr.render_image, tr.render_image_routed):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            fn(scene.model, scene.tocc, H=H, W=W, mesh=object(), **toy.overhead_camera(H, W))
