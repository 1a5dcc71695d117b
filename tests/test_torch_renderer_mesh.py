"""Frames by row blocks over two CPU gloo ranks (``render_image(mesh=...)``,
``render_image_routed(mesh=...)``, ``BakedRenderer.render_image(mesh=...)``)
against ``acn_tpu``'s mesh render over 2 of conftest's virtual devices and
the port's single-rank render.

The scene is ``test_torch_routed``'s 4-expert one (σ-head bias +2, 30 %
occupied 16³ grids), 24 × 32 pixels, the packed-budget march at 32 samples
a ray over 64 bins (no overflow, so a chunk's other rays cannot change a
ray's samples); dense chunks of 64 rays (2 rows: a dispatch of 4 rows over
the 2 ranks, 6 dispatches, the last past the frame's bottom edge). The
dense frame has the ``random`` background: ``acn_tpu`` splits each
dispatch's key into one per slot, which the ranks replay from a table by
(dispatch, slot). The baked frame is ``test_torch_baking``'s random asset
at budget 8, 5 rows a chunk. A dense frame with a white sky is held against
the single rank's too. Frames agree within 1.5/255 in rgb (the dryrun's
tolerance), depth and acc within 2e-3; every rank returns the whole frame.
"""

import jax
import numpy as np
import pytest

from acn_tpu.parallel.mesh import make_render_mesh as jax_render_mesh
from acn_tpu.pipelines import baking as jbake
from acn_tpu.pipelines.renderer import Renderer as JRenderer
from acn_tpu_torch import toy
from acn_tpu_torch.parallel import launch
from acn_tpu_torch.pipelines import baking as tbake
from acn_tpu_torch.pipelines.renderer import Renderer as TRenderer
from test_torch_baking import _random_asset
from test_torch_models import small_scene

H, W = 24, 32
CHUNK = 64
RGB_ATOL = 1.5 / 255
N = 2
KINDS = ["dense", "routed", "baked", "dense_white"]


def _P(sc, **over):
    import types

    return types.SimpleNamespace(**{**vars(sc.P), "occ_s_kept": 16, "chunk_points": 4000,
                                    "occ_budget_per_ray": 32, **over})


def _dispatch_bg_table(key, rows):
    """The ``random`` background of each (dispatch, slot), as acn_tpu's
    mesh render draws it: the frame key split per dispatch, each dispatch's
    key split into N slots, a slot's key into (background, render)."""
    table = {}
    n_disp = -(-H // (rows * N))
    for c in range(n_disp):
        key, k = jax.random.split(key)
        for s, ks in enumerate(jax.random.split(k, N)):
            k_bg, _ = jax.random.split(ks)
            table[("bg", (c, s))] = np.array(jax.random.uniform(k_bg, (rows * W, 3)))
    return table


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    sc = small_scene(sigma_bias=2.0, alpha_thre=1e-2, budget=32, s_max=64, fill=0.3,
                     use_bg_nerf=False)
    jmesh = jax_render_mesh(jax.devices()[:N])
    cam = {**toy.overhead_camera(H, W), "aabb": sc.gaabb}
    rows = CHUNK // W
    P_dense = _P(sc, bg_color_default="random")
    P_routed = _P(sc)
    jb, tb = _random_asset(seed=5)
    bview = dict(H=H, W=W, intrinsics=cam["intrinsics"], c2w=cam["c2w"],
                 near_far_override=(0.2, None))
    bkw = dict(s_max=32, budget_per_ray=8, chunk_points=8 * W * 5, bg_color="black")

    want = {
        "dense": JRenderer(sc.jcfg, P_dense, sc.jocc_cfg, chunk_rays=CHUNK).render_image(
            sc.jvars, sc.jocc, H=H, W=W, mesh=jmesh, **cam),
        "routed": JRenderer(sc.jcfg, P_routed, sc.jocc_cfg, chunk_rays=CHUNK)
        .render_image_routed(sc.jvars, sc.jocc, H=H, W=W, mesh=jmesh, **cam),
        "baked": jbake.BakedRenderer(jb, **bkw).render_image(mesh=jmesh, **bview),
    }
    tr = lambda P: TRenderer(sc.tcfg, P, sc.tocc_cfg, chunk_rays=CHUNK, device="cpu")
    single = {
        "routed": tr(P_routed).render_image_routed(sc.model, sc.tocc, H=H, W=W, **cam),
        "baked": tbake.BakedRenderer(tb, **bkw).render_image(**bview),
        "dense_white": tr(P_routed).render_image(sc.model, sc.tocc, H=H, W=W, **cam),
    }
    table = _dispatch_bg_table(jax.random.PRNGKey(0), rows)
    ranks = launch.spawn("acn_tpu_torch.parallel.dryrun:frames_rank", N, dict(
        cfg=sc.tcfg, P=P_dense, occ_cfg=sc.tocc_cfg, model=sc.model, occ_states=sc.tocc,
        baked=tb, frames=[
            ("dense", dict(renderer={"chunk_rays": CHUNK}, H=H, W=W, draws=table, **cam)),
            ("routed", dict(renderer={"chunk_rays": CHUNK}, P=P_routed, H=H, W=W, **cam)),
            ("baked", dict(renderer=bkw, **bview)),
            ("dense", dict(renderer={"chunk_rays": CHUNK}, P=P_routed, H=H, W=W, **cam))]),
        tmp_path_factory.mktemp("frames"))
    return want, single, ranks


def _close(got, want):
    assert got[0].shape == (H, W, 3) and np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=RGB_ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("kind", ["dense", "routed", "baked"])
def test_row_block_frame_matches_acn_tpus_mesh_render(frames, kind):
    want, _, ranks = frames
    i = KINDS.index(kind)
    got = ranks[0]["frames"][i]
    _close(got, want[kind])
    for r in ranks[1:]:  # every rank returns the whole frame
        for a, b in zip(r["frames"][i], got):
            np.testing.assert_array_equal(a, b)
    if kind == "dense":  # the random sky differs between the ranks' blocks
        assert float(np.ptp(got[0][:, :, 0])) > 0.3


@pytest.mark.parametrize("kind", ["routed", "baked", "dense_white"])
def test_row_block_frame_matches_the_single_rank_render(frames, kind):
    """The fan-out moves rows between ranks and nothing else: the same
    frame as one rank's (the dense one with a white sky)."""
    _, single, ranks = frames
    _close(ranks[0]["frames"][KINDS.index(kind)], single[kind])
    assert ranks[0]["stats"]["host_collectives"] == len(KINDS)  # one gather a frame
