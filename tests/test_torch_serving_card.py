"""Routed, single-expert and baked frames on the card against the CPU
(``requires_cuda``; they skip without a card).

This file imports nothing of ``acn_tpu``, so that it collects on the card's
machine:

    env JAX_PLATFORMS=cpu python -m pytest tests/test_torch_serving_card.py -q -m requires_cuda

A small random scene (``toy``'s quadrant layout, a 3-level hash grid,
30 % random 32³ grids, σ-head bias +2) at 48 × 64: the card's frames
against the CPU's, u8 rgb within one step (1/255), f16 depth and acc
within rtol 1e-3 / atol 1e-3 (cuBLAS sums the MLPs in another order; a
value near a rounding edge may land on the other side). The forward scan
runs once per chunk on the budget paths and never on budget 0.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from acn_tpu_torch import toy
from acn_tpu_torch.models.encodings import HashGridConfig
from acn_tpu_torch.models.ngp import NGPConfig
from acn_tpu_torch.occupancy.grid import OccConfig

H, W = 48, 64


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from acn_tpu_torch.ops import segscan

    return segscan


def _launches(segscan) -> tuple:
    """(composite forward, scan forward) launches so far."""
    from acn_tpu_torch.ops import composite

    return composite.launch_counts()[0], segscan.seg_excl_sum_kernel.launches


def _scene(device):
    cfg, P, _ = toy.train_occ_config()
    cfg = dataclasses.replace(cfg, bg_hidden=8, expert=NGPConfig(
        hidden=16, color_hidden=16, color_depth=2, hash=HashGridConfig(
            levels=3, min_res=4, max_res=32, log2_hashmap_size=10, features_per_level=2,
            layout="cell", dense_levels=True)))
    P = types.SimpleNamespace(**{**vars(P), "chunk_points": 40_000, "occ_s_max": 64,
                                 "occ_s_kept": 16, "occ_budget_per_ray": 8})
    occ_cfg = OccConfig(resolution=32, levels=1, alpha_thre=1e-2, near_plane=0.0,
                        far_plane=100.0)
    model = toy.serving_model(cfg, seed=3, device=device)
    with torch.no_grad():
        model.params()["experts"]["sigma_head"]["b"].fill_(2.0)
    boxes, _ = toy.quadrant_layout(4)
    occ = toy.random_occ_states(boxes, occ_cfg, fill=0.3, seed=1, device=device)
    return cfg, P, occ_cfg, model, occ


def _same(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=1.0 / 255 + 1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("budget,s_coarse", [(8, 0), (8, 16), (0, 0)])
def test_routed_frame_on_the_card_matches_the_cpu(budget, s_coarse):
    segscan = _card()
    from acn_tpu_torch.pipelines.renderer import Renderer

    frames, plans = [], []
    for dev in ("cuda", "cpu"):
        cfg, P, occ_cfg, model, occ = _scene(dev)
        P = types.SimpleNamespace(**{**vars(P), "occ_budget_per_ray": budget,
                                     "occ_render_s_coarse": s_coarse})
        r = Renderer(cfg, P, occ_cfg, device=dev)
        cam = toy.overhead_camera(H, W, lift=1.0)
        before = _launches(segscan)
        frames.append(r.render_image_routed(model, occ, H=H, W=W, blend_px=4, **cam))
        plans.append(len(r.routed_dispatch(
            r.routed_rects(model.expert_aabbs.cpu().numpy(), cam["c2w"], cam["intrinsics"],
                           H, W, 4), W, True)))
        if dev == "cuda":  # a composite launch a packed chunk, which scans itself
            got = tuple(b - a for a, b in zip(before, _launches(segscan)))
            assert got == ((plans[0] if budget else 0), 0)
    assert float(frames[1][2].max()) > 0.5
    _same(*frames)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("budget", [8, 0])
def test_baked_frame_on_the_card_matches_the_cpu(tmp_path, budget):
    segscan = _card()
    from acn_tpu_torch.pipelines import baking

    cfg, P, occ_cfg, model, occ = _scene("cuda")
    baking.save_baked(tmp_path / "a.npz", baking.bake_container(model, resolution=24,
                                                                occ_resolution=12))
    cam = toy.overhead_camera(H, W, lift=1.5)
    frames = []
    for dev in ("cuda", "cpu"):
        br = baking.BakedRenderer(baking.load_baked(tmp_path / "a.npz", device=dev),
                                  s_max=32, budget_per_ray=budget, chunk_points=20_000,
                                  s_coarse=16 if budget else 0)
        before = _launches(segscan)
        frames.append(br.render_image(H=H, W=W, intrinsics=cam["intrinsics"], c2w=cam["c2w"]))
        if dev == "cuda":
            chunks = -(-H // br.rows(W))
            got = tuple(b - a for a, b in zip(before, _launches(segscan)))
            assert got == ((chunks if budget else 0), 0)
    _same(*frames)


@pytest.mark.requires_cuda
def test_bake_on_the_card_matches_the_cpu():
    _card()
    from acn_tpu_torch.pipelines import baking

    tables = []
    for dev in ("cuda", "cpu"):
        cfg, P, occ_cfg, model, occ = _scene(dev)
        for sh in (0, 1):
            tables.append(baking.bake_container(model, resolution=16, chunk=1000,
                                                sh_degree=sh)["table"].cpu())
    for a, b in zip(tables[:2], tables[2:]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
