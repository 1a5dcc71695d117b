"""The eval's tests on the card (``requires_cuda``), and the micro run that
they and ``test_torch_eval.py`` / ``test_torch_runner.py`` share.

This file imports nothing of ``acn_tpu``, so that it collects on the card's
machine, which has JAX but not flax:

    env JAX_PLATFORMS=cpu python -m pytest tests/test_torch_eval_card.py -q -m requires_cuda

* SSIM under cuDNN (``resolve_device`` turns TF32 off): inside [-1, 1] (to
  a float32 ulp) on random and near-constant images, atol 1e-5 against the
  CPU: cuDNN sums the blur in another order, and the variances E[x²] − μ²
  cancel terms of ≈ 0.1–0.3 down to ≈ 1e-3, so a float32 rounding of the
  blurred terms shows in SSIM (measured at most 1.13e-6 on these images).
* One eval frame of the packed-budget renderer launches the forward scan
  once per chunk.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from acn_tpu_torch import toy
from acn_tpu_torch import runner as trunner
from acn_tpu_torch.data import dataset as tds
from acn_tpu_torch.models import container as tcont
from acn_tpu_torch.nerfs import losses as tlosses
from acn_tpu_torch.pipelines.online_stage import runtime_adapt as trt
from acn_tpu_torch.utils import checkpoint as tck
from acn_tpu_torch.utils.config import parse_args as tparse

REPO = Path(__file__).resolve().parent.parent
K = 2
# a micro model and run over configs/*.json: 2 hash levels, 8-wide MLPs
TINY = ["--data_dirname", "example", "--num_submodules", str(K), "--log2_hashmap_size", "10",
        "--hash_levels", "2", "--dim_hidden", "8", "--color_hidden", "8", "--bg_hidden", "8",
        "--max_res", "64", "--support_rays", "64", "--query_rays", "32", "--inner_iter", "1",
        "--batch_size", "1", "--ray_samples", "8", "--occ_s_max", "16", "--occ_s_kept", "8",
        "--chunk_points", "20000", "--max_test_tasks", "1", "--num_workers", "1"]


def _model_with_content(argv, data):
    """A fresh model of ``argv``'s config over the dataset's layout: random
    weights, σ-head bias +2 (so that the views have content), and 30 %
    occupied grids over each expert's box."""
    P = tparse(argv)
    masks = data / "out" / "example" / "masks" / P.mask_dirname
    meta = tds.load_clustering_meta(masks)
    gaabb, eaabbs = tds.load_scene_boxes(masks)
    cfg = trunner.build_model_configs(P, meta)
    model = tcont.init_container(cfg, torch.from_numpy(meta["centroids"]),
                                 torch.from_numpy(eaabbs), torch.from_numpy(gaabb),
                                 generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        model.params()["experts"]["sigma_head"]["b"].fill_(2.0)
    occ = trunner.init_occ_states(model.expert_aabbs, trunner.build_occ_config(P, 1.0))
    rng = np.random.default_rng(0)
    occ["binaries"] = torch.from_numpy(rng.random(tuple(occ["binaries"].shape)) < 0.3)
    return P, model, occ


@pytest.fixture(scope="module")
def eval_run(tmp_path_factory):
    """A dataset and a port checkpoint ``last`` with its grids."""
    root = tmp_path_factory.mktemp("evalrun")
    toy.write_dataset_dir(root / "data", K=K, train_cams=4, val_cams=2, H=24, W=32)
    argv = ["--configPath", str(REPO / "configs" / "train_occ.json"),
            "--data_path", str(root / "data"), *TINY, "--fname", "fixture"]
    P, model, occ = _model_with_content(argv, root / "data")
    tck.save_checkpoint(root / "run", "last", model, occ_states=occ, P=P, step=8, best=1.0)
    return root


def _eval_argv(root, *extra):
    return ["--configPath", str(REPO / "configs" / "eval.json"),
            "--data_path", str(root / "data"), *TINY, "--checkpoint_path",
            str(root / "run"), "--prefix", "last", "--test_batch_size", "1", *extra]


def _pairs():
    rng = np.random.default_rng(0)
    a = rng.random((40, 52, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    flat = (0.5 + 1e-4 * rng.random((40, 52, 3))).astype(np.float32)
    return [(a, b), (flat, a), (flat, flat + np.float32(1e-5)), (a, a)]


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Runs write under ``tmp_path``: logs, and the ray cache."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tds, "RAY_CACHE", tmp_path / "port_rays")


@pytest.mark.requires_cuda
def test_ssim_on_the_card_stays_in_range():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from acn_tpu_torch.pipelines.renderer import resolve_device

    resolve_device("cuda")  # what every entry point does: cuDNN without TF32
    assert not torch.backends.cudnn.allow_tf32
    for x, y in _pairs():
        got = float(tlosses.ssim(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()))
        want = float(tlosses.ssim(torch.from_numpy(x), torch.from_numpy(y)))
        # a float32 mean of window ratios that are all 1 may round an ulp
        # past it (1 + 1.2e-7 measured on the card); the fault this guards
        # against leaves the range by orders of magnitude
        assert abs(got) <= 1.0 + 1e-6
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.requires_cuda
def test_an_eval_frame_launches_the_scan_once_per_chunk(eval_run, in_tmp):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from acn_tpu_torch.ops import segscan

    ctx = trunner.build_context(tparse(_eval_argv(eval_run, "--fname", "card")), "eval",
                                device="cuda")
    md = ctx["test_metadata"][0]
    before = segscan.seg_excl_sum_kernel.launches
    res = trt.runtime_evaluate({**ctx, "test_metadata": [md]}, 0)
    from acn_tpu_torch.pipelines.renderer import Renderer

    rows = max(Renderer(ctx["cfg"], ctx["P"], ctx["occ_cfg"], device="cuda").chunk_rays
               // md.W, 1)
    assert segscan.seg_excl_sum_kernel.launches - before == -(-md.H // rows)
    assert np.isfinite(res["psnr"])
