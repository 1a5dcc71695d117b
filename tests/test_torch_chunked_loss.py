"""The chunked episode loss (``P.train_chunk_rays``) in the port against
acn_tpu's (``make_episode_loss`` with ``train_chunk_rays`` > 0).

An episode of more rays than a chunk is padded to whole chunks with inert
rays (far = −1), and each chunk renders under ``torch.utils.checkpoint``
with its own draws, the chunk keys of ``split(k_render, n_chunks)``. With
occupancy a chunk marches anew with the strided ``march_rays`` whatever the
budget, as acn_tpu's ``prepare_samples`` returns None there: a chunked
packed-budget config launches no scan (acn_tpu's own behaviour, ROADMAP
Queue C). An episode of no more rays than a chunk renders whole.

Micro scene of ``torch_m9_util``, chunks of 6 rays: the 16 support rays
make 3 chunks (2 pad rays), the 8 query rays 2 (4 pad rays). Tolerances as
``torch_m9_util.check_meta_grads`` (measured: gradients ≤ 3e-6 of each
leaf's largest entry).
"""

import jax
import numpy as np
import pytest
import torch

from acn_tpu_torch import convert, toy
from acn_tpu_torch.nerfs import render as trender
from acn_tpu_torch.pipelines.offline_stage import train_step as tts
from test_torch_train_step import _tt
from torch_m9_util import (batch, check_meta_grads, draws, grads_flat, meta_grads,
                           port_meta_grads, setup)
from torch_m9_util import one_thread  # noqa: F401  (pytestmark uses it)

pytestmark = pytest.mark.usefixtures("one_thread")


CHUNK = 6


@pytest.mark.parametrize("regime", ["budget", "stratified"])
def test_chunked_meta_gradient_matches_jax(regime):
    jout, tout, _ = meta_grads("fomaml", regime, train_chunk_rays=CHUNK)
    check_meta_grads(jout, tout)
    assert float(tout[4]) == 0.0  # chunks report no overflow, as in acn_tpu


def test_second_order_maml_differentiates_through_the_chunks():
    """``torch.utils.checkpoint`` (non-reentrant) recomputes a chunk in the
    backward with its graph, so MAML's double backward goes through it: the
    chunked MAML gradient is finite and not FoMAML's."""
    out = {algo: grads_flat(*port_meta_grads(algo, "budget", train_chunk_rays=CHUNK,
                                             inner_lr=0.3)[2:4])
           for algo in ("maml", "fomaml")}
    a = np.concatenate([v.ravel() for v in out["maml"].values()])
    b = np.concatenate([v.ravel() for v in out["fomaml"].values()])
    assert np.isfinite(a).all() and np.linalg.norm(a - b) > 1e-3 * np.linalg.norm(b)


def _count_scans(monkeypatch):
    calls = []
    scan = trender.seg_excl_sum

    def counting(x, s):
        calls.append(int(x.numel()))
        return scan(x, s)

    monkeypatch.setattr(trender, "seg_excl_sum", counting)
    return calls


@pytest.mark.parametrize("chunk,scans", [(0, True), (CHUNK, False), (16, True)])
def test_chunked_budget_step_marches_strided(monkeypatch, chunk, scans):
    """A budget step scans (packed compositing) unless its episodes are
    chunked: chunk 6 re-marches strided in every chunk and scans nothing;
    chunk 16 leaves the 16 support and 8 query rays whole, packed."""
    calls = _count_scans(monkeypatch)
    sc, P, _, tocc_cfg, _, tocc, _ = setup("budget", train_chunk_rays=chunk)
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    topt, state = toy.init_train_state(model, P)
    step = tts.make_meta_train_step(sc.tcfg, P, topt, tocc_cfg, device="cpu")
    _, m = step(state, _tt(batch()), tocc,
                draws=draws(jax.random.PRNGKey(2), chunk=chunk))
    assert bool(torch.isfinite(m["loss_total"]))
    assert bool(calls) == scans
    assert (float(m["occ_overflow"]) > 0.0) == scans


def test_pad_rays_are_inert_and_the_chunks_are_the_whole():
    """The chunked loss equals the loss of the same rays rendered whole with
    the same per-ray draws, in the stratified regime (where a chunk's
    jitter is a slice of the whole's)."""
    sc, P, _, _, _, _, _ = setup("stratified", train_chunk_rays=CHUNK)
    P0 = type(P)(**{**vars(P), "train_chunk_rays": 0})
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    b = _tt(batch())
    rays, rgbs = b["support_rays"][0, 0], b["support_rgbs"][0, 0]
    n = rays.shape[0]
    u = torch.rand((3 * CHUNK, int(P.ray_samples)), generator=torch.Generator().manual_seed(0))
    params = model.params()
    expert = {k: v for k, v in tts.cont.expert_slice(params["experts"], 0).items()}
    losses = []
    for p_, draw in ((P, [u[i * CHUNK:(i + 1) * CHUNK] for i in range(3)]), (P0, u[:n])):
        loss_fn, _ = tts.make_episode_loss(sc.tcfg, p_, None)
        losses.append(loss_fn(expert, params["bg_mlp"], model.expert_aabbs[0], rays, rgbs,
                              None, u=draw))
    torch.testing.assert_close(losses[0], losses[1], rtol=1e-6, atol=1e-8)
    g = [torch.autograd.grad(l, [expert["sigma_head"]["w"]])[0] for l in losses]
    torch.testing.assert_close(g[0], g[1], rtol=1e-5, atol=1e-9)
