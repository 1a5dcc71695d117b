"""The port's mesh (acn_tpu_torch.parallel.mesh) against acn_tpu's, and its
collectives on two CPU gloo ranks.

* ``mesh_shape`` (``make_mesh``'s shape) against ``acn_tpu``'s
  ``make_mesh`` over 1–8 of conftest's virtual devices, with and without
  ``mesh_experts`` / ``mesh_data``, and ``make_render_mesh``'s axis;
  ``maybe_init_distributed``'s settings and errors against JAX's.
* ``shard_by_expert_axis`` by position: the experts' rows of the
  parameters, the moments, the grids, the pools and the batch, and a
  background leaf whose first dim equals K kept whole; ``task_range``.
* The backend rule (NCCL only when each rank has a card, on one host or
  several, from the hosts the ranks tell each other; never gloo after an
  NCCL failure) and ``launch.spawn``'s refusals (a rank that fails, a rank
  that hangs past the deadline).
* Two ranks (``launch.spawn``): the expert gather, the any-rank flag, the
  mesh-wide norm and finite flag, ``synchronize_between_processes``, the
  render mesh; the ranks import neither JAX nor ``acn_tpu``.
"""

import math
import types

import jax
import numpy as np
import pytest
import torch

from acn_tpu.parallel import mesh as jmesh
from acn_tpu_torch import toy
from acn_tpu_torch.models.container import ContainerConfig, init_container
from acn_tpu_torch.models.encodings import HashGridConfig
from acn_tpu_torch.models.ngp import NGPConfig
from acn_tpu_torch.parallel import launch
from acn_tpu_torch.parallel import mesh as tmesh


@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("K,mesh_experts,mesh_data", [
    (4, None, 1), (4, None, 2), (6, None, 1), (4, 2, 1), (4, 1, 1), (3, None, 1)])
def test_mesh_shape_matches_acn_tpu(n, K, mesh_experts, mesh_data):
    want = jmesh.make_mesh(K, mesh_experts, mesh_data, devices=jax.devices()[:n])
    E, D = tmesh.mesh_shape(K, n, mesh_experts, mesh_data)
    if want is None:
        assert n == 1
    else:
        assert want.devices.shape == (E, D) and want.axis_names == ("expert", "data")
    assert E * D <= n and math.gcd(K, E) == E


@pytest.mark.parametrize("n", range(1, 9))
def test_render_mesh_axis_matches_acn_tpu(n):
    want = jmesh.make_render_mesh(jax.devices()[:n])
    if n == 1:  # one rank: no mesh, in both packages
        assert want is None and tmesh.make_render_mesh() is None
        return
    got = tmesh.Mesh(num_experts=0, shape=(n,), rank=n - 1, axis_names=("px",))
    assert want.devices.shape == got.shape and want.axis_names == got.axis_names


def _settings(monkeypatch, env, flags):
    for name in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "PROCESS_ID",
                 "JAX_PROCESS_ID", "NUM_PROCESSES", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return types.SimpleNamespace(**{**dict(coordinator_address=None, process_id=None,
                                           num_processes=None), **flags})


@pytest.mark.parametrize("env,flags", [
    ({}, {}),
    ({"COORDINATOR_ADDRESS": "localhost:1"}, {}),
    ({"JAX_COORDINATOR_ADDRESS": "localhost:1", "JAX_PROCESS_ID": "0"}, {}),
    ({}, {"coordinator_address": "localhost:1", "num_processes": 2}),
    ({"NUM_PROCESSES": "2"}, {"coordinator_address": "localhost:1"}),
])
def test_maybe_init_distributed_settings_and_errors_match_acn_tpu(monkeypatch, env, flags):
    P = _settings(monkeypatch, env, flags)
    try:
        want = jmesh.maybe_init_distributed(P)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.maybe_init_distributed(P, device="cpu")
        assert str(got.value) == str(e)
        return
    assert want is False and tmesh.maybe_init_distributed(P, device="cpu") is False
    assert tmesh.distributed_settings(P) == (None, None, None)


def test_process_count_without_a_coordinator_is_refused(monkeypatch):
    P = _settings(monkeypatch, {"PROCESS_ID": "0"}, {"num_processes": 2})
    with pytest.raises(ValueError, match="coordinator_address"):
        tmesh.maybe_init_distributed(P, device="cpu")
    P = _settings(monkeypatch, {}, {"num_processes": 1, "process_id": 0})
    assert tmesh.maybe_init_distributed(P, device="cpu") is False


def _model(K, bg_hidden):
    cfg = ContainerConfig(num_submodules=K, bg_hidden=bg_hidden, expert=NGPConfig(
        hidden=8, color_hidden=8, hash=HashGridConfig(levels=2, min_res=4, max_res=8,
                                                      log2_hashmap_size=6)))
    boxes = np.stack([toy.SCENE_AABB] * K)
    return init_container(cfg, torch.zeros(K, 3), torch.from_numpy(boxes),
                          torch.from_numpy(toy.SCENE_AABB),
                          generator=torch.Generator().manual_seed(0))


def test_shard_by_expert_axis_is_by_position_not_by_shape():
    K = 4
    model = _model(K, bg_hidden=K)  # background layers (K, ·) and (K,): no expert axis
    P = types.SimpleNamespace(encoding_lr=1e-2, sigma_lr=1e-3, color_lr=1e-3, bg_lr=1e-3,
                              outer_steps=10, decay_factor=10.0, optimizer="adam",
                              grad_clip=1.0)
    opt, state = toy.init_train_state(model, P)
    state["opt_state"]["mu"] = {k: v for k, v in state["opt_state"]["mu"].items()}
    bg_leaves = [t for t in _leaves(model.params()["bg_mlp"])]
    assert any(t.shape[0] == K for t in bg_leaves)
    mesh = tmesh.Mesh(num_experts=K, shape=(2, 1), rank=1)
    occ = {"occs": torch.arange(K * 8.0).reshape(K, 8), "binaries": torch.ones(K, 8, dtype=bool)}
    batch = {"support_rays": torch.arange(K * 3 * 2 * 8.0).reshape(K, 3, 2, 8)}
    pools = {"rays": np.arange(K * 5.0).reshape(K, 5)}
    sh = tmesh.shard_by_expert_axis(
        {"model": model, "opt_state": state["opt_state"], "step": 3, "occ_states": occ,
         "batch": batch, "device_pools": pools}, mesh, K)
    local = sh["model"]
    assert (mesh.k0, mesh.k1) == (2, 4) and local.cfg.num_submodules == 2
    for a, b in zip(_leaves(local.params()["experts"]), _leaves(model.params()["experts"])):
        assert torch.equal(a, b[2:4])
    for a, b in zip(_leaves(local.params()["bg_mlp"]), bg_leaves):
        assert torch.equal(a, b)  # whole, whatever its first dim
    assert torch.equal(local.expert_aabbs, model.expert_aabbs[2:4])
    assert torch.equal(local.centroids, model.centroids[2:4])
    mu = sh["opt_state"]["mu"]
    assert all(a.shape[0] == 2 for a in _leaves(mu["experts"]))
    assert [a.shape for a in _leaves(mu["bg_mlp"])] == [b.shape for b in bg_leaves]
    assert sh["opt_state"]["count"] is state["opt_state"]["count"] and sh["step"] == 3
    assert torch.equal(sh["occ_states"]["occs"], occ["occs"][2:4])
    assert torch.equal(sh["batch"]["support_rays"], batch["support_rays"][2:4])
    assert np.array_equal(sh["device_pools"]["rays"], pools["rays"][2:4])
    assert tmesh.shard_by_expert_axis(occ, None, K) is occ
    with pytest.raises(ValueError, match="lead with K"):
        tmesh.shard_by_expert_axis({"experts": torch.zeros(3)}, mesh, K)


def _leaves(tree):
    from acn_tpu_torch.models.nn import tree_leaves

    return tree_leaves(tree)


@pytest.mark.parametrize("T,D,want", [(3, 2, [(0, 1), (1, 3)]), (4, 2, [(0, 2), (2, 4)]),
                                      (1, 2, [(0, 0), (0, 1)]), (3, 1, [(0, 3)])])
def test_task_range_splits_the_tasks_over_the_data_ranks(T, D, want):
    got = [tmesh.Mesh(num_experts=2, shape=(1, D), rank=d).task_range(T) for d in range(D)]
    assert got == want


def test_backend_rule_and_no_fallback(monkeypatch):
    one_card, a, b = [("a", 1)], ("a", 8), ("b", 8)
    assert tmesh.choose_backend(one_card * 4, "cpu")[0] == "gloo"
    assert tmesh.choose_backend(one_card * 2, "cuda")[0] == "gloo"  # two ranks share the card
    assert tmesh.choose_backend(one_card, "cuda")[0] == "nccl"
    assert tmesh.choose_backend([a] * 8 + [b] * 8, "cuda")[0] == "nccl"  # 2 hosts × 8 cards
    assert tmesh.choose_backend([a] * 8 + [b] * 9, "cuda")[0] == "gloo"
    calls = []

    def init(backend, **kw):
        calls.append(backend)
        raise RuntimeError("NCCL error: no card")

    # rank 0 of 2, rank 1 on another host: the rendezvous store tells each its peers
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(f"cuda:{i}"))
    monkeypatch.setattr(tmesh.dist, "init_process_group", init)
    store = tmesh.dist.HashStore()
    store.set("acn_mesh/host/1", '["another host", 4]')
    with pytest.raises(RuntimeError, match="NCCL"):
        tmesh.init_distributed(None, 2, 0, "cuda", 1.0, store=store)
    assert calls == ["cuda:0", "nccl"]  # raised; no second try over gloo
    with pytest.raises(ValueError, match="coordinator"):
        tmesh.init_distributed("env://", 2, 0, "cuda", 1.0)


def test_spawn_reports_a_failing_and_a_hanging_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 0 exited") as e:
        launch.spawn("acn_tpu_torch.parallel.dryrun:no_such_function", 1, {},
                      tmp_path / "fail", timeout_s=60)
    assert "AttributeError" in str(e.value)
    with pytest.raises(RuntimeError, match="still running"):
        launch.spawn("acn_tpu_torch.parallel.dryrun:sleep_rank", 1, 60.0, tmp_path / "hang", timeout_s=4)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return launch.spawn("acn_tpu_torch.parallel.dryrun:collectives_rank", 2,
                        {"K": 4, "mesh": (2, 1)}, tmp_path_factory.mktemp("coll"))


def test_expert_gather_and_any_rank_flag(two_ranks):
    for r, out in enumerate(two_ranks):
        assert out["k"] == (2 * r, 2 * r + 2) and out["backend"] == "gloo"
        np.testing.assert_array_equal(out["gathered"][:, 0], [1, 1, 2, 2])
        assert out["any"] == (True, False)


def test_norm_and_finite_flag_are_the_whole_meshs(two_ranks):
    # experts: 2 rows × 2 of 1², 2 rows × 2 of 2²; background: 4 ones, once
    for out in two_ranks:
        assert out["sq_norm"] == 4 * 1 + 4 * 4 + 4
        assert out["finite"] == (True, False)  # a NaN on rank 1 reaches rank 0


def test_synchronize_between_processes_sums_counts_and_totals(two_ranks):
    for out in two_ranks:  # rank 0: 1 × 1.0, rank 1: 2 × 2.0
        assert out["meter"] == (3, 5.0)
        assert out["render_mesh"][0] == (2,)
    assert [o["render_mesh"][1] for o in two_ranks] == [0, 1]
    assert two_ranks[0]["stats"]["collectives"] == 4  # gather, norm, two finite flags


def test_a_checkpoints_launch_settings_are_not_restored(tmp_path):
    """A run started as 2 processes saves its launch in ``P.json``; a
    process that reads the checkpoint (an eval, a resume elsewhere) must not
    take it as its own, or it would wait for ranks that never come."""
    import json

    from acn_tpu_torch.utils import config as tconfig

    (tmp_path / "last.P.json").write_text(json.dumps({
        "coordinator_address": "127.0.0.1:1", "process_id": 1, "num_processes": 2,
        "rank": 1, "mesh_experts": 2, "inner_iter": 5}))
    (tmp_path / "last.model").write_bytes(b"")
    P = tconfig.parse_args(["--op", "eval", "--checkpoint_path", str(tmp_path),
                            "--prefix", "last"])
    assert (P.coordinator_address, P.process_id, P.num_processes, P.rank) == \
        (None, None, None, 0)
    assert P.inner_iter == 5 and P.mesh_experts == 2  # the rest is restored
    assert tmesh.maybe_init_distributed(P, device="cpu") is False
