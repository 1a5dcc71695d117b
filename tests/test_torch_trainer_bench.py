"""The port's training benchmark scripts (acn_tpu_torch.scripts.bench_train
and profile_step) on the CPU, split from tests/test_torch_trainer.py so
that the test run spreads them over its workers.
"""

import json

import pytest


# ---------------------------------------------------------------- the bench


def test_bench_train_prints_one_line_with_bench_keys(capsys):
    from acn_tpu_torch.scripts import bench_train

    assert bench_train.main(["--scale", "2,1,64,32,1,1", "--device", "cpu"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert rec["metric"] == "meta_train_ray_renders_per_sec_occ" and rec["unit"] == "rays/s"
    for key in ("value", "vs_baseline", "stratified_rays_per_sec", "occ_per_ray_rays_per_sec",
                "occ_budget_rays_per_sec", "occ_auto_premeasure_rays_per_sec",
                "occ_step_s", "occ_budget_step_s", "occ_auto_premeasure_step_s",
                "stratified_step_s"):
        assert rec[key] > 0, f"{key} not measured: {rec}"
    assert bench_train.main(["--scale", "2,1,64,32,1,1", "--device", "cpu",
                             "--regimes", "budget"]) == 0
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["occ_budget_rays_per_sec"] > 0 and rec["stratified_rays_per_sec"] is None
    with pytest.raises(ValueError, match="unknown regimes"):
        bench_train.run((2, 1, 64, 32, 1, 1), ("fast",), device="cpu")


def test_profile_step_counts_what_the_step_dispatches(capsys):
    """One JSON line of profiled ATen ops per step by regime (no launches or
    card time on the CPU); a step with one more inner iteration dispatches
    more."""
    from acn_tpu_torch.scripts import profile_step

    assert profile_step.main(["--scale", "2,1,16,8,1", "--device", "cpu",
                              "--regimes", "stratified,occ"]) == 0
    rec = json.loads(capsys.readouterr().out.strip())
    ops = rec["aten_events"]
    assert set(ops) == {"stratified", "occ"} and rec["device"] == "cpu"
    assert all(n > 1000 for n in ops.values()), ops
    assert rec["kernel_launches"] == {"stratified": None, "occ": None}
    assert profile_step.run((2, 1, 16, 8, 2), ("occ",), "cpu")["aten_events"][
        "occ"] > ops["occ"]
    with pytest.raises(ValueError, match="unknown regimes"):
        profile_step.run((2, 1, 16, 8, 1), ("fast",), "cpu")


def test_profile_step_times_steps_and_counts_the_kernels():
    """``steps`` timed steps by regime; on the CPU no scan or composite
    kernel launches (their plain versions run) and no ``create_graph``
    backward is counted under FoMAML."""
    from acn_tpu_torch.scripts import profile_step

    rec = profile_step.run((2, 1, 16, 8, 1), ("budget",), "cpu", steps=2)
    assert len(rec["step_ms"]["budget"]) == 2 and min(rec["step_ms"]["budget"]) > 0
    assert rec["scan_launches"] == {"budget": [0, 0]}
    assert rec["composite_launches"] == {"budget": [0, 0]}
    assert rec["graph_backwards"] == {"budget": 0} and rec["busy_ms"] == {"budget": None}
    assert rec["aten_events"]["budget"] > 1000
