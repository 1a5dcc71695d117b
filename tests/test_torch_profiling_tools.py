"""The port's profiling tools (acn_tpu_torch.ops.{bench_gather_scatter,
bench_step_breakdown, analyze_trace}) on the CPU, their plain paths at
micro sizes; their figures come from the card (``chip_smoke.py`` phase 13).

* ``bench_gather_scatter``: each timed op computes what it names (the
  gather and scatter-add exactly; the one-hot products against the same
  sums over bf16-rounded inputs, exactly for the gather and within float32
  rounding for the scatter); ``run`` gives one finite figure per op, table
  and dtype, each naming its device and the bytes it must move; no card
  means an error unless the CPU is asked for.
* ``bench_step_breakdown``: every part timed, the prediction is units ×
  ``episode_grad_K`` + ``opt_update``, and ``--profile`` writes a Chrome
  trace; a CPU trace holds no device event, which ``analyze_trace`` refuses.
* ``analyze_trace``: on a small trace written here (kernels on two streams,
  a copy, a memset, host events), the categories and groups, the totals,
  the busy time as the union of intervals, ``.json.gz``; the XLA-name rules
  give ``acn_tpu``'s categories.
"""

import gzip
import json

import numpy as np
import pytest
import torch

from acn_tpu.ops import analyze_trace as janalyze
from acn_tpu_torch.ops import analyze_trace as tanalyze
from acn_tpu_torch.ops import bench_gather_scatter as gs
from acn_tpu_torch.ops import bench_step_breakdown as sb


def test_gather_scatter_ops_compute_what_they_name():
    g = torch.Generator().manual_seed(0)
    table = torch.randn((64, 4), generator=g)
    idx = torch.randint(0, 64, (300,), generator=g)
    grads = torch.randn((300, 4), generator=g)
    assert torch.equal(gs.gather(table, idx), table[idx])
    want = np.zeros((64, 4), np.float64)
    np.add.at(want, idx.numpy(), grads.double().numpy())
    np.testing.assert_allclose(gs.scatter_add(table, idx, grads).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(gs.onehot_gather(table, idx, block=128),
                       table.to(torch.bfloat16)[idx])
    want_bf = np.zeros((64, 4), np.float64)
    np.add.at(want_bf, idx.numpy(), grads.to(torch.bfloat16).double().numpy())
    np.testing.assert_allclose(gs.onehot_scatter(64, idx, grads, block=128).numpy(),
                               want_bf, rtol=1e-2, atol=2e-2)  # bf16 block sums
    x = torch.randn((10, 16), generator=g)
    assert torch.equal(gs.stream(x), x * 1.0001)


def test_gather_scatter_run_on_the_cpu(capsys):
    rows = gs.run(device="cpu", rows=2000, iters=1, log2_rows=(6,), hash_table=(100, 8))
    ops = [(r["op"], tuple(r["table"]), r["dtype"]) for r in rows]
    assert ops == [("gather", (64, 16), "float32"), ("scatter_add", (64, 16), "float32"),
                   ("onehot_gather", (64, 16), "bfloat16"),
                   ("onehot_scatter", (64, 16), "bfloat16"),
                   ("gather", (100, 8), "bfloat16"), ("scatter_add", (100, 8), "bfloat16"),
                   ("gather", (100, 8), "float32"), ("scatter_add", (100, 8), "float32"),
                   ("stream", (2000, 16), "float32")]
    for r in rows:
        assert r["device"] == "cpu" and r["rows"] == 2000
        assert np.isfinite(r["ms"]) and r["Mrows_per_s"] > 0
        assert r["bound_ms"] == pytest.approx(r["bytes"] / gs.HBM_BYTES_PER_S * 1e3)
    # the f32 gather moves the table, the int64 indices and the rows once each
    assert rows[0]["bytes"] == 64 * 16 * 4 + 2000 * 8 + 2000 * 16 * 4
    assert rows[-1]["GB_per_s"] > 0 and rows[-1]["bytes"] == 2 * 2000 * 16 * 4


def test_the_tools_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        gs.run(rows=10, iters=1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        sb.run(scale=(1, 1, 4, 4, 1), iters=1)


def test_step_breakdown_on_the_cpu(tmp_path):
    out = sb.run(scale=(2, 1, 32, 16, 1), iters=1, device="cpu", profile=tmp_path / "p")
    assert sorted(out["ms"]) == sorted(sb.PARTS)
    assert all(np.isfinite(v) and v > 0 for v in out["ms"].values())
    assert out["units"] == 1 * 1 + 1
    assert out["predicted_step_ms"] == pytest.approx(
        out["units"] * out["ms"]["episode_grad_K"] + out["ms"]["opt_update"])
    assert out["hash_rows_per_episode"] == 32 * 64 * 8 and out["device"] == "cpu"
    trace = tmp_path / "p" / "full_step.trace.json"
    assert out["trace"] == str(trace) and trace.stat().st_size > 0
    with pytest.raises(ValueError, match="no device events"):
        tanalyze.summarize(tmp_path / "p")


def _event(name, ts, dur, cat="kernel", tid=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid, "ts": ts, "dur": dur}


TRACE = [
    _event("aten::index_add_", 0.0, 500.0, cat="cpu_op"),
    _event("void at::native::indexFuncLargeIndex<float, long, 2, 2, -2, true>(...)", 10.0, 4.0),
    _event("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>"
           "(int, at::native::AddFunctor<float>, std::array<char*, 2ul>)", 14.0, 2.0),
    _event("void at::native::vectorized_elementwise_kernel<4, at::native::MulFunctor<float>>"
           "(int, at::native::MulFunctor<float>, std::array<char*, 2ul>)", 16.0, 1.0),
    _event("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32", 17.0, 3.0),
    _event("seg_excl_sum_kernel", 20.0, 0.5),
    _event("void indexSelectLargeIndex<float, long>(...)", 19.0, 2.0, tid=8),  # 2nd stream
    _event("Memcpy HtoD (Pageable -> Device)", 30.0, 1.5, cat="gpu_memcpy"),
    _event("Memset (Device)", 32.0, 0.25, cat="gpu_memset"),
    _event("cutlass_kernel", 40.0, 0.75),
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0},
]


@pytest.mark.parametrize("gz", [False, True])
def test_analyze_trace_sums_device_time_by_category(tmp_path, gz, capsys):
    path = tmp_path / ("t.pt.trace.json" + (".gz" if gz else ""))
    data = json.dumps({"traceEvents": TRACE, "schemaVersion": 1}).encode()
    path.write_bytes(gzip.compress(data) if gz else data)
    s = tanalyze.summarize(tmp_path)
    assert s["trace"] == str(path) and s["events"] == 9
    got = {k: round(v * 1e6, 6) for k, v in s["by_category"].items()}
    assert got == {"scatter": 4.0, "fusion(elementwise)": 3.0, "matmul": 3.0,
                   "scan/cumsum": 0.5, "gather": 2.0, "copy/layout": 1.5,
                   "other": 1.0}
    assert s["device_s"] == pytest.approx(15e-6)
    assert s["busy_s"] == pytest.approx(13.5e-6)  # the second stream overlaps 1.5 µs
    assert s["by_group"]["at::native::vectorized_elementwise_kernel"] == pytest.approx(3e-6)
    out = tanalyze.main([str(path), "--top", "3"])
    text = capsys.readouterr().out
    assert out["events"] == 9 and "=== top 3 op groups ===" in text
    with pytest.raises(FileNotFoundError):
        tanalyze.summarize(tmp_path / "empty_dir_that_is_missing")


def test_xla_names_categorize_as_in_acn_tpu():
    names = ["fusion.123", "gather.4", "scatter-add.9", "dot.2", "convolution", "all-reduce",
             "copy.3", "transpose", "sort.1", "cumsum", "reduce-window", "rng-bit-generator",
             "infeed", "custom-call", "while.7"]
    for n in names:
        assert tanalyze.categorize(n) == janalyze.categorize(n), n
