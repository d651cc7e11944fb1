"""The port's measurement tools (``utils/h2d_bench.py``, ``bench_ops.py``,
``mem_analysis.py``, ``profiler.py``) against the JAX package's, on the CPU.

What a CPU can hold: the link fit equals the JAX package's on the same rows
(its three unit tests' rows and 20 seeded sweeps), the wire formats' bytes and copies behind the
implied floors, the per-op rows' names and order, every result labelled
``cpu``, and each tool refusing the card when there is none
(``mem_analysis`` refuses the CPU too).  Times are not checked: a CPU time
says nothing of the card.
"""
import contextlib
import io
import json
import types

import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu import train as jtrain
from pointcloud_segmentation_attention_tpu.data.pipeline import make_batch as jax_make_batch
from pointcloud_segmentation_attention_tpu.utils import bench_ops as jbench_ops
from pointcloud_segmentation_attention_tpu.utils import h2d_bench as jh2d
from pointcloud_segmentation_attention_tpu_torch import utils as tutils
from pointcloud_segmentation_attention_tpu_torch.data.wire import WireSpec
from pointcloud_segmentation_attention_tpu_torch.utils import bench_ops, h2d_bench, mem_analysis


def _jax_fit_rows():
    """The rows of tests/test_measure_tools.py's three fit tests."""
    recovery = [{"mb": mb, "ms": 50.0 + mb / 40.0 * 1e3} for mb in (0.25, 1.0, 4.0, 16.0)]
    degenerate = [{"mb": 0.25, "ms": 300.0, "mb_per_s": 0.8},
                  {"mb": 1.0, "ms": 60.0, "mb_per_s": 16.7},
                  {"mb": 4.0, "ms": 140.0, "mb_per_s": 28.6}]
    clamped = [{"mb": mb, "ms": -2.0 + mb / 40.0 * 1e3, "mb_per_s": 40.0}
               for mb in (1.0, 4.0, 16.0)]
    return [("recovery", recovery), ("degenerate", degenerate), ("clamped", clamped)]


def _random_sweep(seed: int):
    """A sweep at the default sizes: a latency of 0-0.1 ms, 5-60 GB/s, and
    noise that flips the slope of some seeds (degenerate fits)."""
    rng = np.random.RandomState(seed)
    lat, bw = rng.rand() * 0.1, rng.uniform(5e3, 6e4)
    rows = []
    for mb in h2d_bench.SIZES_MB:
        ms = max(lat + mb / bw * 1e3 + rng.randn() * rng.choice([1e-3, 0.3]), 1e-4)
        rows.append({"mb": mb, "ms": ms, "mb_per_s": mb / ms * 1e3})
    return rows


FIT_CASES = _jax_fit_rows() + [(f"random{s}", _random_sweep(s)) for s in range(20)]


@pytest.mark.parametrize("name,rows", FIT_CASES, ids=[c[0] for c in FIT_CASES])
def test_fit_equals_jax(name, rows):
    got = h2d_bench.fit_latency_bandwidth(rows)
    assert got == jh2d.fit_latency_bandwidth(rows)
    if name == "degenerate":
        assert got["degenerate"] is True
    if name == "clamped":
        assert got["latency_ms"] == 0.0


def test_random_sweeps_cover_both_fit_branches():
    fits = [h2d_bench.fit_latency_bandwidth(rows) for name, rows in FIT_CASES[3:]]
    assert any("degenerate" in f for f in fits) and any("degenerate" not in f for f in fits)


def test_trace_is_a_no_op_for_none_and_writes_a_chrome_trace(tmp_path):
    with tutils.trace(None) as prof:
        assert prof is None
    with tutils.trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_floors_count_the_port_wire_formats():
    """Bytes and copies of a B16 x 8192 batch: the packed formats are one
    ``WireSpec`` row a sample and one copy; the dict formats one copy per
    array of ``make_batch``.  The bytes equal the JAX package's literals
    (h2d_bench.py:162-163); its six copies for 'f32_dict' do not: its own
    ``make_batch(wire='f32')`` gives four arrays (points, labels, weights,
    features), as the port's does, and ``_to_device`` copies each once."""
    wire = h2d_bench.wire_transfers(16, 8192)
    assert wire["packed"] == {"bytes": 16 * WireSpec(8192).row_nbytes, "calls": 1}
    assert wire["packed_q16"] == {"bytes": 16 * WireSpec(8192, "q16").row_nbytes, "calls": 1}
    jax_literals = {"f32_dict": 16 * 8192 * 44, "compact": 16 * 8192 * 23,
                    "packed": 16 * 8192 * 23, "packed_q16": 16 * 8192 * 14 + 512}
    assert {k: w["bytes"] for k, w in wire.items()} == jax_literals
    assert {k: w["calls"] for k, w in wire.items()} == {
        "f32_dict": 4, "compact": 5, "packed": 1, "packed_q16": 1}
    n = 64
    chunk = {"points": np.zeros((n, 3), np.float32), "labels": np.zeros(n, np.int32),
             "colors": np.zeros((n, 3), np.float32), "normals": np.zeros((n, 3), np.float32),
             "weights": np.ones(n, np.float32)}
    for name, fmt in h2d_bench.WIRE_FORMATS.items():
        jax_batch = jax_make_batch([chunk] * 2, True, True, wire=fmt)
        assert len(jax_batch) == wire[name]["calls"], name
    floors = h2d_bench.implied_flagship_floors(
        {"latency_ms": 0.5, "bandwidth_mb_per_s": 1000.0}, step_ms=40.0)
    for name, f in floors.items():
        t_ms = wire[name]["calls"] * 0.5 + wire[name]["bytes"] / 2**20
        assert f["transfer_ms"] == pytest.approx(t_ms, rel=1e-12)
        assert f["pts_per_s_if_serialized"] == pytest.approx(16 * 8192 / ((t_ms + 40) / 1e3))
        assert f["pts_per_s_if_overlapped"] == pytest.approx(16 * 8192 / (max(t_ms, 40) / 1e3))


def _jax_row_names(monkeypatch):
    """The names the JAX package's bench_ops.main prints, at B1 x 1024 on the
    CPU, its timing and its train state stubbed out (nothing is timed and
    no model is compiled)."""
    monkeypatch.setattr(jbench_ops, "_time", lambda *a, **k: 0.0)
    monkeypatch.setattr(jtrain, "create_state",
                        lambda *a, **k: types.SimpleNamespace(params=None, batch_stats=None))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jbench_ops.main(b=1, n=1024)
    lines = out.getvalue().splitlines()
    return [line[:28].rstrip() for line in lines[2:]]


def test_bench_ops_rows_are_jax_rows_in_jax_order(monkeypatch):
    jax_names = _jax_row_names(monkeypatch)
    ops = bench_ops.op_rows(b=1, n=1024, device="cpu", iters=1, warmup=0)
    steps = bench_ops.step_rows(b=1, n=1024, device="cpu", iters=1, warmup=0)
    rows = ops + steps
    assert [r["op"] for r in rows] == jax_names
    assert len(ops) == 20 and len(steps) == 4
    for r in rows:
        assert r["device"] == "cpu" and r["launches"] == {}  # plain versions on the CPU
        assert r["calls"] == 3 and np.isfinite(r["ms"])
        assert bench_ops.row_kernels(r["op"])
    assert bench_ops.row_kernels("grp_cnt  1024@1024x32") == ("group_gather",)
    assert len(bench_ops.row_kernels("train_step[bfloat16]")) == 7
    assert "grp_cnt" in bench_ops.format_rows(rows)


def test_sweep_overlap_and_main_on_the_cpu_label_their_results(capsys):
    rows = h2d_bench.sweep(sizes_mb=(0.0625, 0.25), iters=1, device="cpu")
    assert [r["mb"] for r in rows] == [0.0625, 0.25]
    assert all(r["device"] == "cpu" and r["pinned"] is False for r in rows)
    ov = h2d_bench.overlap(payload_mb=0.0625, compute_ms_target=1.0, iters=2, device="cpu")
    assert ov["device"] == "cpu" and 0.0 <= ov["overlap_efficiency"] <= 1.0
    assert {"compute_ms", "transfer_ms", "interleaved_compute_ms"} <= set(ov)
    with pytest.raises(ValueError, match="pinned"):
        h2d_bench.sweep(sizes_mb=(0.0625,), iters=1, device="cpu", pinned=True)
    h2d_bench.main(["--device", "cpu", "--iters", "1", "--step_ms", "30"])
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and "pinned" not in out and out["step_source"] == "--step_ms"
    assert set(out["implied_flagship_floors"]["pageable"]) == set(h2d_bench.WIRE_FORMATS)


def test_mem_analysis_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="needs a card"):
        mem_analysis.analyze(b=1, n=1024, device="cpu")


def test_tools_refuse_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    calls = (lambda: h2d_bench.sweep(device="cuda"), lambda: h2d_bench.overlap(device="cuda"),
             lambda: h2d_bench.measure(device="cuda"), lambda: bench_ops.op_rows(device="cuda"),
             lambda: bench_ops.step_rows(device="cuda"),
             lambda: mem_analysis.analyze(device="cuda"))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
