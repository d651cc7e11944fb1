"""The Point Transformer cell on the CPU: its driver's checks at a tiny
size against the reference (and a planted fault caught), its readers
(None where the traced record or the program holds nothing to read), and
its FLOP and kNN-bound arithmetic checked by hand at one shape."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from pointcloud_segmentation_attention_tpu_torch.utils import profiler
from port_bench.cost import kernels
from port_bench.cost import point_transformer as cost
from port_bench.lib import spec
from port_bench.tests.conftest import tiny_driver
from port_bench.tests.test_bench_faults import _half_batch, _state_unchanged

CELL = "point_transformer_train"
NEW = ("knn_roofline.train", "pt_mfu.train", "vector_attention_fwd_ms.train", "knn_calls.train")
SEED = 2 ** 31 + 77


def _cfg():
    return spec.Cell(CELL).config


def test_the_cell_reads_its_new_metrics_and_the_generic_training_ones():
    cell = spec.Cell(CELL)
    assert cell.config["registry"] == "point_transformer_seg" and cell.chips == 1
    assert cell.traffic["driver"] == "train_sampler_pt"
    base = spec.load_json(os.path.join(spec.BENCH_DIR, "traffic", "train_sampler_b16.json"))
    assert {k: v for k, v in cell.traffic.items() if k != "driver"} == \
        {k: v for k, v in base.items() if k != "driver"}
    names = {m["name"] for m in cell.per_layer}
    assert names == set(NEW) | {"idle.train", "step_device_ms.train", "launches.train",
                                "step_host_ms.train", "feed_wait_ms.train"}
    assert {e["name"] for e in cell.end_to_end} == {"train_points_per_s", "setup_s"}


def test_forward_flops_by_hand_at_one_cloud_of_8192():
    cfg = _cfg()
    # (points, channels, neighbours) a level; blocks a level with the decoder's one.
    levels = [(8192, 32, 8, 2), (2048, 64, 16, 3), (512, 128, 16, 4), (128, 256, 16, 6),
              (32, 512, 16, 3)]
    want = 2 * 8192 * 9 * 32                                     # the stride-1 transition
    c_in = 32
    for n, c, k, blocks in levels:
        per_block = (2 * n * (5 * c * c)                         # linear1, linear3, q, kv
                     + 2 * n * k * (9 + 3 * c + c * c // 8 + (c // 8) ** 2)
                     + 2 * n * k * c)                            # the weighted sum
        want += blocks * per_block
        if n != 8192:
            want += 2 * n * k * (3 + c_in) * c                   # a stride-4 transition
        c_in = c
    want += 2 * (32 * 1024 * 512 + 512 * 512)                    # the coarsest transition
    for (n, c, _, _), (n2, c2, _, _) in zip(levels, levels[1:]):
        want += 2 * (n * c * c + n2 * c2 * c)                    # the other four
    want += 2 * 8192 * 32 * (32 + 21)                            # the head
    assert cost.forward_flops(cfg, 1, 8192) == want
    assert cost.train_step_flops(cfg, 16, 8192) == 3 * 16 * want
    assert 45e9 < cost.forward_flops(cfg, 16, 8192) < 50e9


def test_knn_bound_by_hand():
    cfg = _cfg()
    calls = cost.knn_calls(cfg, 16, 8192)
    assert calls == [(16, 8192, 8192, 8), (16, 2048, 8192, 16), (16, 2048, 2048, 16),
                     (16, 512, 2048, 16), (16, 512, 512, 16), (16, 128, 512, 16),
                     (16, 128, 128, 16), (16, 32, 128, 16), (16, 32, 32, 16)]
    # The level-1 self kNN: 16 x 8192 x 8192 pairs at 8 operations, against
    # 1.6 MB of points in and 16.8 MB of distances and indices out.
    nbytes, flops = cost.knn(16, 8192, 8192, 8)
    assert nbytes == 16 * 8192 * 24 + 16 * 8192 * 8 * 8 and flops == 8 * 16 * 8192 ** 2
    assert kernels.bound_s(nbytes, flops) == pytest.approx(flops / 67e12)
    pairs = sum(b * m * n for b, m, n, _ in calls)
    assert cost.knn_bound_s(cfg, 16, 8192) == pytest.approx(8 * pairs / 67e12, rel=1e-3)


def _ctx(traced, window=None, cfg=None):
    d = tiny_driver(CELL)[0]
    if cfg is not None:
        d.cfg = cfg
    return {"traced": traced, "driver": d, "window": window or {"steps": 0, "wall_s": 1.0}}


@pytest.fixture
def fresh_registry():
    profiler.reset()
    yield
    profiler.reset()


@pytest.mark.parametrize("metric", NEW)
def test_readers_return_none_where_there_is_nothing_to_read(metric, fresh_registry):
    read = spec.Cell(CELL).reader(metric)
    assert read(_ctx({"steps": 20}, cfg={k: v for k, v in _cfg().items()
                                         if k != "planes"})) is None


def test_readers_on_a_made_up_record(fresh_registry, monkeypatch):
    cell, cfg = spec.Cell(CELL), _cfg()
    traced = {"steps": 20, "knn_kernel_s": 0.02, "vector_attention_fwd_s": 0.4}
    window = {"steps": 100, "wall_s": 20.0}
    ctx = _ctx(traced, window)
    b, n = ctx["driver"].traffic["batch_size"], ctx["driver"].traffic["npoints"]
    assert cell.reader("knn_roofline.train")(ctx) == pytest.approx(
        100 * cost.knn_bound_s(cfg, b, n) * 20 / 0.02)
    assert cell.reader("vector_attention_fwd_ms.train")(ctx) == pytest.approx(20.0)
    assert cell.reader("pt_mfu.train")(ctx) == pytest.approx(
        100 * cost.train_step_flops(cfg, b, n) * 100 / 20.0 / 67e12)
    monkeypatch.setattr(profiler, "snapshot", lambda: {"counters": {"train.steps": 4,
                                                                    "knn.calls": 36}})
    assert cell.reader("knn_calls.train")(ctx) == 9.0
    monkeypatch.delattr(profiler, "snapshot")                     # a program without counters
    assert cell.reader("knn_calls.train")(ctx) is None


@pytest.fixture(scope="module")
def checked():
    torch.set_num_threads(1)  # one summation order on both sides
    d, cell = tiny_driver(CELL, SEED)
    d.setup()
    d.release()
    return d, cell


def test_training_step_numbers_agree_with_the_reference(checked):
    """The first step's numbers within the cell's limits.  The three steps'
    (``loss_gap``, the change) are not held here: at two clouds of 2,048
    points Adam's +-lr moves of near-rounding gradients weigh more than at
    the cell's 16 x 8192, where the limits were set on the card."""
    d, cell = checked
    checks = {c.name: c for c in d.check(cell.limits)}
    assert checks["loss_gap_step1"].value < 1e-6 and checks["grad_norm_gap"].value < 1e-4
    assert checks["loss_gap_step1"].ok and checks["grad_norm_gap"].ok
    assert d.extras["readings"]["change_norm_gap"] < 0.1


@pytest.mark.parametrize("fault, check, floor", [(_half_batch, "loss_gap_step1", 0.0),
                                                 (_state_unchanged, "change_norm_gap", 0.9)])
def test_a_planted_fault_comes_out_not_correct(monkeypatch, fault, check, floor):
    """The loss over half the batch fails the first step's loss gap; a state
    left unchanged reads a change gap of 1 (every leaf's change missing)."""
    fault(monkeypatch)
    d, cell = tiny_driver(CELL, SEED)
    d.setup()
    d.release()
    checks = {c.name: c for c in d.check(cell.limits)}
    assert not checks[check].ok and checks[check].value > floor, checks[check]


def test_the_reference_and_the_new_harness_files_import_no_jax():
    root = spec.ROOT
    mods = ["port_bench.reference.point_transformer", "port_bench.cost.point_transformer",
            "port_bench.lib.span_kernels"]
    code = ("import sys, json; sys.path.insert(0, %r)\n" % root
            + "".join(f"import {m}\n" for m in mods)
            + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not spec.forbidden_modules(top)
    assert "pointcloud_segmentation_attention_tpu_torch" not in top
