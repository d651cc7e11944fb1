"""The reader of ``graph_steps.train`` (the program's counters
``train.graph_replays`` over ``train.steps``): the PointNet++ training
cells list it (the Point Transformer cell's test holds its per-layer
metrics as an exact set, so that cell takes it with a change of that
test), the share on a made-up snapshot, None on an empty one, on one
without replays (the parent's program) and on a program without counters,
and the same share when the registry holds two traced sessions of the same
work."""
from __future__ import annotations

import pytest
from torch.profiler import ProfilerActivity, profile

from pointcloud_segmentation_attention_tpu_torch.utils import profiler
from port_bench.lib import spec

METRIC = "graph_steps.train"
CELLS = ("features_train", "attention_train")


@pytest.fixture(autouse=True)
def fresh_registry():
    profiler.reset()
    yield
    profiler.reset()


def _snapshot(counters):
    return {"spans": {}, "counters": dict(counters), "records": [], "dropped": 0}


@pytest.mark.parametrize("cell", CELLS)
def test_the_pointnet2_training_cells_read_it(cell):
    assert METRIC in {m["name"] for m in spec.Cell(cell).per_layer}


def test_share_on_a_made_up_snapshot(monkeypatch):
    read = spec.Cell("point_transformer_train").reader(METRIC)
    monkeypatch.setattr(profiler, "snapshot", lambda: _snapshot(
        {"train.steps": 40, "train.graph_replays": 30, "knn.calls": 360}))
    assert read({}) == pytest.approx(75.0)


def test_none_where_there_is_nothing_to_read(monkeypatch):
    read = spec.Cell("features_train").reader(METRIC)
    assert read({}) is None                                     # the registry as reset
    monkeypatch.setattr(profiler, "snapshot", lambda: _snapshot({"train.steps": 20}))
    assert read({}) is None                                     # steps, never a replay
    monkeypatch.delattr(profiler, "snapshot")                   # a program without counters
    assert read({}) is None


def _session(steps: int) -> None:
    with profile(activities=[ProfilerActivity.CPU]):
        for s in range(steps):
            profiler.count("train.steps")
            if s:
                profiler.count("train.graph_replays")


def test_two_sessions_read_as_one():
    read = spec.Cell("attention_train").reader(METRIC)
    _session(4)
    first = read({})
    assert first == pytest.approx(75.0)
    _session(4)
    assert read({}) == pytest.approx(first)
