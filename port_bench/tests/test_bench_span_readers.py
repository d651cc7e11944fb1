"""The readers of the metrics that read the program's spans and counters
(``utils/profiler.snapshot()``): the ratio on a made-up snapshot, None on
an empty one and on a program without spans, and the same value when the
registry holds two traced sessions of the same work."""
from __future__ import annotations

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointcloud_segmentation_attention_tpu_torch.utils import profiler
from port_bench.lib import spec

# metric -> (cell, span or the numerator counter, unit counter, scale)
READERS = {
    "stage_ms.serve": ("features_serve", "serve.stage", "serve.rooms", 1e3),
    "stage_wait_ms.serve": ("features_serve", "prefetch.wait", "serve.rooms", 1e3),
    "label_wait_ms.serve": ("features_serve", "serve.label_wait", "serve.rooms", 1e3),
    "slot_use.serve": ("features_serve", "serve.chunks", "serve.slots", 100.0),
    "feed_wait_ms.train": ("features_train", "prefetch.wait", "train.steps", 1e3),
    "step_host_ms.train": ("attention_train", "train.step", "train.steps", 1e3),
}


def _reader(metric):
    cell = spec.Cell(READERS[metric][0])
    assert metric in {m["name"] for m in cell.per_layer}
    return cell.reader(metric)


def _snapshot(spans=None, counters=None):
    return {"spans": {k: {"count": 1, "total_s": v, "self_s": v}
                      for k, v in (spans or {}).items()},
            "counters": dict(counters or {}), "records": [], "dropped": 0}


@pytest.fixture(autouse=True)
def fresh_registry():
    profiler.reset()
    yield
    profiler.reset()


@pytest.mark.parametrize("metric", sorted(READERS))
def test_ratio_on_a_made_up_snapshot(metric, monkeypatch):
    _, top, unit, scale = READERS[metric]
    if top.startswith("serve.chunks"):
        snap = _snapshot(counters={top: 1431, unit: 2176})
    else:
        snap = _snapshot(spans={top: 2.5, "train.forward": 9.0}, counters={unit: 40})
    monkeypatch.setattr(profiler, "snapshot", lambda: snap)
    want = scale * (1431 / 2176 if top == "serve.chunks" else 2.5 / 40)
    assert _reader(metric)({}) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_none_on_an_empty_snapshot_and_without_spans(metric, monkeypatch):
    assert _reader(metric)({}) is None                 # the registry as reset
    _, top, unit, _ = READERS[metric]
    if top != "serve.chunks":                          # a unit counted, the span never
        monkeypatch.setattr(profiler, "snapshot", lambda: _snapshot(counters={unit: 3}))
        assert _reader(metric)({}) is None
    monkeypatch.delattr(profiler, "snapshot")          # a program without spans
    assert _reader(metric)({}) is None


class _Clock:
    """``time.perf_counter_ns`` stepping 1 ms a read."""

    def __init__(self):
        self.now = 0

    def perf_counter_ns(self):
        self.now += 1_000_000
        return self.now


def _session(rooms: int, steps: int) -> None:
    with profile(activities=[ProfilerActivity.CPU]):
        for r in range(rooms):
            with profiler.span("serve.stage", r):
                with profiler.span("serve.pack"):
                    pass
            with profiler.span("prefetch.wait"):
                pass
            with profiler.span("serve.label_wait", r):
                pass
            profiler.count("serve.rooms")
            profiler.count("serve.slots", 16 * (r + 2))
            profiler.count("serve.chunks", 16 * (r + 2) - 5)
        for s in range(steps):
            with profiler.span("prefetch.wait"):
                pass
            with profiler.span("train.step", s):
                profiler.count("train.steps")
                with profiler.span("train.forward"):
                    torch.ones(8).sum()


@pytest.mark.parametrize("metric", sorted(READERS))
def test_two_sessions_read_as_one(metric, monkeypatch):
    """A traced session ``run.py`` repeats (one that held no kernel) adds the
    same work again; the ratio stays."""
    monkeypatch.setattr(profiler, "time", types.SimpleNamespace(
        perf_counter_ns=_Clock().perf_counter_ns))
    serving = READERS[metric][0] == "features_serve"
    _session(3, 0) if serving else _session(0, 4)
    first = _reader(metric)({})
    assert first is not None and first > 0
    _session(3, 0) if serving else _session(0, 4)
    assert _reader(metric)({}) == pytest.approx(first)
