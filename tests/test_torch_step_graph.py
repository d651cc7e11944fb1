"""The training step's CUDA graph (``train/step_graph.py``): when a step
may replay one, when it captures a new one, and the counts a replay adds
back; on the card, graphed steps against eager ones bit for bit
(``tests/graph_parity.py``).  The file imports no JAX, so its card tests
run on the card's machine::

    PSA_TEST_TPU=1 python -m pytest tests/test_torch_step_graph.py -m cuda

On the CPU they skip, and the rest runs with stand-ins for the graph.
"""
import os
import sys
import threading
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointcloud_segmentation_attention_tpu_torch.ops.cuda import knn
from pointcloud_segmentation_attention_tpu_torch.train import step_graph
from pointcloud_segmentation_attention_tpu_torch.utils import profiler

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import graph_parity  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_registry():
    profiler.reset()
    yield
    profiler.reset()


class _Graph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay runs nothing, and
    appends the graph's number to ``REPLAYED``."""
    made = 0

    def __init__(self):
        self.number, self.captured = _Graph.made, None
        _Graph.made += 1

    def register_generator_state(self, generator):
        self.generator = generator

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert self.captured is None and capture_error_mode == "thread_local"
        self.captured, self.given_pool = False, pool

    def capture_end(self):
        assert self.captured is False
        self.captured = True

    def pool(self):
        assert self.captured, "a pool exists once the capture has ended"
        return ("pool", self.number)

    def replay(self):
        assert self.captured
        REPLAYED.append(self.number)


REPLAYED = []
STUB = dict(new_graph=_Graph)


class _State:
    def __init__(self):
        self.model = torch.nn.Linear(2, 2)
        self.step = 0

    def apply_gradients(self):
        self.step += 1
        return 0.5


@pytest.mark.parametrize("device, mesh, remat, augment, want", [
    ("cpu", None, "none", False, False),
    ("cuda", types.SimpleNamespace(world_size=2), "none", False, False),
    ("cuda", None, "dots", False, False),
    ("cuda", None, "none", True, False),
    ("cuda", types.SimpleNamespace(world_size=1), "none", False, True),
], ids=["cpu", "mesh", "remat", "augment", "eligible"])
def test_eligible(device, mesh, remat, augment, want):
    assert step_graph.eligible(torch.device(device), mesh, remat, augment) is want


def _drive(graphed, state, schedule_steps, shape=(2,)):
    """Run the steps, recording which path each took."""
    paths = []
    for _ in schedule_steps:
        replays = graphed.graph.replays

        def eager():
            state.step += 1
            return state, {"loss": torch.zeros(())}

        graphed(state, {"x": torch.ones(shape)}, 0, eager)
        paths.append("graph" if graphed.graph.replays > replays else "eager")
    return paths


def _body(state, static, generator, momentum):
    return {"loss": static["x"].sum() * momentum}


def test_recapture_key():
    graphed = step_graph.GraphedStep("cpu", _body, lambda s: 0.5 if s < 3 else 0.75, **STUB)
    state = _State()
    assert _drive(graphed, state, range(6)) == ["eager", "graph", "graph",
                                                  "eager", "graph", "graph"]
    assert (graphed.graph.captures, graphed.graph.replays) == (2, 4)
    assert graphed.graph.key[0] == 0.75
    # Another input shape, then another state: one eager step, then a new capture.
    assert _drive(graphed, state, range(2), shape=(3,)) == ["eager", "graph"]
    other = _State()
    other.step = state.step
    assert _drive(graphed, other, range(2)) == ["eager", "graph"]
    assert graphed.graph.captures == 4
    # A momentum that moves every step never captures.
    moving = step_graph.GraphedStep("cpu", _body, lambda s: 0.5 + 1e-3 * s, **STUB)
    assert _drive(moving, _State(), range(4)) == ["eager"] * 4
    assert moving.graph.captures == 0
    assert graph_parity.expected_counts(range(6), lambda s: 0.5 if s < 3 else 0.75) == (2, 4)


def test_returned_metrics_are_copies():
    graphed = step_graph.GraphedStep("cpu", _body, lambda s: 0.5, **STUB)
    state = _State()
    _drive(graphed, state, range(1))
    outs = [graphed(state, {"x": torch.ones(2)}, 0, None)[1] for _ in range(2)]
    assert outs[0]["loss"] is not outs[1]["loss"]
    assert outs[0]["loss"].data_ptr() != outs[1]["loss"].data_ptr()
    assert outs[0]["learning_rate"] == 0.5 and state.step == 3


def test_tally_replayed_through_stub_graph():
    def body(static, generator):
        for _ in range(9):
            profiler.count("knn.calls")
            knn.knn_point.launches += 1
        profiler.count("knn.pairs", 4)
        return {"y": static["x"] * 2}

    graph = step_graph.StepGraph("cpu", **STUB)
    launches = knn.knn_point.launches
    graph.capture("key", {"x": torch.ones(3)}, body)
    assert knn.knn_point.launches == launches  # the capture executed nothing
    assert graph.counts == {"knn.calls": 9, "knn.pairs": 4}
    assert profiler.snapshot()["counters"] == {}
    for _ in range(2):
        graph.replay({"x": torch.ones(3)}, seed=1)
    assert profiler.snapshot()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            graph.replay({"x": torch.ones(3)}, seed=1)
    snap = profiler.snapshot()
    assert snap["counters"] == {"knn.calls": 27, "knn.pairs": 12, "train.graph_replays": 3}
    assert snap["spans"]["train.graph_replay"]["count"] == 3
    assert knn.knn_point.launches == launches + 9 * 5
    knn.knn_point.launches = launches


def test_capture_cuts_at_spans_and_replays_under_them():
    def body(static, generator):
        with profiler.span("train.sample"):
            y = static["x"] * 2
        with profiler.span("train.forward"):
            with profiler.span("nn.vector_attention"):
                y = y + 1
            side = threading.Thread(target=lambda: profiler.span("nn.elsewhere").__enter__())
            side.start()
            side.join()
        return {"y": y}

    graph = step_graph.StepGraph("cpu", **STUB)
    graph.capture("key", {"x": torch.ones(3)}, body)
    program = graph.program
    graphs = [p for p in program if not isinstance(p, tuple)]
    assert [p for p in program if isinstance(p, tuple)] == [
        ("enter", "train.sample"), ("exit", "train.sample"), ("enter", "train.forward"),
        ("enter", "nn.vector_attention"), ("exit", "nn.vector_attention"),
        ("exit", "train.forward")]
    # One graph before, between and after the span ends (the other thread's
    # span does not cut), all in the first graph's pool.
    assert len(graphs) == 7 and all(isinstance(p, tuple) for p in program[1::2])
    assert graphs[0].given_pool is None
    assert {g.given_pool for g in graphs[1:]} == {graphs[0].pool()}
    del REPLAYED[:]
    graph.replay({"x": torch.ones(3)}, seed=1)
    assert REPLAYED == [g.number for g in graphs]
    with profile(activities=[ProfilerActivity.CPU]):
        graph.replay({"x": torch.ones(3)}, seed=1)
    snap = profiler.snapshot()
    parents = {r["name"]: r["parent"] for r in snap["records"]}
    assert parents == {"train.graph_replay": None, "train.sample": "train.graph_replay",
                       "train.forward": "train.graph_replay",
                       "nn.vector_attention": "train.forward"}
    assert {n: v["count"] for n, v in snap["spans"].items()} == dict.fromkeys(parents, 1)
    # Outside a capture a span cuts nothing.
    with profiler.span("train.sample"):
        pass
    assert graph.program is program and len(program) == 13


def test_tally_collects_without_a_profiler():
    with profiler.tally() as counts:
        profiler.count("a")
        profiler.count("a", 2)
        with profiler.tally() as inner:
            profiler.count("b")
    profiler.count("a")
    assert counts == {"a": 3} and inner == {"b": 1}
    assert profiler.snapshot()["counters"] == {}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(graph_parity.MODELS))
@pytest.mark.parametrize("start", ["first", "stair"])
def test_graphed_steps_equal_eager_steps(card, name, start):
    start_step = 0 if start == "first" else graph_parity.first_stair() - 2
    graph_parity.run(name, card, start_step=start_step)
