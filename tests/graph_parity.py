"""Graphed sampler steps against eager ones on the card, bit for bit.

``run(name, device, start_step=0)`` builds ``name`` twice from the same
seeded weights, then trains one copy through ``make_sampling_train_step``
(which replays a CUDA graph from its second step, ``train/step_graph.py``)
and the other through the eager path that step takes everywhere else
(``make_draws``, ``sample_chunk_batch``, ``seg_train_step``), on the same
scene ids, draws and seed.  After every step the loss, accuracy and
confusion, every ``.grad``, every parameter, every BN running statistic
and both Adam moments must be equal; the metrics two consecutive steps
return must be distinct tensors, the first unchanged by the second.
The last step, a replay, and its eager twin run under the profiler: the
replay must launch the hand-written kernels (``HAND_WRITTEN``, counted by
name in the trace) that the eager step launches; the counts and wrapper
``launches`` it adds back from the capture must equal those the eager step
made at its launches (the kNN's ``knn.calls`` equal to the kNN kernels in
the replay's trace); and each kernel under an ``nn.`` span must sit under
the same span in both (``trace_breakdown.kernel_spans``).
Raises ``AssertionError`` on the first difference; returns what ran.
Imports no JAX: ``tests/test_torch_step_graph.py`` and ``chip_smoke.py``
run it on the card.
"""
from __future__ import annotations

import copy
import re
from collections import Counter
from typing import Callable, Dict

import numpy as np
import torch

from pointcloud_segmentation_attention_tpu_torch import models
from pointcloud_segmentation_attention_tpu_torch.data.scannet.scenes import make_synthetic_scene
from pointcloud_segmentation_attention_tpu_torch.ops import cuda as cuda_ops
from pointcloud_segmentation_attention_tpu_torch.train import device_sampler, schedules, steps
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from pointcloud_segmentation_attention_tpu_torch.utils import profiler, trace_breakdown

# Registry name -> (use_colors, use_normals), as the benchmark's cells feed them.
MODELS = {"sem_seg_features": (True, True), "sem_seg_attention": (False, False),
          "point_transformer_seg": (True, True)}

# The kernels of ``csrc/`` by their functions' names.
HAND_WRITTEN = frozenset((
    "knn_kernel", "fps_regs_kernel", "fps_mem_kernel", "ball_query_kernel",
    "group_gather_kernel", "group_gather_bwd_kernel", "three_nn_kernel",
    "three_interpolate_kernel", "three_interpolate_bwd_kernel", "dw_combine_kernel",
    "csr_walk_kernel", "csr_scan_kernel", "csr_fused_kernel"))
_KERNEL_FN = re.compile(r"(?:^|[\s:])(\w+_kernel)\s*[<(]")


def _hand_written(name: str):
    m = _KERNEL_FN.search(name)
    return m.group(1) if m and m.group(1) in HAND_WRITTEN else None


def measured(fn: Callable):
    """``fn()`` under the profiler, synchronised: its result, and what it
    launched: 'hand' (hand-written kernels by name, from the trace),
    'under_nn' ((span, kernel name) of each kernel under an ``nn.`` span,
    fills left out: a graph's replay fills its generators' seed and
    offset), 'counters' (the profiler counters made) and 'launched' (each
    ``ops/cuda.counted`` wrapper's ``launches`` added)."""
    wrappers = cuda_ops.counted()
    before = {n: f.launches for n, f in wrappers.items()}
    profiler.reset()
    with profiler.profile_all_threads() as prof:
        out = fn()
        torch.cuda.synchronize()
    counters = profiler.snapshot()["counters"]
    profiler.reset()
    spans = trace_breakdown.kernel_spans(prof)
    return out, {
        "hand": Counter(n for n in (_hand_written(k.name) for _, k in spans) if n),
        "under_nn": Counter((label, k.name) for label, k in spans
                            if label.startswith("nn.") and "FillFunctor" not in k.name),
        "counters": counters,
        "launched": {n: f.launches - before[n] for n, f in wrappers.items()
                     if f.launches != before[n]},
    }


def check_replay_counts(tag: str, graph, got: Dict, want: Dict) -> Dict:
    """``got`` (a replay's ``measured``) against ``want`` (its eager
    twin's) and against what ``graph`` (the ``StepGraph``) adds back."""
    if not want["hand"] or got["hand"] != want["hand"]:
        raise AssertionError(f"{tag}: the replay launched {dict(got['hand'])}, the eager step "
                             f"{dict(want['hand'])}")
    names = {f: n for n, f in cuda_ops.counted().items()}
    tallied = {names[f]: n for f, n in graph.launches.items()}
    if got["launched"] != want["launched"] or tallied != want["launched"]:
        raise AssertionError(f"{tag}: wrapper launches {got['launched']} replayed, "
                             f"{tallied} tallied, {want['launched']} eager")
    own = {k: v for k, v in got["counters"].items() if not k.startswith("train.")}
    if own != want["counters"] or own != graph.counts:
        raise AssertionError(f"{tag}: counters {own} replayed, {graph.counts} tallied, "
                             f"{want['counters']} eager")
    if got["hand"]["knn_kernel"] != own.get("knn.calls", 0):
        raise AssertionError(f"{tag}: {got['hand']['knn_kernel']} kNN kernels in the replay, "
                             f"knn.calls {own.get('knn.calls', 0)}")
    if got["under_nn"] != want["under_nn"]:
        raise AssertionError(f"{tag}: kernels under nn. spans differ: replay "
                             f"{sorted((got['under_nn'] - want['under_nn']).items())[:5]}, "
                             f"eager {sorted((want['under_nn'] - got['under_nn']).items())[:5]}")
    return {"hand_written": dict(got["hand"]),
            "under_nn_spans": dict(Counter(label for label, _ in got["under_nn"].elements()))}


def first_stair(bn_schedule=schedules.scannet_bn_momentum) -> int:
    """The first step whose BN momentum differs from step 0's."""
    step = 1
    while bn_schedule(step) == bn_schedule(0):
        step += 1
    return step


def _equal(what: str, a, b) -> None:
    if a is None or b is None:
        if a is not b:
            raise AssertionError(f"{what}: one side is None")
        return
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: max |diff| {float((a - b).abs().max()):.3e}")


def run(name: str, device, start_step: int = 0, n_steps: int = 8, batch: int = 16,
        npoints: int = 8192, rooms=None, seed: int = 3) -> Dict:
    dev = torch.device(device)
    use_colors, use_normals = MODELS[name]
    if rooms is None:
        rooms = [make_synthetic_scene(150_000, seed=300 + s) for s in range(4)]
    scenes = device_sampler.ResidentScenes(rooms, device=dev, use_colors=use_colors,
                                           use_normals=use_normals)
    model = models.seeded_model(name, seed=0, device=dev)
    graphed, eager = (TrainState(m, step=start_step) for m in (model, copy.deepcopy(model)))
    step = device_sampler.make_sampling_train_step(scenes, npoints, num_classes=21)
    rng = np.random.RandomState(seed)
    previous = counted = None

    def eager_step(ids, at):
        draws = device_sampler.make_draws(scenes, ids.to(dev), npoints,
                                          device_sampler._sampler_generator(dev, seed, at))
        data = device_sampler.sample_chunk_batch(scenes, ids.to(dev), draws, npoints)
        return steps.seg_train_step(eager, data, seed, num_classes=21)[1]

    for k in range(n_steps):
        ids = torch.from_numpy(rng.randint(0, len(rooms), batch).astype(np.int32))
        at = eager.step
        tag = f"{name} step {at}"
        if k < n_steps - 1:
            _, got = step(graphed, ids, seed)
            want = eager_step(ids, at)
        else:
            replays = step.graphed.graph.replays
            (_, got), in_graph = measured(lambda: step(graphed, ids, seed))
            if step.graphed.graph.replays != replays + 1:
                raise AssertionError(f"{tag}: the last step did not replay")
            want, in_eager = measured(lambda: eager_step(ids, at))
            counted = check_replay_counts(tag, step.graphed.graph, in_graph, in_eager)
        for key in ("loss", "accuracy", "confusion"):
            _equal(f"{tag} {key}", got[key], want[key])
        if got["learning_rate"] != want["learning_rate"]:
            raise AssertionError(f"{tag} learning rate")
        if previous is not None:
            before, kept = previous
            for key in kept:
                v = before[key]
                if v.data_ptr() == got[key].data_ptr():
                    raise AssertionError(f"{tag}: {key} aliases the previous step's")
                _equal(f"{tag}: the previous step's {key} kept", v, kept[key])
        previous = got, {key: got[key].clone() for key in ("loss", "accuracy", "confusion")}
        for (n, p), q in zip(graphed.model.named_parameters(), eager.model.parameters()):
            _equal(f"{tag} {n}", p, q)
            _equal(f"{tag} {n}.grad", p.grad, q.grad)
            sp, sq = graphed.optimizer.state[p], eager.optimizer.state[q]
            for moment in ("exp_avg", "exp_avg_sq"):
                _equal(f"{tag} {n} {moment}", sp[moment], sq[moment])
        for (n, a), b in zip(graphed.model.named_buffers(), eager.model.buffers()):
            _equal(f"{tag} {n}", a, b)
    g = step.graphed.graph
    want = expected_counts(range(start_step, start_step + n_steps))
    if (g.captures, g.replays) != want:
        raise AssertionError(f"{name}: {g.captures} captures and {g.replays} replays, "
                             f"not {want}")
    return {"model": name, "start_step": start_step, "steps": n_steps,
            "captures": g.captures, "replays": g.replays, "segments": sum(
                not isinstance(p, tuple) for p in g.program),
            "last_loss": float(previous[1]["loss"]), **counted}


def expected_counts(step_range, bn_schedule=schedules.scannet_bn_momentum):
    """(captures, replays) of ``GraphedStep``'s rule over these steps: a step
    whose momentum differs from the graph's runs eagerly unless it equals
    the step before's, when it captures and replays."""
    captures = replays = 0
    graph_key = previous = None
    for s in step_range:
        key = bn_schedule(s)
        if key != graph_key:
            graph_key = None
            if key != previous:
                previous = key
                continue
            graph_key = key
            captures += 1
        previous = key
        replays += 1
    return captures, replays
