"""A training step's device work captured once as CUDA graphs and replayed
every later step, so that the host issues a few dozen graph launches where
the step makes thousands of kernel launches.

``GraphedStep`` runs a step of ``make_sampling_train_step``: the chunks'
cut, the train-mode forward with the loss, the backward, the BN running
updates and the batch's metrics are captured once (``StepGraph``); the Adam
update (``TrainState.apply_gradients``) runs eagerly after each replay,
from the gradients the replay writes into the same ``.grad`` tensors, with
its LR and bias corrections as host floats.  The same kernels run in the
same order on the same data, so a replayed step equals the eager one bit
for bit.

- A step's changing inputs (scene ids, the sampler's draws) are copied
  into static tensors before each replay; the dropout stream is one
  generator registered with the graph and reseeded from (seed, step)
  before each replay, so it draws what the eager step's fresh generator
  draws.
- The graph is keyed on the BN momentum (a host float baked into the
  captured kernels), the inputs' shapes and the state's parameters and
  buffers.  A step whose key differs from the graph's releases it and runs
  eagerly; the next step with the same key as its predecessor captures a
  new graph and replays it.  So the first step runs eagerly (on the
  graph's side stream, which initialises cuBLAS, autograd and the
  allocator before any capture), the second is captured and replayed, a
  staircase schedule costs one eager step at each stair, and a schedule
  that changes every step never captures.  Capture executes nothing.
- A step returns copies of the graph's metrics, which the next replay
  overwrites.
- ``eligible`` decides from what the step can observe whether it may
  replay at all: a CUDA device, no data- or tensor-parallel mesh
  (synchronised BN runs collectives inside the forward), ``remat='none'``
  (a recomputation rewinds its generator) and no augmentation.  Every
  other step runs eagerly as before.

Python does not run on a replay: the capture keeps a tally of the
profiler counts (``utils/profiler.tally``) and of the kernel wrappers'
``launches`` (``ops/cuda.counted``) made in the captured region, takes the
launches back out (the capture executed nothing), and each replay adds
both, the counts while a profiler records as ``count`` does.  The capture
is cut at every program span opened on its thread
(``utils/profiler.split_at_spans``: ``train.sample``, ``train.forward``,
``nn.vector_attention``, ``train.backward``, ...) into one graph a stretch,
all in one memory pool; a replay launches the stretches in their order,
each under the spans that enclosed it at capture, so that a kernel of the
replay sits under the same program span as in an eager step (a trace's
kernel-by-span attribution reads the graph as it reads the eager step).
Spans of autograd's backward thread do not cut.  The whole replay is the
span ``train.graph_replay``; counters ``train.graph_captures`` and
``train.graph_replays`` count the captures and replays.
"""
from __future__ import annotations

import contextlib
import gc
import warnings
from typing import Callable, Dict, List, Optional

import torch

from pointcloud_segmentation_attention_tpu_torch.ops import cuda as cuda_ops
from pointcloud_segmentation_attention_tpu_torch.parallel import act_sharding
from pointcloud_segmentation_attention_tpu_torch.parallel.mesh import active_mesh
from pointcloud_segmentation_attention_tpu_torch.train import steps
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from pointcloud_segmentation_attention_tpu_torch.utils import profiler

Tensors = Dict[str, torch.Tensor]


def eligible(device, mesh=None, remat: str = "none", augment: bool = False) -> bool:
    """Whether a step on ``device`` may replay a CUDA graph: a CUDA device,
    no data-parallel ``mesh`` beyond one rank and none active, no
    tensor-parallel mesh active, ``remat='none'`` and no augmentation."""
    return (torch.device(device).type == "cuda"
            and (mesh is None or mesh.world_size == 1)
            and active_mesh() is None and act_sharding.model_mesh() is None
            and remat == "none" and not augment)


class _Segments:
    """A capture cut at the capturing thread's spans: ``program`` is the list
    of the stretches' graphs, between them ('enter' | 'exit', span name)."""

    def __init__(self, new_graph: Callable, generator: torch.Generator):
        self.new_graph, self.generator = new_graph, generator
        self.program: List = []
        self.pool = None
        self.graph = None

    def begin(self) -> None:
        graph = self.new_graph()
        graph.register_generator_state(self.generator)
        # thread_local: the feed's thread may pin memory while the step captures.
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.graph = graph

    def end(self) -> None:
        graph, self.graph = self.graph, None
        if graph is None:
            return
        with warnings.catch_warnings():
            # A stretch with no kernel (two span ends in a row) is an empty graph.
            warnings.filterwarnings("ignore", message=".*CUDA Graph is empty")
            graph.capture_end()
        if self.pool is None:
            self.pool = graph.pool()
        self.program.append(graph)

    def mark(self, kind: str, name: str) -> None:
        self.end()
        self.program.append((kind, name))
        self.begin()


class StepGraph:
    """One capture of a step's device work as CUDA graphs, and its replays.

    ``capture(key, inputs, body)`` makes static tensors like ``inputs`` (a
    dict of tensors) on ``device`` and captures ``body(static, generator)``,
    which returns a dict of tensors, cut at its spans (the module's
    docstring); ``replay(inputs, seed)`` copies ``inputs`` into the static
    tensors, seeds ``generator`` with ``seed``, replays, and returns
    ``body``'s tensors (the next replay overwrites them).  ``new_graph``
    stands in for ``torch.cuda.CUDAGraph`` in tests."""

    def __init__(self, device, new_graph: Optional[Callable] = None):
        self.device = torch.device(device)
        self._new_graph = new_graph or torch.cuda.CUDAGraph
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.generator = torch.Generator(device=self.device)
        self.program: List = []
        self.key = None
        self.captures = self.replays = 0
        self.counts: Dict[str, int] = {}
        self.launches: Dict[object, int] = {}
        self._static: Optional[Tensors] = None
        self._out: Optional[Tensors] = None

    def release(self) -> None:
        """Drop the graphs, their static tensors and their outputs."""
        self.program, self.key, self._static, self._out = [], None, None, None

    def capture(self, key, inputs: Tensors, body: Callable[[Tensors, torch.Generator], Tensors]
                ) -> None:
        self.release()
        self._static = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                        for k, v in inputs.items()}
        segments = _Segments(self._new_graph, self.generator)
        wrappers = cuda_ops.counted().values()
        before = [f.launches for f in wrappers]
        with profiler.tally() as counts, self._on_stream():
            segments.begin()
            try:
                with profiler.split_at_spans(segments.mark):
                    out = body(self._static, self.generator)
            finally:
                segments.end()
        self.launches = {}
        for f, n in zip(wrappers, before):
            if f.launches != n:
                self.launches[f], f.launches = f.launches - n, n
        self.counts, self._out, self.program, self.key = counts, out, segments.program, key
        self.captures += 1
        profiler.count("train.graph_captures")

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        # What ``torch.cuda.graph`` does before a capture.
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.stream(self.stream)

    def replay(self, inputs: Tensors, seed: int) -> Tensors:
        for k, v in inputs.items():
            self._static[k].copy_(v, non_blocking=True)
        self.generator.manual_seed(seed)
        with profiler.span("train.graph_replay"):
            opened = []
            for part in self.program:
                if not isinstance(part, tuple):
                    part.replay()
                elif part[0] == "enter":
                    opened.append(profiler.span(part[1]))
                    opened[-1].__enter__()
                else:
                    opened.pop().__exit__(None, None, None)
        self.replays += 1
        profiler.count("train.graph_replays")
        for name, n in self.counts.items():
            profiler.count(name, n)
        for f, n in self.launches.items():
            f.launches += n
        return self._out


class GraphedStep:
    """``step(state, inputs, seed, eager) -> (state, metrics)``: a training
    step through a ``StepGraph``, or ``eager()`` (the step's eager path on
    the same inputs, returning ``(state, metrics)``) on the graph's side
    stream where the key rule of the module's docstring says so.
    ``body(state, static, generator, bn_momentum)`` is the step's device
    work without the optimizer (``steps.seg_gradient_step`` on the chunks
    cut from ``static``); ``bn_schedule`` maps a step to its BN momentum.
    ``metrics`` holds copies of 'loss', 'accuracy' and 'confusion' and the
    float 'learning_rate', as ``seg_train_step``'s."""

    def __init__(self, device, body: Callable, bn_schedule: Callable[[int], float],
                 **graph_kwargs):
        self.body, self.bn_schedule = body, bn_schedule
        self.graph = StepGraph(device, **graph_kwargs)
        self._last_key = None
        self._held = ()      # what the graph's key names by id, kept alive with it
        self._grads = []     # (parameter, the gradient tensor the graph writes)

    def key(self, state: TrainState, inputs: Tensors):
        model = state.model
        return (self.bn_schedule(state.step), id(state), tuple(map(id, model.parameters())),
                tuple(map(id, model.buffers())),
                tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))

    def __call__(self, state: TrainState, inputs: Tensors, seed: int, eager: Callable):
        key = self.key(state, inputs)
        previous, self._last_key = self._last_key, key
        graph = self.graph
        if graph.key != key:
            graph.release()
            self._held, self._grads = (), []
            if key != previous:
                return self._eager(eager)
            graph.capture(key, inputs, lambda static, gen: self.body(state, static, gen, key[0]))
            model = state.model
            self._held = (state, list(model.parameters()), list(model.buffers()))
            self._grads = [(p, p.grad) for p in model.parameters()]
        for p, grad in self._grads:
            if p.grad is not grad:
                p.grad = grad
        out = graph.replay(inputs, steps.dropout_stream_seed(seed, state.step))
        return steps.finish_train_step(state, {k: v.clone() for k, v in out.items()})

    def _eager(self, eager: Callable):
        stream = self.graph.stream
        if stream is None:
            return eager()
        current = torch.cuda.current_stream(self.graph.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            state, out = eager()
        current.wait_stream(stream)
        for v in out.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(current)
        return state, out
