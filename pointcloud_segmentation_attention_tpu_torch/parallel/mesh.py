"""Data parallelism over ``torch.distributed``: the port's counterpart of the
JAX package's ``parallel/mesh.py``.

JAX jits one program over a mesh of devices: the state is replicated, the
batch axis is sharded and XLA inserts the collectives, so every reduction
over the batch axis (BN statistics, the loss normaliser, the metrics) is a
reduction over the global batch.  The port runs one process per device
instead (``spawn``, or ``torchrun``), and a ``Mesh`` inside an initialised
process group is the world.  Every rank computes what world size 1
computes:

- ``shard_batch`` gives each rank its contiguous rows of the global batch;
- ``data_parallel(step_fn, mesh)`` runs a step with the mesh active
  (``active_mesh``); under it ``nn.layers.ScheduledBatchNorm`` reduces its
  statistics across ranks, ``nn.layers.Dropout`` and the input samplers draw
  their random numbers for the global batch and keep their rows
  (``local_rows``), the losses divide by global counts and the metrics are
  summed (``global_sum``), and ``TrainState.apply_gradients`` sums every
  gradient across ranks in one flat all-reduce (``all_reduce_gradients``);
- ``replicate`` broadcasts rank 0's parameters and buffers.

Outside ``data_parallel`` (and at world size 1) none of this runs, so
single-device code is untouched.

A serving mesh is a list of local devices with no process group: one
process drives a model replica on each (``eval/resident_serving.py``,
``eval/full_scene.py:make_sharded_predict_fn``).  It may repeat a device
(``['cpu', 'cpu']``, or ``[cuda:0, cuda:0]``), which runs the lanes' code on
one device.

Every collective goes through ``parallel/collectives.py``, which counts them.
"""
from __future__ import annotations

import contextlib
import copy
import contextvars
import datetime
import os
import queue
import socket
import traceback
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pointcloud_segmentation_attention_tpu_torch.device import resolve
from pointcloud_segmentation_attention_tpu_torch.parallel import collectives

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("psa_mesh", default=None)
# The device of this process's rank, set by ``RankPool``'s workers.
_RANK_DEVICE: Optional[torch.device] = None


def _indexed(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without an index
    becomes the current one."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """The devices of a data-parallel mesh.

    ``devices``: an array of ``torch.device`` (1-D for data parallelism; a
    nested list gives a 2-D mesh, which data-parallel serving refuses).
    ``group``, ``rank``, ``world_size``: the process group of a training
    mesh's data axis (``devices`` then holds this rank's device), else None,
    0, 1.  ``model_group``, ``model_rank``, ``n_model``: the model axis of a
    tensor-parallel mesh (``parallel.tp.make_mesh_2d``), else None, 0, 1."""

    def __init__(self, devices: Sequence, group: Optional[dist.ProcessGroup] = None,
                 rank: int = 0, world_size: int = 1,
                 axis_names: Sequence[str] = ("data",),
                 model_group: Optional[dist.ProcessGroup] = None, model_rank: int = 0,
                 n_model: int = 1):
        arr = np.array(devices, dtype=object)
        self.devices = np.vectorize(_indexed, otypes=[object])(arr)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device array needs as many axis names, "
                             f"got {self.axis_names}")
        self.group = group
        self.rank = rank
        self.world_size = world_size
        self.model_group = model_group
        self.model_rank = model_rank
        self.n_model = n_model

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """This rank's device (the first device of a serving mesh)."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        model = (f", model_rank={self.model_rank}, n_model={self.n_model}"
                 if self.n_model > 1 else "")
        return (f"Mesh(devices={list(self.devices.flat)}, rank={self.rank}, "
                f"world_size={self.world_size}{model})")


def rank_device(device="cuda") -> torch.device:
    """This process's device: the one ``RankPool`` gave it, else (under
    ``torchrun``) ``cuda:LOCAL_RANK`` when ``device`` is a CUDA device, else
    the CPU."""
    if _RANK_DEVICE is not None:
        return _RANK_DEVICE
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    resolve(dev)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """Inside an initialised process group: the world (``n_devices`` must be
    None or the world size), this rank's device from ``rank_device``.
    Otherwise ``local_mesh(n_devices, device)``."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices not in (None, world):
            raise ValueError(f"n_devices={n_devices} inside a process group of {world} ranks")
        return Mesh([rank_device(device)], group=dist.group.WORLD, rank=dist.get_rank(),
                    world_size=world)
    return local_mesh(n_devices, device)


def local_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A serving mesh of this process's devices: the first ``n_devices``
    (default all) CUDA devices, raising when fewer exist; for the CPU,
    ``n_devices`` (default 1) lanes on the CPU."""
    dev = resolve(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        n = have if n_devices is None else int(n_devices)
        if not 0 < n <= have:
            raise ValueError(f"n_devices={n_devices}: this machine has {have} CUDA devices")
        return Mesh([torch.device("cuda", i) for i in range(n)])
    return Mesh([dev] * (1 if n_devices is None else int(n_devices)))


def as_mesh(mesh) -> Optional[Mesh]:
    """A ``Mesh``, or None for None; a sequence of devices becomes a
    serving mesh."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    return Mesh(list(mesh))


def lane_replicas(module: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """A replica of ``module`` for each device of a serving mesh, in lane
    order: ``module`` itself on its own device, one copy per other device
    (lanes on one device share it)."""
    home = next(module.parameters()).device
    by_device = {home: module}
    out = []
    for dev in mesh.devices.flat:
        if dev not in by_device:
            by_device[dev] = copy.deepcopy(module).to(dev)
        out.append(by_device[dev])
    return out


# ---- the data-parallel context --------------------------------------------------------


def active_mesh() -> Optional[Mesh]:
    """The mesh of the running ``data_parallel`` step, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def activate(mesh: Optional[Mesh]):
    """Make ``mesh`` the active mesh while the block runs (a no-op for None
    or world size 1)."""
    token = _ACTIVE.set(mesh if mesh is not None and mesh.world_size > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def _rows(x, mesh: Mesh):
    if x is None or isinstance(x, (int, float, str, bool)):
        return x
    if isinstance(x, dict):
        return {k: _rows(v, mesh) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_rows(v, mesh) for v in x)
    n = x.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"a global batch of {n} does not divide over {mesh.world_size} ranks")
    b = n // mesh.world_size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def shard_batch(batch: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's contiguous rows of a global batch (a dict, tuple or list
    of arrays or tensors, or one of them); the batch itself at world size 1.  Raises when
    the batch does not divide over the ranks."""
    if mesh is None or mesh.world_size == 1:
        return batch
    return _rows(batch, mesh)


def local_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)``; under an active mesh, ``draw`` of the global batch
    (``shape[0]`` times the world size rows) cut to this rank's rows, so a
    rank's random numbers equal world size 1's rows and its generator
    advances as world size 1's."""
    mesh = active_mesh()
    shape = tuple(shape)
    if mesh is None:
        return draw(shape)
    b = shape[0]
    full = draw((b * mesh.world_size,) + shape[1:])
    return full[mesh.rank * b:(mesh.rank + 1) * b]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the active mesh's ranks (a new tensor, no gradient);
    ``t`` itself outside a mesh."""
    mesh = active_mesh()
    if mesh is None:
        return t
    return collectives.all_reduce(t.detach().clone(), mesh.group)


def reduce_metrics(metrics: dict, means: Sequence[str] = ()) -> dict:
    """A step's scalar metrics over the global batch: under an active mesh
    summed over the ranks in one all-reduce, the keys in ``means`` (means
    over this rank's equal share) then divided by the world size; the same
    dict outside a mesh."""
    mesh = active_mesh()
    if mesh is None:
        return metrics
    keys = list(metrics)
    flat = global_sum(torch.stack([metrics[k].detach().float() for k in keys]))
    return {k: flat[i] / mesh.world_size if k in means else flat[i]
            for i, k in enumerate(keys)}


def _sum_grads(grads: List[torch.Tensor], group) -> None:
    """Sum ``grads`` over ``group`` in one flat all-reduce, in order."""
    if not grads:
        return
    flat = collectives.all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


def all_reduce_gradients(params: Sequence[torch.nn.Parameter], mesh: Mesh,
                         in_blocks: Sequence[torch.nn.Parameter] = ()) -> None:
    """Sum every ``.grad`` over the data axis's ranks in one flat
    all-reduce, in parameter order: the counterpart of XLA's gradient psum
    (the reference's ``average_gradients``, here a sum because each rank's
    loss is its share of the global loss).  On a tensor-parallel mesh the
    gradients of ``in_blocks`` (replicated parameters that column-parallel
    layers use a block at a time, so that each model rank holds its own
    block's gradient: ``parallel.tp.in_blocks``) are then also summed over
    the model axis in a second one; a sharded kernel's, and a replicated
    parameter's used whole on every model rank, over the data axis only."""
    if mesh.world_size > 1:
        _sum_grads([p.grad for p in params if p.grad is not None], mesh.group)
    if mesh.n_model > 1:
        _sum_grads([p.grad for p in in_blocks if p.grad is not None], mesh.model_group)


def replicate(module: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank (one flat
    broadcast per dtype); a no-op at world size 1."""
    if mesh is None or mesh.world_size == 1:
        return module
    tensors = [t for t in list(module.parameters()) + list(module.buffers())]
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = collectives.broadcast(torch.cat([t.detach().reshape(-1) for t in group]), 0,
                                     mesh.group)
        off = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
    return module


def data_parallel(step_fn: Callable, mesh: Optional[Mesh], *,
                  batch_argnums: Sequence[int] = (1,)) -> Callable:
    """``step_fn(state, batch, ...)`` as a data-parallel step, the
    counterpart of JAX's ``data_parallel_jit``: the arguments at
    ``batch_argnums`` are global batches cut to this rank's rows
    (``shard_batch``), and the mesh is active while the step runs, so its
    BN statistics, loss normaliser, metrics and gradients are global.  At
    world size 1 it returns ``step_fn``."""
    if mesh is None or mesh.world_size == 1:
        return step_fn

    def step(*args, **kwargs):
        args = [shard_batch(a, mesh) if i in batch_argnums else a for i, a in enumerate(args)]
        with activate(mesh):
            return step_fn(*args, **kwargs)

    return step


# ---- ranks as processes ------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(devices: Sequence) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo (the
    CPU, or several ranks on one card, which NCCL refuses)."""
    devs = [torch.device(d) for d in devices]
    cuda = all(d.type == "cuda" for d in devs)
    return "nccl" if cuda and len({d.index for d in devs}) == len(devs) else "gloo"


def _worker(rank: int, world: int, init_method: str, device: str, backend: str,
            tasks, results, threads: Optional[int]) -> None:
    global _RANK_DEVICE
    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _RANK_DEVICE = dev
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))  # one node
    if backend == "gloo":
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=10))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except BaseException:  # reported to the caller, which fails the run
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world_size`` rank processes (start method ``spawn``) in one process
    group, kept for many calls: ``run(fn, *args)`` calls the module-level
    ``fn`` on every rank and returns the ranks' results in rank order.  A
    rank that raises fails the call with its traceback; a rank that dies,
    or that does not answer (waiting in a collective that a failed rank
    left), also closes the pool.

    ``devices``: each rank's device (default ``cuda:r``, or the CPU when
    ``device`` is the CPU); ``backend``: ``default_backend(devices)``
    unless given; ``threads``: ``torch.set_num_threads`` in each rank.
    Results cross the process boundary by pickling, so ``fn`` should return
    host objects (numbers, numpy arrays, dicts of them)."""

    def __init__(self, world_size: int, devices: Optional[Sequence] = None,
                 backend: Optional[str] = None, threads: Optional[int] = None,
                 device="cuda"):
        if devices is None:
            dev = resolve(device)
            if dev.type == "cuda":
                have = torch.cuda.device_count()
                if world_size > have:
                    raise ValueError(f"n_devices={world_size}: this machine has {have} CUDA "
                                     "devices")
                devices = [torch.device("cuda", r) for r in range(world_size)]
            else:
                devices = [dev] * world_size
        if len(devices) != world_size:
            raise ValueError(f"{len(devices)} devices for {world_size} ranks")
        self.devices = [str(torch.device(d)) for d in devices]
        self.backend = backend or default_backend(self.devices)
        self.world_size = world_size
        ctx = torch.multiprocessing.get_context("spawn")
        self._tasks = [ctx.SimpleQueue() for _ in range(world_size)]
        self._results = ctx.Queue()
        init = f"tcp://127.0.0.1:{_free_port()}"
        self._procs = [ctx.Process(target=_worker, daemon=True,
                                   args=(r, world_size, init, self.devices[r], self.backend,
                                         self._tasks[r], self._results, threads))
                       for r in range(world_size)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args, timeout: float = 1800.0, **kwargs) -> List[Any]:
        if self.closed:
            raise RuntimeError("the rank pool is closed")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        out: dict = {}
        failed: dict = {}
        waited = 0.0
        while len(out) + len(failed) < self.world_size:
            try:
                rank, ok, value = self._results.get(timeout=5.0)
            except queue.Empty:
                waited += 5.0
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                if dead or waited > timeout or (failed and waited > 30.0):
                    # A rank is gone or stuck (perhaps in a collective that a
                    # failed rank left): the group cannot be reused.
                    self.close()
                    lost = [f"rank {r} exited" for r in dead] or ["timed out"]
                    raise RuntimeError(f"{fn.__name__} failed on the ranks:\n" + "\n".join(
                        list(failed.values()) + lost))
                continue
            if ok:
                out[rank] = value
            else:
                failed[rank] = f"rank {rank} failed:\n{value}"
        if failed:  # every rank answered: the pool stays usable
            raise RuntimeError(f"{fn.__name__} failed on the ranks:\n"
                               + "\n".join(failed[r] for r in sorted(failed)))
        return [out[r] for r in range(self.world_size)]

    @property
    def closed(self) -> bool:
        return not self._procs

    def close(self) -> None:
        procs, self._procs = self._procs, []
        for p, q in zip(procs, self._tasks):
            if p.is_alive():
                q.put(None)
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def spawn(fn: Callable, world_size: int, args: Sequence = (), kwargs: Optional[dict] = None,
          *, devices: Optional[Sequence] = None, backend: Optional[str] = None,
          threads: Optional[int] = None, device="cuda") -> Any:
    """Run the module-level ``fn(*args, **kwargs)`` on ``world_size`` fresh
    ranks (``RankPool``) and return rank 0's result; any rank's failure
    raises.  On the CPU each rank takes ``threads`` threads (default: this
    process's threads shared out)."""
    if threads is None and torch.device(device).type == "cpu" and devices is None:
        threads = max(1, torch.get_num_threads() // world_size)
    with RankPool(world_size, devices, backend, threads, device=device) as pool:
        return pool.run(fn, *args, **(kwargs or {}))[0]


# ---- the world a training entry point runs in -----------------------------------------


class World(NamedTuple):
    """What ``enter_world`` decided: ``summary`` is rank 0's result where
    the call spawned the ranks (the caller returns it), else None;
    ``mesh`` this rank's mesh (None: one device); ``writer`` whether this
    process writes logs and checkpoints (rank 0 only); ``device`` where
    this process trains."""

    summary: Any
    mesh: Optional[Mesh]
    writer: bool
    device: Optional[torch.device]


def check_world(n_devices: int, batch_size: int, device) -> None:
    """Raise unless ``n_devices`` ranks can run on ``device`` (no more than
    the CUDA devices present; any number of CPU processes) and split a
    global batch of ``batch_size``."""
    dev = resolve(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"n_devices={n_devices}: this machine has "
                         f"{torch.cuda.device_count()} CUDA devices")
    if batch_size % n_devices:
        raise ValueError(f"batch_size={batch_size} does not divide over n_devices={n_devices}")


def enter_world(fn: Callable, n_devices: Optional[int], batch_size: int, device,
                kwargs: dict) -> World:
    """The world a training entry point ``fn(**kwargs)`` runs in.  From a
    plain process with ``n_devices`` > 1: ``check_world``, then ``fn`` on
    ``n_devices`` spawned ranks, and rank 0's result as the summary.  Inside
    a process group of more than one rank (spawned, or ``torchrun``): this
    rank's mesh (``n_devices`` None or the world size, which must divide
    ``batch_size``).  Else one device."""
    if n_devices not in (None, 1) and not dist.is_initialized():
        check_world(n_devices, batch_size, device)
        return World(spawn(fn, n_devices, kwargs=kwargs, device=device), None, False, None)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return World(None, None, True, resolve(device))
    mesh = make_mesh(n_devices, device=device)
    if batch_size % mesh.world_size:
        raise ValueError(f"batch_size={batch_size} does not divide over "
                         f"{mesh.world_size} ranks")
    return World(None, mesh, mesh.rank == 0, mesh.device)
