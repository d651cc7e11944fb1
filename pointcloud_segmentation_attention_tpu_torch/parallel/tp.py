"""Tensor parallelism: a 2-D (data x model) mesh with channel-sharded
kernels, the port's counterpart of the JAX package's ``parallel/tp.py``.

Usage, on every rank of a process group of ``n_data * n_model`` ranks::

    mesh = make_mesh_2d(n_data, n_model)
    step = model_parallel(seg_train_step, mesh, state)
    state, metrics = step(state, global_batch, dropout_seed)

Sharding rule (JAX's, parameter for parameter): a floating parameter with
ndim >= 2 whose last dim divides over the model axis, and is at least its
size, is sharded (..., 'model'): the ``PointConv`` and ``Dense`` kernels
and the T-Net's ``transform_w``.  Everything else is replicated: biases, BN
scales, biases and statistics, and kernels whose width does not divide
(the 128 x 21 classifier).  Adam's moments take the parameters' shapes.

A rank at mesh coordinates (d, m) holds block m of each sharded kernel as a
contiguous parameter of its own (``shard_state``), takes rows d of the
global batch (``shard_batch``), and runs the step with the data axis active
(``parallel.mesh.activate``: BN statistics, the loss normaliser and the
metrics over the data group) and the model axis active
(``act_sharding.activation_sharding``: column-parallel layers, whose outputs
are gathered on channel).  JAX's partitioner does the same for
``model_parallel_jit``; here every layer that holds a sharded kernel
(``PointConv``, ``Dense``, ``TransformNet``: their ``tp_columns``) does it
explicitly, and ``TrainState.apply_gradients`` sums each gradient by its
parameter's kind (``parallel.mesh.all_reduce_gradients``).

The data axis keeps ``parallel.mesh.Mesh``'s contract: a 2-D mesh's
``group``, ``rank`` and ``world_size`` are its data axis's, so every
data-parallel piece of the port runs unchanged on it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, FrozenSet, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from pointcloud_segmentation_attention_tpu_torch.device import resolve
from pointcloud_segmentation_attention_tpu_torch.parallel import collectives
from pointcloud_segmentation_attention_tpu_torch.parallel.act_sharding import (
    activation_sharding,
)
from pointcloud_segmentation_attention_tpu_torch.parallel.mesh import (
    Mesh,
    activate,
    rank_device,
    shard_batch,
)

_LAYOUT = "_tp_layout"
# (n_data, n_model) -> (the default group they were made in, data groups by
# model coordinate, model groups by data coordinate).
_GROUPS: Dict[Tuple[int, int], tuple] = {}


class Layout(NamedTuple):
    """How ``shard_state`` sharded a model: ``mesh``; ``full`` the full
    shapes of the sharded parameters; ``in_blocks`` the replicated
    parameters that their layers use a block at a time."""

    mesh: Mesh
    full: Dict[str, torch.Size]
    in_blocks: FrozenSet[str]


def _groups(n_data: int, n_model: int):
    """Every data group and every model group of a world of ``n_data *
    n_model`` ranks, made once per default group.  Every rank makes every
    group, in one order, including those it is not in (``new_group``
    requires it)."""
    world = dist.group.WORLD
    hit = _GROUPS.get((n_data, n_model))
    if hit is None or hit[0] is not world:
        data = [dist.new_group([d * n_model + m for d in range(n_data)])
                for m in range(n_model)]
        model = [dist.new_group([d * n_model + m for m in range(n_model)])
                 for d in range(n_data)]
        hit = _GROUPS[(n_data, n_model)] = (world, data, model)
    return hit[1], hit[2]


def make_mesh_2d(n_data: int, n_model: int, device="cuda",
                 coords: Optional[Tuple[int, int]] = None) -> Mesh:
    """A data-major 2-D mesh: rank ``d * n_model + m`` sits at (d, m), as
    JAX's ``make_mesh_2d`` places device ``d * n_model + m``.

    Inside an initialised process group (which must hold ``n_data *
    n_model`` ranks) the mesh carries this rank's data group (``group``,
    ``rank`` = d, ``world_size`` = n_data) and model group (``model_group``,
    ``model_rank`` = m, ``n_model``), and this rank's device
    (``rank_device(device)``).  Outside one it is a mesh of one process at
    ``coords`` (default (0, 0)) with no groups: enough for ``shard_state``
    and ``state_sharding`` (a rank built from a full checkpoint), not for a
    step."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"a {n_data} x {n_model} mesh")
    names = ("data", "model")
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world != n_data * n_model:
            raise ValueError(f"a {n_data} x {n_model} mesh inside a process group of "
                             f"{world} ranks")
        d, m = divmod(dist.get_rank(), n_model)
        if coords not in (None, (d, m)):
            raise ValueError(f"rank {dist.get_rank()} sits at {(d, m)}, not {coords}")
        data, model = _groups(n_data, n_model)
        return Mesh([[rank_device(device)]], group=data[m], rank=d, world_size=n_data,
                    axis_names=names, model_group=model[d], model_rank=m, n_model=n_model)
    d, m = (0, 0) if coords is None else coords
    if not (0 <= d < n_data and 0 <= m < n_model):
        raise ValueError(f"coordinates {coords} outside a {n_data} x {n_model} mesh")
    return Mesh([[resolve(device)]], rank=d, world_size=n_data, axis_names=names,
                model_rank=m, n_model=n_model)


def _model(state_or_model) -> nn.Module:
    return state_or_model if isinstance(state_or_model, nn.Module) else state_or_model.model


def layout(model: nn.Module) -> Optional[Layout]:
    """The model's ``Layout`` when ``shard_state`` sharded it, else None."""
    return getattr(model, _LAYOUT, None)


def _is_sharded(shape: Sequence[int], dtype: torch.dtype, n_model: int) -> bool:
    return (len(shape) >= 2 and dtype.is_floating_point and shape[-1] % n_model == 0
            and shape[-1] >= n_model)


def _full_shape(model: nn.Module, name: str, t: torch.Tensor) -> torch.Size:
    lay = layout(model)
    return lay.full[name] if lay is not None and name in lay.full else t.shape


def state_sharding(state_or_model, mesh: Mesh) -> Dict[str, tuple]:
    """The sharding rule: state-dict name -> the spec of each parameter and
    buffer, ``(None, ..., 'model')`` for a sharded one and ``()`` for a
    replicated one, from the full shapes (also of a model already sharded).
    Adam's moments take their parameter's spec."""
    model = _model(state_or_model)
    tensors = list(model.named_parameters()) + list(model.named_buffers())
    out = {}
    for name, t in tensors:
        shape = _full_shape(model, name, t)
        out[name] = ((None,) * (len(shape) - 1) + ("model",)
                     if _is_sharded(shape, t.dtype, mesh.n_model) else ())
    return out


def _plan(model: nn.Module, n_model: int) -> Tuple[List[str], FrozenSet[str]]:
    """(the parameters to shard, the replicated ones used in blocks), from
    the rule and each column-parallel layer's ``tp_columns``; raises for a
    parameter that the rule shards but no layer can run sharded."""
    sharded, blocks = [], set()
    for prefix, mod in model.named_modules():
        columns = getattr(mod, "tp_columns", None)
        if columns is None:
            continue
        kernel_name, block_names = columns
        kernel = mod.get_parameter(kernel_name)
        if _is_sharded(kernel.shape, kernel.dtype, n_model):
            at = prefix + "." if prefix else ""
            sharded.append(at + kernel_name)
            for b in block_names:
                try:
                    mod.get_parameter(b)
                except AttributeError:  # a PointConv without BN
                    continue
                blocks.add(at + b)
    rule = {name for name, p in model.named_parameters()
            if _is_sharded(p.shape, p.dtype, n_model)}
    if rule - set(sharded):
        raise NotImplementedError(f"no column-parallel layer holds {sorted(rule - set(sharded))}")
    return sharded, frozenset(blocks)


def _block(t: torch.Tensor, n_model: int, m: int) -> torch.Tensor:
    c = t.shape[-1] // n_model
    return t.detach()[..., m * c:(m + 1) * c].clone(memory_format=torch.contiguous_format)


def _set_parameter(model: nn.Module, name: str, value: torch.Tensor) -> nn.Parameter:
    owner, _, attr = name.rpartition(".")
    old = model.get_parameter(name)
    p = nn.Parameter(value, requires_grad=old.requires_grad)
    setattr(model.get_submodule(owner), attr, p)
    return p


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _rebuild_optimizer(state, old: Dict[str, nn.Parameter],
                       moments: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """A new Adam over the model's parameters (``old``: the parameters by
    name before some were replaced): each parameter keeps its old state,
    with the moments in ``moments[name]`` where given, so no key of a
    replaced parameter is left behind."""
    prev = state.optimizer
    opt = type(prev)(state.model.parameters(), **prev.defaults)
    for name, p in state.model.named_parameters():
        opt.state[p] = {**prev.state[old[name]], **moments.get(name, {})}
    state.optimizer = opt


def shard_state(state, mesh: Mesh):
    """Shard a full ``TrainState`` (or a model) for this rank of ``mesh``:
    each parameter that the rule shards becomes block ``mesh.model_rank`` of
    its last axis, a contiguous parameter of its own; Adam's state is rebuilt
    over the new parameters with its moments cut the same way.  In place;
    returns ``state``.  A state already sharded for this mesh is returned
    as it is.  Works in one process too, at a ``make_mesh_2d(coords=)``
    mesh."""
    model = _model(state)
    lay = layout(model)
    if lay is not None:
        if (lay.mesh.n_model, lay.mesh.model_rank) != (mesh.n_model, mesh.model_rank):
            raise ValueError("the state is sharded for another mesh; unshard_state it first")
        return state
    sharded, blocks = _plan(model, mesh.n_model)
    old = dict(model.named_parameters())
    full = {}
    for name in sharded:
        p = model.get_parameter(name)
        full[name] = p.shape
        if mesh.n_model > 1:
            _set_parameter(model, name, _block(p, mesh.n_model, mesh.model_rank))
    setattr(model, _LAYOUT, Layout(mesh, full, blocks))
    if hasattr(state, "optimizer") and mesh.n_model > 1:
        _rebuild_optimizer(state, old, {
            name: {k: _block(state.optimizer.state[old[name]][k], mesh.n_model,
                             mesh.model_rank) for k in _MOMENTS} for name in full})
    return state


def full_tensor(model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """``t``, the value of parameter ``name`` of ``model`` or a tensor of its
    shape (its gradient, an Adam moment), at its full shape: gathered over
    the model group where ``model`` is sharded (every rank of the group
    calls it), else ``t`` itself."""
    lay = layout(model)
    if lay is None or name not in lay.full or lay.mesh.n_model == 1:
        return t
    if lay.mesh.model_group is None:
        raise ValueError("gathering a sharded tensor needs the mesh's model group")
    return collectives.all_gather(t.detach(), lay.mesh.model_group)


def unshard_state(state, mesh: Optional[Mesh] = None):
    """The inverse of ``shard_state``: every sharded parameter and its Adam
    moments gathered to the full arrays over the model group (every rank of
    it calls this), for checkpoints and tests.  In place; returns
    ``state``."""
    model = _model(state)
    lay = layout(model)
    if lay is None:
        return state
    if mesh is not None and (mesh.n_model, mesh.model_rank) != (lay.mesh.n_model,
                                                                 lay.mesh.model_rank):
        raise ValueError("the state is sharded for another mesh")
    if lay.mesh.n_model > 1:
        old = dict(model.named_parameters())
        optimizer = getattr(state, "optimizer", None)
        moments = {} if optimizer is None else {
            name: {k: full_tensor(model, name, optimizer.state[old[name]][k])
                   for k in _MOMENTS} for name in lay.full}
        for name in lay.full:
            _set_parameter(model, name, full_tensor(model, name, old[name]))
        if optimizer is not None:
            _rebuild_optimizer(state, old, moments)
    delattr(model, _LAYOUT)
    return state


def in_blocks(model: nn.Module) -> List[nn.Parameter]:
    """The replicated parameters that ``model``'s column-parallel layers use
    a block at a time (whose gradients are summed over the model group)."""
    lay = layout(model)
    if lay is None:
        return []
    return [p for name, p in model.named_parameters() if name in lay.in_blocks]


def checkpoint_writer(model: nn.Module) -> bool:
    """Whether this process writes ``model``'s checkpoints: the rank at mesh
    coordinates (0, 0) of a sharded model (every rank of the model group
    gathers its arrays), any process otherwise."""
    lay = layout(model)
    return lay is None or (lay.mesh.rank, lay.mesh.model_rank) == (0, 0)


def state_bytes(state) -> int:
    """Bytes of this rank's parameters and Adam moments."""
    model = _model(state)
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    opt = getattr(state, "optimizer", None)
    if opt is not None:
        total += sum(v.numel() * v.element_size() for st in opt.state.values()
                     for k, v in st.items() if k in _MOMENTS)
    return total


def model_parallel(step_fn: Callable, mesh: Mesh, state_like: Any, *,
                   batch_argnums: Sequence[int] = (1,)) -> Callable:
    """``step_fn(state, batch, ...)`` as a dp x tp step over a 2-D mesh, the
    counterpart of JAX's ``model_parallel_jit``: the state (a
    ``TrainState``, or a model for ``seg_predict_step``) is sharded by the
    rule (``shard_state``, once), the arguments at ``batch_argnums`` are
    global batches cut to this rank's data rows (``shard_batch``), and the
    step runs with the data axis and the model axis active.  ``state_like``
    gives the rule its parameters; it is checked here (a parameter that the
    rule shards needs a column-parallel layer) and not kept."""
    _plan(_model(state_like), mesh.n_model)
    if ((mesh.n_model > 1 and mesh.model_group is None)
            or (mesh.world_size > 1 and mesh.group is None)):
        raise ValueError("model_parallel needs the mesh of a process group "
                         "(make_mesh_2d inside one)")

    def step(*args, **kwargs):
        args = [shard_state(a, mesh) if i == 0 else
                shard_batch(a, mesh) if i in batch_argnums else a
                for i, a in enumerate(args)]
        with activate(mesh), activation_sharding(mesh):
            return step_fn(*args, **kwargs)

    return step
