"""Multi-process self-test of the port's data parallelism, and the rank-side
functions that hold a data-parallel step against one device.

The counterpart of the JAX package's ``parallel/dist_selftest.py``: each of
N processes runs ::

    COORDINATOR_ADDRESS=localhost:PORT NUM_PROCESSES=2 PROCESS_ID=i \\
    python -m pointcloud_segmentation_attention_tpu_torch.parallel.dist_selftest \\
        --workdir W --npoints 128

``initialize_distributed`` joins the process group (NCCL on the cards, gloo
on the CPU), each process precomputes its node's scene shard
(``host_shard``) into the shared store (chunks are keyed by scene name, so
the store equals one process's), the ranks meet at a barrier and take one
data-parallel step on epoch-0 chunks of all scenes; rank 0 prints
``DISTLOSS <loss>``, which equals the one-process control (``one_dp_step``
with no process group).

``--device`` defaults to the card (``--device cpu`` runs the ranks on the
CPU, as the tests do).  ``step_outcome`` runs ``seg_train_step`` under
``parallel.data_parallel`` on the mesh of the calling rank (or on one device
outside a process group), or with ``n_model`` under ``parallel.model_parallel``
on a ``make_mesh_2d`` mesh of the process group, and returns host copies of
everything a comparison needs; ``predict_outcome`` does the same for
``seg_predict_step``.  The tests and ``chip_smoke.py`` call them on every
rank of a ``RankPool``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

_TINY = dict(sa_npoints=(16, 8, 4, 2), sa_radii=(0.2, 0.4, 0.8, 1.2),
             sa_nsample=4, sa_mlps=((8, 8),) * 4,
             fp_mlps=((8,), (8,), (8,), (8, 8)))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _mesh_and_model(model_name: str, model_kw: Optional[dict], state_dict, seed: int,
                    num_classes: int, device, n_model: Optional[int]):
    """(mesh, model on the rank's device): the world's 1-D mesh (None
    outside a process group), or with ``n_model`` its ``make_mesh_2d``; the
    model drawn from ``seed`` or loaded from ``state_dict``."""
    from pointcloud_segmentation_attention_tpu_torch import models, parallel

    world = parallel.mesh.world_size()
    if n_model is not None:
        if world % n_model:
            raise ValueError(f"n_model={n_model} does not divide a world of {world} ranks")
        mesh = parallel.make_mesh_2d(world // n_model, n_model, device=device)
    else:
        mesh = parallel.make_mesh(device=device) if world > 1 else None
    dev = mesh.device if mesh is not None else torch.device(device)
    model = models.get_model(model_name, device="cpu", num_classes=num_classes,
                             generator=torch.Generator().manual_seed(seed), **(model_kw or {}))
    if state_dict is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()})
    return mesh, model.to(dev)


def step_outcome(batch: Dict[str, np.ndarray], model_name: str = "sem_seg_features",
                 model_kw: Optional[dict] = None, *, state_dict=None, seed: int = 0,
                 dropout_seed: int = 0, steps: int = 1, num_classes: int = 21,
                 device="cuda", timed_collectives: bool = False, n_model: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None, **step_kw) -> dict:
    """``steps`` calls of ``seg_train_step`` on the global ``batch`` (host
    arrays), data-parallel over the calling rank's world (one device
    outside a process group), or with ``n_model`` tensor-parallel over the
    world's ``make_mesh_2d(world // n_model, n_model)`` (``model_parallel``).
    The model is ``get_model(model_name, **model_kw)`` drawn from ``seed``,
    or loaded from ``state_dict`` (host arrays by ``state_dict()`` key).
    Returns host values: 'loss' (a list over the steps), 'accuracy',
    'confusion', 'params' and 'buffers' after the last step, 'grads' of the
    last step (summed over the ranks), all at their full shapes (a sharded
    gradient gathered after the step, then the state by ``unshard_state``),
    'collectives' and 'launches' of the
    last step (the kernel counters, all zero on the CPU), 'step_ms' per
    step, 'world_size' (of the data axis), 'rank', 'coords' (data, model)
    and 'state_bytes' (this rank's parameters and Adam moments).  With
    ``timed_collectives`` the steps run inside ``collectives.timed()``, so
    'collectives' carries each kind's seconds (and 'step_ms' the
    synchronisations that timing adds).  With ``checkpoint_dir`` the state
    is saved there after the last step (``save_checkpoint``, step 'steps')."""
    from pointcloud_segmentation_attention_tpu_torch import parallel
    from pointcloud_segmentation_attention_tpu_torch.ops import cuda as kernels
    from pointcloud_segmentation_attention_tpu_torch.parallel import collectives, tp
    from pointcloud_segmentation_attention_tpu_torch.train import (
        TrainState,
        save_checkpoint,
        seg_train_step,
    )

    mesh, model = _mesh_and_model(model_name, model_kw, state_dict, seed, num_classes, device,
                                  n_model)
    dev = next(model.parameters()).device
    state = TrainState(model)
    if n_model is None:
        step = parallel.data_parallel(seg_train_step, mesh)
    else:
        step = parallel.model_parallel(seg_train_step, mesh, state)
        parallel.shard_state(state, mesh)
    out: dict = {"loss": [], "step_ms": []}
    for _ in range(steps):
        parallel.reset_collective_stats()
        kernels.reset_launches()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with collectives.timed() if timed_collectives else contextlib.nullcontext():
            state, m = step(state, batch, dropout_seed, num_classes=num_classes, **step_kw)
            out["loss"].append(float(m["loss"]))  # syncs the step
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    model = state.model
    out.update(
        collectives=parallel.collective_stats(), launches=kernels.launch_counts(),
        accuracy=float(m["accuracy"]), confusion=_host(m["confusion"]),
        grads={k: _host(tp.full_tensor(model, k, p.grad)) for k, p in model.named_parameters()
               if p.grad is not None},
        world_size=1 if mesh is None else mesh.world_size,
        rank=0 if mesh is None else mesh.rank,
        coords=(0, 0) if mesh is None else (mesh.rank, mesh.model_rank),
        state_bytes=tp.state_bytes(state))
    if checkpoint_dir is not None:
        save_checkpoint(checkpoint_dir, state, steps)
    parallel.unshard_state(state)
    out.update(params={k: _host(p) for k, p in model.named_parameters()},
               buffers={k: _host(b) for k, b in model.named_buffers()})
    return out


def predict_outcome(points: np.ndarray, features: Optional[np.ndarray] = None,
                    model_name: str = "sem_seg_features", model_kw: Optional[dict] = None, *,
                    state_dict=None, seed: int = 0, num_classes: int = 21, device="cuda",
                    n_model: Optional[int] = None) -> dict:
    """``seg_predict_step`` on the global batch ``points`` (and
    ``features``), on one device, or with ``n_model`` tensor-parallel over
    the world's ``make_mesh_2d`` (``model_parallel``, this rank's data rows).
    The model as ``step_outcome``'s.  Returns host values: 'logits' and
    'labels' (argmax) of this rank's rows, 'rows' (their slice of the
    global batch), 'collectives' and 'launches'."""
    from pointcloud_segmentation_attention_tpu_torch import parallel
    from pointcloud_segmentation_attention_tpu_torch.ops import cuda as kernels
    from pointcloud_segmentation_attention_tpu_torch.train import seg_predict_step

    mesh, model = _mesh_and_model(model_name, model_kw, state_dict, seed, num_classes, device,
                                  n_model)
    dev = next(model.parameters()).device
    step = seg_predict_step
    if n_model is not None:
        step = parallel.model_parallel(seg_predict_step, mesh, model, batch_argnums=(1, 2))
        parallel.shard_state(model, mesh)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) if a is not None else None
            for a in (points, features)]
    parallel.reset_collective_stats()
    kernels.reset_launches()
    logits = step(model, *args)
    b = len(points) // (1 if mesh is None else mesh.world_size)
    d = 0 if mesh is None else mesh.rank
    return dict(logits=_host(logits), labels=_host(logits.argmax(dim=-1)),
                rows=(d * b, (d + 1) * b), collectives=parallel.collective_stats(),
                launches=kernels.launch_counts())


def one_dp_step(precompute_dir: str, scene_names: Sequence[str], npoints: int,
                n_devices: Optional[int] = None, device="cuda") -> float:
    """One deterministic data-parallel train step of the tiny flagship on
    the epoch-0 chunks of all scenes; returns the loss.  Runs the same in
    one process (the control) and on every rank of a process group."""
    from pointcloud_segmentation_attention_tpu_torch.data import pipeline
    from pointcloud_segmentation_attention_tpu_torch.data.scannet import precompute

    del n_devices  # the world decides; kept for the JAX package's signature
    chunks = [precompute.load_chunk(precompute.train_chunk_path(precompute_dir, 0, name))
              for name in scene_names]
    batch = pipeline.make_batch(chunks, use_colors=True, use_normals=True)
    return step_outcome(batch, model_kw=dict(in_features=6, **_TINY), seed=0, dropout_seed=1,
                        device=device)["loss"][0]


def main(argv=None) -> None:
    import argparse

    import torch.distributed as dist

    from pointcloud_segmentation_attention_tpu_torch.data.scannet import precompute
    from pointcloud_segmentation_attention_tpu_torch.data.scannet.scenes import read_split
    from pointcloud_segmentation_attention_tpu_torch.parallel import collectives
    from pointcloud_segmentation_attention_tpu_torch.parallel.dist import (
        host_shard,
        initialize_distributed,
    )

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", required=True)
    p.add_argument("--npoints", type=int, default=128)
    p.add_argument("--device", default="cuda",
                   help="cuda (one rank a card, NCCL) or cpu (gloo)")
    args = p.parse_args(argv)

    torch.set_num_threads(1)
    initialize_distributed(backend="gloo" if args.device == "cpu" else None)
    data_root = os.path.join(args.workdir, "scannet")
    precompute_dir = os.path.join(args.workdir, "chunks")
    train_scenes = read_split(os.path.join(data_root, "splits"), "train")
    # Each node precomputes its scene shard into the shared store.
    precompute.precompute_train_chunks(data_root, host_shard(train_scenes), precompute_dir,
                                       epochs=1, npoints=args.npoints)
    if dist.is_initialized():
        collectives.barrier()
    loss = one_dp_step(precompute_dir, train_scenes, args.npoints, device=args.device)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"DISTLOSS {loss:.8f}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
