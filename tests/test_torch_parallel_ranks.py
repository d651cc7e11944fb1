"""What the data- and tensor-parallel tests run on the ranks of a
``parallel.RankPool``, and the one pool of two CPU ranks that a test
process shares.

No test lives here (``one_thread`` is an autouse fixture that the test
modules import).
The module imports no JAX, so a rank that unpickles one of its functions
imports it quickly; the test modules that import JAX stay in the test
process.
"""
import atexit
import os

import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu_torch import parallel
from pointcloud_segmentation_attention_tpu_torch.train import losses

_POOL = None


def shared_pool(config) -> parallel.RankPool:
    """Two gloo ranks on the CPU with one thread each and TensorBoard off
    (``PSA_TENSORBOARD=0``, which they inherit): started by the first call
    in this process, kept for every test module that calls it later, and
    closed when pytest's ``config`` is cleaned up (or the process exits)."""
    global _POOL
    if _POOL is None or _POOL.closed:
        old = os.environ.get("PSA_TENSORBOARD")
        os.environ["PSA_TENSORBOARD"] = "0"
        try:
            _POOL = parallel.RankPool(2, device="cpu", threads=1)
        finally:
            if old is None:
                del os.environ["PSA_TENSORBOARD"]
            else:
                os.environ["PSA_TENSORBOARD"] = old
        config.add_cleanup(_POOL.close)
        atexit.register(_POOL.close)
    return _POOL


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in the test process while a module runs, as in the
    ranks: tier-1 runs six workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def weighted_ce_total(logits: np.ndarray, labels: np.ndarray, weights: np.ndarray) -> float:
    """The weighted CE of a global batch from this rank's rows: each rank's
    share (its ``sum(w * ce)`` over the global count of non-zero weights)
    summed over the ranks."""

    def share(lg, lb, w):
        loss = losses.weighted_softmax_cross_entropy(
            torch.from_numpy(lg), torch.from_numpy(lb), torch.from_numpy(w))
        return float(parallel.mesh.global_sum(loss))

    mesh = parallel.make_mesh(device="cpu")
    return parallel.data_parallel(share, mesh, batch_argnums=(0, 1, 2))(logits, labels, weights)


def rows_of_draw(n: int) -> list:
    """This rank's rows of ``arange`` drawn for a global batch of ``n``
    rows a rank (``parallel.mesh.local_rows``)."""
    with parallel.mesh.activate(parallel.make_mesh(device="cpu")):
        return parallel.mesh.local_rows(lambda shape: torch.arange(shape[0]), (n,)).tolist()


def forward_backward(name: str, model_kw: dict, inputs: tuple, weights: tuple,
                     n_model=None) -> dict:
    """A train-mode forward of registry model ``name`` (drawn from seed 0)
    on the global batch ``inputs``, the loss ``sum(output * weight)`` over
    its outputs, and the backward: on one device, or with ``n_model`` under
    ``parallel.model_parallel`` on the world's ``make_mesh_2d`` (this rank's
    rows), the gradients then summed as ``TrainState.apply_gradients`` sums
    them.  Returns host values: 'outputs' (this rank's rows), 'rows', and
    'grads' at their full shapes."""
    from pointcloud_segmentation_attention_tpu_torch import models
    from pointcloud_segmentation_attention_tpu_torch.parallel import tp

    model = models.get_model(name, device="cpu", generator=torch.Generator().manual_seed(0),
                             **model_kw)

    def step(model, inputs, weights):
        out = model(*(torch.from_numpy(a) for a in inputs))
        outs = [t for t in (out if isinstance(out, tuple) else (out,)) if torch.is_tensor(t)]
        outs += [t for t in (out[-1].values() if isinstance(out[-1], dict) else ())]
        if weights:
            sum((t * torch.from_numpy(w)).sum() for t, w in zip(outs, weights)).backward()
        mesh = parallel.active_mesh()
        model_mesh = parallel.act_sharding.model_mesh()
        if model_mesh is not None:
            parallel.all_reduce_gradients(list(model.parameters()), model_mesh,
                                          tp.in_blocks(model))
        return [t.detach().numpy() for t in outs], mesh

    rows = (0, len(inputs[0]))
    if n_model is None:
        outs, _ = step(model, inputs, weights)
    else:
        mesh = parallel.make_mesh_2d(parallel.mesh.world_size() // n_model, n_model,
                                     device="cpu")
        outs, _ = parallel.model_parallel(step, mesh, model, batch_argnums=(1, 2))(
            model, inputs, weights)
        b = len(inputs[0]) // mesh.world_size
        rows = (mesh.rank * b, (mesh.rank + 1) * b)
    return dict(outputs=outs, rows=rows,
                grads={k: tp.full_tensor(model, k, p.grad).numpy() for k, p in
                       model.named_parameters() if p.grad is not None})
