"""Device memory of the flagship train step for each ``remat`` mode; the
counterpart of the JAX package's ``utils/mem_analysis.py``.

PyTorch has no ahead-of-time memory analysis, so ``analyze`` measures: for
each mode, a fresh ``TrainState`` of ``sem_seg_features`` (colors and
normals, seeded weights) takes one warm-up ``seg_train_step`` (which also
fills Adam's moments), its gradients are dropped, the peak statistics are
reset, and one more step runs.  Each row holds ``remat`` and, in MiB:

- ``argument_mb``: the parameters, buffers, Adam moments and batch on the
  device before the step;
- ``peak_mb``: ``torch.cuda.max_memory_allocated()`` during the step, less
  ``held_mb``;
- ``temp_mb``: ``peak_mb`` minus ``argument_mb``, the most the step held
  beyond its arguments (activations, gradients, scratch);
- ``output_mb``: the tensors the step newly returns (its metrics; the
  state is updated in place);
- ``temp_plus_args_mb``: ``temp_mb`` plus ``argument_mb``;
- ``held_mb``: what the process had allocated beside the step's arguments
  when the step began: the caller's other tensors, and what the warm-up
  step left allocated (cuBLAS workspaces, cached tables; ~100 MiB when
  the tool runs alone).

It needs a card: the CPU has no peak statistics, and ``device='cpu'``
raises.  Run on the card::

    python -m pointcloud_segmentation_attention_tpu_torch.utils.mem_analysis \\
        [--batch 16] [--n 8192]
"""
from __future__ import annotations

import argparse
import copy
import gc
from typing import Dict, Iterable, List

import torch

from pointcloud_segmentation_attention_tpu_torch.device import resolve

MODES = ("none", "dots", "full")
MIB = 2 ** 20


def _bytes(tensors: Iterable[torch.Tensor], dev: torch.device) -> int:
    """Bytes of the distinct storages among ``tensors`` that live on ``dev``."""
    seen = {}
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device == dev:
            s = t.untyped_storage()
            seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def _state_tensors(state) -> List[torch.Tensor]:
    out = list(state.model.parameters()) + list(state.model.buffers())
    for per_param in state.optimizer.state.values():
        out += [v for v in per_param.values() if isinstance(v, torch.Tensor)]
    return out


def analyze(b: int = 16, n: int = 8192, modes=MODES, device="cuda") -> List[Dict]:
    """One row per ``remat`` mode (see the module's docstring)."""
    from pointcloud_segmentation_attention_tpu_torch import models
    from pointcloud_segmentation_attention_tpu_torch.train import TrainState, seg_train_step
    from pointcloud_segmentation_attention_tpu_torch.utils.bench_ops import step_batch

    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError(f"mem_analysis measures the card's allocator and needs a card; "
                           f"{dev} has no peak memory statistics")
    if dev.index is None:  # tensors report their card's index
        dev = torch.device("cuda", torch.cuda.current_device())
    model = models.seeded_model("sem_seg_features", seed=0, device="cpu")
    batch = step_batch(b, n, dev)
    rows = []
    for mode in modes:
        state = TrainState(copy.deepcopy(model).to(dev))
        seg_train_step(state, batch, remat=mode)
        state.model.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.synchronize(dev)
        args = _bytes(_state_tensors(state) + list(batch.values()), dev)
        held = torch.cuda.memory_allocated(dev) - args
        torch.cuda.reset_peak_memory_stats(dev)
        _, metrics = seg_train_step(state, batch, remat=mode)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - held
        out = _bytes(metrics.values(), dev)
        rows.append({"remat": mode, "argument_mb": args / MIB, "peak_mb": peak / MIB,
                     "temp_mb": (peak - args) / MIB, "output_mb": out / MIB,
                     "temp_plus_args_mb": peak / MIB, "held_mb": held / MIB,
                     "device": torch.cuda.get_device_name(dev)})
        del state, metrics
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    rows = analyze(args.batch, args.n, device=args.device)
    print(f"device={rows[0]['device']} batch={args.batch} n={args.n}")
    print(f"{'remat':8s} {'temp MB':>10s} {'args MB':>10s} {'peak MB':>10s} "
          f"{'temp+args MB':>13s}")
    for r in rows:
        print(f"{r['remat']:8s} {r['temp_mb']:10.1f} {r['argument_mb']:10.1f} "
              f"{r['peak_mb']:10.1f} {r['temp_plus_args_mb']:13.1f}")


if __name__ == "__main__":
    main()
