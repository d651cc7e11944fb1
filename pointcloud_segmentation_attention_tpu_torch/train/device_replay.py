"""Device-resident chunk replay: the packed corpus stays on the card.

The packed record corpus is small next to device memory (ScanNet: 1201
scenes x 8192 points x 14 B ~ 138 MB a precomputed epoch in q16), so it is
copied to the device once and each step gathers its rows there by index:
a step copies one (B,) index array to the device instead of a batch.

Epoch and shuffle semantics are ``precompute.replay_train_chunks``' and
``packstore.PackReader.replay_batches``': each pass walks the uploaded
epochs with a fresh per-epoch permutation, remainders carried over, so the
rows of every step equal the pack replay's.  The port's own copy of the JAX
package's ``train/device_replay.py``.

Under data parallelism (``mesh=``) every rank keeps the whole corpus on its
device and reads the same global index stream; a step takes its rows of
the indices, and the rotation angles are drawn for the global batch
(``parallel.mesh.local_rows``), so the ranks together take world size 1's
step.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from pointcloud_segmentation_attention_tpu_torch.data.wire import WireSpec, unpack_batch
from pointcloud_segmentation_attention_tpu_torch.device import resolve
from pointcloud_segmentation_attention_tpu_torch.parallel.mesh import data_parallel, local_rows
from pointcloud_segmentation_attention_tpu_torch.train import steps
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState


def corpus_nbytes(n_rows: int, spec: WireSpec) -> int:
    return n_rows * spec.row_nbytes


class DeviceReplay:
    """Copy a packed record corpus to the device once; stream per-step batch
    indices.

    corpus: (K, row_nbytes) u8 (e.g. the epoch files of a
    ``packstore.PackReader``, or ``wire.pack_chunks``).  ``epoch_len`` rows
    form one epoch (default: all K); the permutation reshuffles every epoch.
    ``mesh``: a rank's data-parallel mesh; the corpus goes to its device.
    """

    def __init__(self, corpus: np.ndarray, spec: WireSpec, epoch_len: Optional[int] = None,
                 mesh=None, device="cuda"):
        self.spec = spec
        self.n_rows = int(corpus.shape[0])
        self.epoch_len = int(epoch_len or self.n_rows)
        if not 0 < self.epoch_len <= self.n_rows:
            raise ValueError(
                f"epoch_len {self.epoch_len} outside (0, {self.n_rows}]: the stream would "
                "index rows that are not in the corpus")
        dev = mesh.device if mesh is not None else resolve(device)
        self.device_corpus = torch.from_numpy(np.ascontiguousarray(corpus)).to(dev)

    def index_stream(self, batch_size: int, seed: int = 0) -> Iterator[np.ndarray]:
        """Endless (B,) int32 batch indices with a per-epoch reshuffle;
        remainder rows carry into the next epoch's batches."""
        rng = np.random.RandomState(seed)
        carry = np.empty((0,), np.int64)
        # Cover all rows: a trailing partial epoch keeps its (shorter) slot.
        bases = list(range(0, self.n_rows, self.epoch_len))
        while True:
            for base in bases:
                length = min(self.epoch_len, self.n_rows - base)
                order = np.concatenate([carry, base + rng.permutation(length)])
                n_full = len(order) // batch_size * batch_size
                for i in range(0, n_full, batch_size):
                    yield order[i:i + batch_size].astype(np.int32)
                carry = order[n_full:]


def gather_batch(device_corpus: torch.Tensor, idx, spec: WireSpec) -> Dict[str, torch.Tensor]:
    """(K, row) resident u8 corpus + (B,) indices (numpy, or a tensor: a
    pinned one is copied without a host sync) -> the standard batch dict
    (``unpack_batch``), on the corpus's device."""
    if isinstance(idx, np.ndarray):
        idx = torch.from_numpy(idx)
    idx = idx.to(device_corpus.device, non_blocking=True)
    return unpack_batch(device_corpus[idx], spec)


def rotate_batch_z(batch: Dict[str, torch.Tensor], spec: WireSpec,
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A fresh random z-rotation per sample of a resident batch, on its
    device: one angle per sample from ``generator`` (a generator of that
    device), applied to the points and, when present, to the normals
    columns of the features (``chunks.random_z_rotation``'s semantics).
    Under a data-parallel mesh the angles are the global batch's rows."""
    points = batch["points"]
    angle = local_rows(lambda shape: torch.rand(shape, generator=generator, device=points.device,
                                                dtype=torch.float32),
                       (points.shape[0],)) * (2.0 * np.pi)
    c, s = torch.cos(angle)[:, None], torch.sin(angle)[:, None]

    def rot(v):  # (B, N, 3) about z by the per-sample angle
        x, y, z = v[..., 0], v[..., 1], v[..., 2]
        return torch.stack([x * c + y * s, -x * s + y * c, z], dim=-1)

    out = dict(batch)
    out["points"] = rot(points)
    if spec.use_normals and "features" in batch:
        off = 3 * int(spec.use_colors)
        feats = batch["features"]
        out["features"] = torch.cat([feats[..., :off], rot(feats[..., off:off + 3]),
                                     feats[..., off + 3:]], dim=-1)
    return out


def _augment_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The rotation stream of one step, seeded from (seed, 77, step), apart
    from the dropout stream's (seed, step) (the JAX step folds 77 and the
    step into its key).  Its numbers are not JAX's."""
    mixed = np.random.SeedSequence((seed, 77, step)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def make_resident_train_step(spec: WireSpec, mesh=None, augment=False, **step_kwargs):
    """``(state, corpus, idx, seed) -> (state, metrics)``: ``seg_train_step``
    on the batch gathered from the resident corpus.  The state is updated in
    place, as ``seg_train_step`` does (the JAX step's ``donate`` has no
    counterpart).
    ``augment=True`` rotates each sample about z by a fresh angle every step
    (``rotate_batch_z``, seeded from ``seed`` and the state's step).
    With a data-parallel ``mesh`` the step takes the global indices and runs
    on this rank's rows (``parallel.data_parallel``)."""

    def step(state: TrainState, corpus: torch.Tensor, idx, seed: int = 0):
        batch = gather_batch(corpus, idx, spec)
        if augment:
            batch = rotate_batch_z(batch, spec,
                                   _augment_generator(corpus.device, seed, state.step))
        return steps.seg_train_step(state, batch, seed, **step_kwargs)

    return data_parallel(step, mesh, batch_argnums=(2,))
