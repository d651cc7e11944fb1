"""Packed-record chunk store: replay without decoding (numpy only).

Each precomputed training epoch becomes one flat file of fixed-size wire
records (``data/wire.py``), so replay is ``np.memmap`` plus one fancy-index
copy per epoch, and a batch is already the single buffer that is copied to
the device.

Layout on disk::

    pack_dir/
      meta.json            {n, layout, use_colors, use_normals, row_nbytes,
                            scenes: [...], epochs: K}
      epoch-0000.pack      (n_scenes, row_nbytes) u8, C order
      epoch-0001.pack      ...

The port's own copy of the JAX package's ``data/scannet/packstore.py``:
the same chunks give the same files and the same batches.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.data.scannet import precompute
from pointcloud_segmentation_attention_tpu_torch.data.wire import WireSpec, pack_chunks

META_NAME = "meta.json"


def _epoch_path(pack_dir: str, epoch: int) -> str:
    return os.path.join(pack_dir, f"epoch-{epoch:04d}.pack")


def write_pack_from_npz(
    precompute_dir: str,
    pack_dir: str,
    epochs: int,
    scene_names: Sequence[str],
    spec: WireSpec,
) -> int:
    """Pack the precomputed npz chunks of ``epochs`` epochs into the store;
    returns the rows written.  An epoch file that exists is kept, so a
    larger ``epochs`` extends the store, and ``meta.json`` never shrinks
    ``epochs``.  A store written for other scenes or another record layout
    raises.  Each epoch file is written to a temporary name and renamed."""
    os.makedirs(pack_dir, exist_ok=True)
    meta = {
        "n": spec.n, "layout": spec.layout,
        "use_colors": spec.use_colors, "use_normals": spec.use_normals,
        "row_nbytes": spec.row_nbytes,
        "scenes": list(scene_names), "epochs": epochs,
    }
    meta_path = os.path.join(pack_dir, META_NAME)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            old = json.load(f)
        mismatched = [k for k in ("n", "layout", "use_colors", "use_normals", "row_nbytes",
                                  "scenes") if old.get(k) != meta[k]]
        if mismatched:
            raise ValueError(
                f"pack store {pack_dir!r} was written for different {mismatched} — "
                "delete it to rebuild (its epoch files do not match the current chunks)")
        meta["epochs"] = max(meta["epochs"], old.get("epochs", 0))
    written = 0
    for epoch in range(epochs):
        path = _epoch_path(pack_dir, epoch)
        if os.path.exists(path):
            continue
        rows = pack_chunks([precompute.load_chunk(precompute.train_chunk_path(
            precompute_dir, epoch, name)) for name in scene_names], spec)
        # A temporary name per writer: hosts building one store on a shared
        # file system must not interleave into one file.
        tmp = f"{path}.tmp.{os.getpid()}"
        rows.tofile(tmp)
        os.replace(tmp, path)
        written += len(rows)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return written


class PackReader:
    """A packed store replayed as an endless stream of wire batches."""

    def __init__(self, pack_dir: str):
        with open(os.path.join(pack_dir, META_NAME)) as f:
            meta = json.load(f)
        self.spec = WireSpec(n=meta["n"], layout=meta["layout"],
                             use_colors=meta["use_colors"], use_normals=meta["use_normals"])
        if self.spec.row_nbytes != meta["row_nbytes"]:
            raise ValueError(
                f"pack meta row_nbytes {meta['row_nbytes']} != {self.spec.row_nbytes} "
                "computed from the spec — the wire layout changed since this pack was written")
        self.pack_dir = pack_dir
        self.epochs = meta["epochs"]
        self.scenes: List[str] = meta["scenes"]
        self._maps: Dict[int, np.ndarray] = {}

    def _epoch_rows(self, epoch: int) -> np.ndarray:
        mm = self._maps.get(epoch)
        if mm is None:
            mm = np.memmap(_epoch_path(self.pack_dir, epoch), dtype=np.uint8, mode="r"
                           ).reshape(len(self.scenes), self.spec.row_nbytes)
            self._maps[epoch] = mm
        return mm

    def replay_batches(self, batch_size: int, shuffle_seed: int = 0
                       ) -> Iterator[Dict[str, np.ndarray]]:
        """Endless ``{'packed': (B, row_nbytes) u8}`` batches in the order of
        ``precompute.replay_train_chunks``: each pass walks every epoch, the
        rows reshuffled per epoch by one ``RandomState(shuffle_seed)``, and
        an epoch's remainder is carried into the next epoch's batches."""
        rng = np.random.RandomState(shuffle_seed)
        carry: Optional[np.ndarray] = None
        while True:
            for epoch in range(self.epochs):
                rows = self._epoch_rows(epoch)
                shuffled = rows[rng.permutation(len(rows))]  # one copy out of the mapping
                if carry is not None and len(carry):
                    shuffled = np.concatenate([carry, shuffled], axis=0)
                n_full = len(shuffled) // batch_size * batch_size
                for i in range(0, n_full, batch_size):
                    yield {"packed": shuffled[i:i + batch_size]}
                carry = shuffled[n_full:].copy()
