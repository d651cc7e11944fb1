"""Chunk dicts -> model batches (host-side numpy), batching and a
prefetch thread.

``assemble_features`` builds the per-point features; ``make_batch`` stacks
training chunks into one batch, as the JAX package's ``data/pipeline.py``
does, in the f32, compact or packed wire format; ``batched`` groups a
chunk stream into batches and ``prefetch`` runs a batch iterator on a
background thread.  Batches stay numpy: the copy to the device is made by
the step that consumes them (``train/steps.py``).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.data.scannet.label_map import (
    TRAIN_LABEL_WEIGHTS,
)
from pointcloud_segmentation_attention_tpu_torch.data.wire import (
    WireSpec,
    pack_chunks,
    split_wire_batch,
)
from pointcloud_segmentation_attention_tpu_torch.utils import profiler


def assemble_features(
    colors: Optional[np.ndarray],
    normals: Optional[np.ndarray],
    use_colors: bool,
    use_normals: bool,
) -> Optional[np.ndarray]:
    """Concat the selected per-point features: colors scaled from [0, 255]
    to [0, 1], then normals.  None when no features are selected."""
    parts = []
    if use_colors and colors is not None:
        parts.append(np.asarray(colors, np.float32) / 255.0)
    if use_normals and normals is not None:
        parts.append(np.asarray(normals, np.float32))
    if not parts:
        return None
    return np.concatenate(parts, axis=-1)


def make_batch(chunks: List[Dict[str, np.ndarray]], use_colors: bool, use_normals: bool,
               wire: str = "f32") -> Dict[str, np.ndarray]:
    """Stack chunk dicts (points, labels, colors, normals, weights) into one
    batch.  The stored weight only marks the inner box: the f32 batch's
    ``weights = TRAIN_LABEL_WEIGHTS[label] * (stored weight != 0)``.

    ``wire='compact'`` keeps labels and the inner-box mask as uint8, colors
    as raw uint8 and normals as f16 (about half the bytes to copy);
    ``train.steps.expand_wire_batch`` rebuilds the f32 features and weights
    on the device.  The packed formats (``data/wire.py``: 'packed',
    'packed_q16', with an optional 'xK' suffix) give ``{'packed': rows}``,
    or K byte-column slices 'packed0'.. for 'xK'."""
    spec, n_splits = WireSpec.from_format(wire, n=chunks[0]["points"].shape[0],
                                          use_colors=use_colors, use_normals=use_normals)
    if spec is not None:
        return split_wire_batch({"packed": pack_chunks(chunks, spec)}, n_splits)
    if wire not in ("f32", "compact"):
        raise ValueError(f"unknown wire format {wire!r}")
    points = np.stack([c["points"] for c in chunks]).astype(np.float32)
    labels = np.stack([c["labels"] for c in chunks])
    mask = np.stack([c["weights"] for c in chunks]) != 0
    if wire == "compact":
        batch = {"points": points, "labels": labels.astype(np.uint8),
                 "mask": mask.astype(np.uint8)}
        if use_colors:
            batch["colors_u8"] = np.stack([c["colors"] for c in chunks]).astype(np.uint8)
        if use_normals:
            batch["normals_f16"] = np.stack([c["normals"] for c in chunks]).astype(np.float16)
        return batch
    labels = labels.astype(np.int32)
    weights = TRAIN_LABEL_WEIGHTS[labels] * mask.astype(np.float32)
    batch = {"points": points, "labels": labels, "weights": weights.astype(np.float32)}
    features = assemble_features(
        np.stack([c["colors"] for c in chunks]) if use_colors else None,
        np.stack([c["normals"] for c in chunks]) if use_normals else None,
        use_colors, use_normals,
    )
    if features is not None:
        batch["features"] = features
    return batch


def batched(
    chunk_iter: Iterable[Dict[str, np.ndarray]],
    batch_size: int,
    use_colors: bool,
    use_normals: bool,
    pad_final: bool = False,
    wire: str = "f32",
) -> Iterator[Dict[str, np.ndarray]]:
    """Group chunks into ``make_batch`` batches of exactly ``batch_size``.
    The remainder is dropped, or with ``pad_final=True`` (evaluation)
    padded with label-0, zero-weight copies of its first chunk, which add
    nothing to a weighted loss or to metrics over label > 0."""
    buf: List[Dict[str, np.ndarray]] = []
    for chunk in chunk_iter:
        buf.append(chunk)
        if len(buf) == batch_size:
            yield make_batch(buf, use_colors, use_normals, wire)
            buf = []
    if buf and pad_final:
        pad = dict(buf[0])
        pad["labels"] = np.zeros_like(buf[0]["labels"])
        pad["weights"] = np.zeros_like(buf[0]["weights"])
        buf.extend([pad] * (batch_size - len(buf)))
        yield make_batch(buf, use_colors, use_normals, wire)


_END = object()


def prefetch(iterator: Iterable, depth: int = 4) -> Iterator:
    """Run ``iterator`` on a background thread, ``depth`` items ahead; an
    exception of the producer is raised again in the consumer.  Closing the
    returned generator stops the thread after the item it is producing.
    The consumer's wait for each item is the span ``prefetch.wait``."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer
            put((_END, e))
            return
        put((_END, None))

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            with profiler.span("prefetch.wait"):
                item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _END:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
