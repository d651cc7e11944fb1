"""ScanNet trainer: the port's training entry point.

The counterpart of the JAX package's ``train/trainer.py``: ``train(config)``
replays precomputed chunks (``input='npz'``) or the packed-record store
(``input='packed'``) through a prefetch thread, or keeps that store on the
device and sends only each step's row indices (``input='resident'`` or
``device_replay=True``, ``train/device_replay.py``), or keeps the raw scenes
on the device and cuts every step's chunks there, validating on chunks cut
on the fly (``input='sampler'``, ``train/device_sampler.py``: no precompute
directory is read or written).  It runs ``seg_train_step`` (with the
configured ``remat``) on one device, accumulates the epoch's loss, accuracy
and confusion matrix on the device and fetches them once an epoch,
validates every ``n_epochs_to_val`` epochs, keeps the best-val-mIoU
checkpoint and writes periodic ones.  Checkpoints and logs have the JAX
package's formats.

Run it as ``python -m pointcloud_segmentation_attention_tpu_torch.train.trainer
--device=cuda|cpu --data_root=... [--<TrainConfig field>=...]``.

Not ported yet, each raising ``NotImplementedError``:
``compute_dtype='bfloat16'`` and more than one device.
"""
from __future__ import annotations

import argparse
import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from pointcloud_segmentation_attention_tpu_torch import models
from pointcloud_segmentation_attention_tpu_torch.data import pipeline
from pointcloud_segmentation_attention_tpu_torch.data.scannet import packstore, precompute
from pointcloud_segmentation_attention_tpu_torch.data.scannet.chunks import (
    CHUNK_SIZE,
    CONTEXT_MARGIN,
    grid_chunks_for_eval,
)
from pointcloud_segmentation_attention_tpu_torch.data.scannet.scenes import (
    load_scene_mapped,
    read_split,
    scene_path,
)
from pointcloud_segmentation_attention_tpu_torch.data.wire import WireSpec, split_wire_batch
from pointcloud_segmentation_attention_tpu_torch.device import resolve
from pointcloud_segmentation_attention_tpu_torch.train import (
    device_replay,
    device_sampler,
    schedules,
    steps,
)
from pointcloud_segmentation_attention_tpu_torch.train.checkpoints import (
    BestKeeper,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from pointcloud_segmentation_attention_tpu_torch.train.metrics import StreamingMeanIoU
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig
from pointcloud_segmentation_attention_tpu_torch.utils.logging import MetricLogger


def _refuse_mixed_precision(config: TrainConfig) -> None:
    if config.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={config.compute_dtype!r}: mixed precision is not ported yet "
            "(ROADMAP Queue 1 item 4)")


def select_model(config: TrainConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
    """The registry model of ``config.model`` with ``model_overrides``, fed
    3 x use_colors + 3 x use_normals feature channels; the single-layer
    attention model takes ``attention_single_layer`` as its layer."""
    _refuse_mixed_precision(config)
    kw = dict(num_classes=config.num_classes,
              in_features=3 * int(config.use_colors) + 3 * int(config.use_normals))
    if config.model_overrides:
        kw.update({k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
                   if isinstance(v, list) else v for k, v in config.model_overrides.items()})
    if config.model == "sem_seg_attention_single_layer":
        kw["layer_idx"] = config.attention_single_layer
    return models.get_model(config.model, device=device, generator=generator, **kw)


def _make_wire_spec(config: TrainConfig) -> Optional[WireSpec]:
    """The WireSpec of a packed ``wire_format`` (with or without an 'xK'
    split suffix), else None."""
    spec, _ = WireSpec.from_format(config.wire_format, n=config.n_points,
                                   use_colors=config.use_colors, use_normals=config.use_normals)
    return spec


def resolve_input_mode(config: TrainConfig) -> str:
    """'auto' derives the input path from the flags (device_replay ->
    resident, a packed wire_format -> packed, else npz); an explicit mode
    is checked against conflicting flags."""
    mode = config.input
    packed = _make_wire_spec(config) is not None
    if mode == "auto":
        return "resident" if config.device_replay else "packed" if packed else "npz"
    if mode not in ("npz", "packed", "resident", "sampler"):
        raise ValueError(f"input must be auto|npz|packed|resident|sampler, got {mode!r}")
    if mode in ("npz", "sampler") and packed:
        raise ValueError(
            f"input='{mode}' replays raw arrays — drop the packed "
            f"wire_format={config.wire_format!r} (it only applies to the "
            "packed/resident record paths)")
    if mode == "sampler" and config.device_replay:
        raise ValueError("input='sampler' and device_replay are exclusive")
    if mode in ("npz", "packed") and config.device_replay:
        raise ValueError(
            f"input='{mode}' ships batches from host but device_replay=True "
            "requests the device-resident corpus — use input='resident' (or "
            "'auto'), or drop device_replay")
    return mode


def _refuse_unported(config: TrainConfig) -> None:
    _refuse_mixed_precision(config)
    if config.n_devices not in (None, 1):
        raise NotImplementedError(
            f"n_devices={config.n_devices}: training on more than one device is not "
            "ported yet (ROADMAP Queue 1 item 7)")


def make_eval_state(config: TrainConfig, *, device="cuda") -> TrainState:
    """A train state of ``config``'s model and Adam, the template that a
    checkpoint of ``train`` (or of the JAX trainer) restores into."""
    model = select_model(config, device=resolve(device),
                         generator=torch.Generator().manual_seed(config.seed))
    return TrainState(model)


def _precomputed_epochs(precompute_dir: str, scenes) -> int:
    """How many precomputed epochs exist for the first scene."""
    n = 0
    while os.path.exists(precompute.train_chunk_path(precompute_dir, n, scenes[0])):
        n += 1
    if n == 0:
        raise FileNotFoundError(
            f"no precomputed chunks in {precompute_dir}; run `python -m "
            "pointcloud_segmentation_attention_tpu_torch.data.scannet.precompute_cli`")
    return n


def _pack_reader(config: TrainConfig, wire_spec, train_scenes, epochs: int):
    """The pack store of ``wire_spec`` beside the precomputed chunks, written
    where it is missing."""
    pack_dir = os.path.join(
        config.precompute_dir,
        f"pack_{wire_spec.layout}_c{int(wire_spec.use_colors)}"
        f"n{int(wire_spec.use_normals)}_p{wire_spec.n}")
    packstore.write_pack_from_npz(config.precompute_dir, pack_dir, epochs, train_scenes,
                                  wire_spec)
    return packstore.PackReader(pack_dir)


def _resident_replay(config: TrainConfig, reader, wire_spec, dev) -> device_replay.DeviceReplay:
    """The whole pack store on the device, after the budget check."""
    total_mb = device_replay.corpus_nbytes(reader.epochs * len(reader.scenes),
                                           wire_spec) / 2**20
    if total_mb > config.device_replay_budget_mb:
        raise ValueError(
            f"packed corpus is {total_mb:.0f} MB > device_replay_budget_mb="
            f"{config.device_replay_budget_mb} — raise the budget or disable device_replay")
    corpus = np.concatenate([reader._epoch_rows(e) for e in range(reader.epochs)])
    return device_replay.DeviceReplay(corpus, wire_spec, epoch_len=len(reader.scenes),
                                      device=dev)


def _resident_indices(replay: device_replay.DeviceReplay, config: TrainConfig, dev):
    """The endless stream of ``{'resident_idx': (B,) int32}``, pinned on a
    card so the step copies it without a host sync."""
    for idx in replay.index_stream(config.batch_size, seed=config.seed):
        t = torch.from_numpy(idx)
        yield {"resident_idx": t.pin_memory() if dev.type == "cuda" else t}


def _sampler_scenes(config: TrainConfig, train_scenes, dev) -> device_sampler.ResidentScenes:
    """The train scenes resident on the device for ``input='sampler'``.  The
    budget is checked from the scenes' array headers before any body is
    loaded."""
    lengths = [np.load(scene_path(config.data_root, "points", name), mmap_mode="r").shape[0]
               for name in train_scenes]
    device_sampler.check_budget(lengths, config.use_colors, config.use_normals,
                                config.sampler_budget_mb)
    return device_sampler.ResidentScenes(
        [load_scene_mapped(config.data_root, name) for name in train_scenes], device=dev,
        use_colors=config.use_colors, use_normals=config.use_normals,
        chunk_size=config.chunk_size, margin=config.context_margin)


def _scene_id_stream(config: TrainConfig, n_scenes: int, dev):
    """The endless stream of ``{'scene_ids': (B,) int32}``: a permutation of
    the train scenes a pass, cut into batches (one batch of the permutation
    resized to B when there are fewer scenes than B), the JAX trainer's
    stream of process 0 (it seeds ``seed + 31 * process_index``); pinned on
    a card so the step copies it without a host sync."""
    rng = np.random.RandomState(config.seed)
    b = config.batch_size
    n_full = n_scenes // b * b
    while True:
        order = rng.permutation(n_scenes)
        for i in range(0, max(n_full, b), b):
            t = torch.from_numpy(np.resize(order[i:i + b], b).astype(np.int32))
            yield {"scene_ids": t.pin_memory() if dev.type == "cuda" else t}


def _onfly_val_chunks(data_root: str, val_scenes, n_points: int, seed: int = 0,
                      chunk_size: float = CHUNK_SIZE, margin: float = CONTEXT_MARGIN):
    """Full-coverage validation chunks cut from the raw val scenes
    (``grid_chunks_for_eval``, a ``RandomState(seed)`` a scene): the val
    input of ``input='sampler'``, where no precompute directory exists."""
    for name in val_scenes:
        sc = load_scene_mapped(data_root, name)
        out = grid_chunks_for_eval(sc["points"], sc["labels"], sc["colors"], sc["normals"],
                                   n_points, rng=np.random.RandomState(seed),
                                   chunk_size=chunk_size, margin=margin)
        for i in range(len(out["points"])):
            yield {k: out[k][i] for k in ("points", "labels", "colors", "normals", "weights")}


def _host_batches(config: TrainConfig, mode: str, wire_spec, train_scenes, epochs: int):
    """The endless stream of host (numpy) training batches of ``mode``."""
    if mode == "packed":
        reader = _pack_reader(config, wire_spec, train_scenes, epochs)
        _, n_splits = WireSpec.from_format(config.wire_format, n=config.n_points,
                                           use_colors=config.use_colors,
                                           use_normals=config.use_normals)
        return (split_wire_batch(b, n_splits)
                for b in reader.replay_batches(config.batch_size, shuffle_seed=config.seed))
    return pipeline.batched(
        precompute.replay_train_chunks(config.precompute_dir, epochs, train_scenes,
                                       shuffle_seed=config.seed),
        config.batch_size, config.use_colors, config.use_normals, wire=config.wire_format)


def _sum(acc, value):
    return value if acc is None else acc + value


def train(config: TrainConfig, max_steps: Optional[int] = None,
          max_seconds: Optional[float] = None, *, device="cuda") -> dict:
    """Train on ``device`` (no fallback: 'cuda' without a card raises) and
    return ``{'final_train_loss', 'best_val_miou', 'final_step'}``.
    ``max_seconds`` stops at a wall-clock budget, checked before each step;
    such a run always writes a final checkpoint.

    Each epoch logs train_loss, train_accuracy (epoch means), train_miou,
    learning_rate (of the epoch's last step), points_per_sec (the epoch's
    steps and the waits for their input, over wall time; validation and
    checkpoints are not in it), input_wait_s (time spent waiting for the
    next batch) and epoch_s; each validation logs val_miou, val_loss and
    val_accuracy."""
    dev = resolve(device)
    mode = resolve_input_mode(config)
    _refuse_unported(config)
    train_scenes = read_split(config.split_dir, "train")
    if config.use_subset:
        train_scenes = train_scenes[: len(train_scenes) // 3]
    val_scenes = read_split(config.split_dir, "val")
    n_train = len(train_scenes)
    lr = functools.partial(schedules.scannet_learning_rate, batch_size=config.batch_size,
                           n_train_scenes=n_train)
    bn = functools.partial(schedules.scannet_bn_momentum, batch_size=config.batch_size,
                           n_train_scenes=n_train)
    wire_spec = _make_wire_spec(config)
    if mode in ("packed", "resident") and wire_spec is None:
        # The packed record paths default to the q16 records.
        wire_spec = WireSpec(n=config.n_points, layout="q16", use_colors=config.use_colors,
                             use_normals=config.use_normals)
    step_kwargs = dict(bn_schedule=bn, num_classes=config.num_classes, remat=config.remat)
    val_chunks = None
    if mode == "sampler":
        sampler_step = device_sampler.make_sampling_train_step(
            _sampler_scenes(config, train_scenes, dev), config.n_points,
            augment=config.resident_augment, **step_kwargs)
        source = _scene_id_stream(config, n_train, dev)

        def train_step(state, batch):
            return sampler_step(state, batch["scene_ids"], config.seed)

        val_chunks = _val_chunk_source(config, val_scenes)
    elif mode == "resident":
        epochs_avail = _precomputed_epochs(config.precompute_dir, train_scenes)
        replay = _resident_replay(
            config, _pack_reader(config, wire_spec, train_scenes, epochs_avail), wire_spec, dev)
        resident_step = device_replay.make_resident_train_step(
            wire_spec, augment=config.resident_augment, **step_kwargs)
        source = _resident_indices(replay, config, dev)

        def train_step(state, batch):
            return resident_step(state, replay.device_corpus, batch["resident_idx"],
                                 config.seed)
    else:
        source = _host_batches(config, mode, wire_spec, train_scenes,
                               _precomputed_epochs(config.precompute_dir, train_scenes))

        def train_step(state, batch):
            return steps.seg_train_step(state, batch, config.seed, wire_spec=wire_spec,
                                        **step_kwargs)

    train_iter = pipeline.prefetch(source, depth=4)
    try:
        batch = next(train_iter)
        model = select_model(config, device=dev,
                             generator=torch.Generator().manual_seed(config.seed))
        state = TrainState(model, lr_schedule=lr)
        if config.resume:
            ckpt = (latest_checkpoint(config.ckpt_dir)
                    or latest_checkpoint(config.ckpt_dir, prefix="best"))
            if ckpt is not None:
                restore_checkpoint(ckpt, state)
        return _train_loop(config, state, batch, train_iter, train_step, wire_spec,
                           val_scenes, val_chunks, n_train, max_steps, max_seconds)
    finally:
        train_iter.close()


def _val_chunk_source(config: TrainConfig, val_scenes):
    """``() -> iterator`` of the on-the-fly val chunks; with
    ``cache_val_chunks`` they are cut at the first validation and replayed
    from memory after it (they are the same every time)."""
    cache = []

    def chunks():
        if cache:
            return iter(cache)
        gen = _onfly_val_chunks(config.data_root, val_scenes, config.n_points,
                                chunk_size=config.chunk_size, margin=config.context_margin)
        if not config.cache_val_chunks:
            return gen
        cache.extend(gen)
        return iter(cache)

    return chunks


def _train_loop(config, state, batch, train_iter, train_step, wire_spec, val_scenes,
                val_chunks, n_train, max_steps, max_seconds) -> dict:
    logger = MetricLogger(config.log_dir, "train")
    best = BestKeeper(config.ckpt_dir)
    train_miou = StreamingMeanIoU(config.num_classes)
    steps_per_epoch = max(1, n_train // config.batch_size)
    total_steps = max_steps or config.epochs * steps_per_epoch
    summary = {}
    loss_acc = acc_acc = conf_acc = None   # on the device, fetched once an epoch
    wait_s = 0.0
    train_t0 = epoch_t0 = time.perf_counter()
    step_idx = -1
    try:
        for step_idx in range(total_steps):
            if max_seconds is not None and time.perf_counter() - train_t0 > max_seconds:
                step_idx -= 1  # this step did not run
                break
            state, m = train_step(state, batch)
            t = time.perf_counter()
            batch = next(train_iter)
            wait_s += time.perf_counter() - t
            loss_acc = _sum(loss_acc, m["loss"])
            acc_acc = _sum(acc_acc, m["accuracy"])
            conf_acc = _sum(conf_acc, m["confusion"])
            if (step_idx + 1) % steps_per_epoch:
                continue
            epoch = (step_idx + 1) // steps_per_epoch
            fetched = torch.cat([loss_acc.reshape(1), acc_acc.reshape(1),
                                 conf_acc.reshape(-1)]).cpu().numpy()  # syncs the epoch
            epoch_s = max(time.perf_counter() - epoch_t0, 1e-9)
            train_miou.update_confusion(fetched[2:].reshape(conf_acc.shape))
            miou, _ = train_miou.result()
            summary["final_train_loss"] = float(fetched[0]) / steps_per_epoch
            logger.log(step_idx + 1, {
                "train_loss": summary["final_train_loss"],
                "train_accuracy": float(fetched[1]) / steps_per_epoch,
                "train_miou": miou,
                "learning_rate": float(m["learning_rate"]),
                "points_per_sec": steps_per_epoch * config.batch_size * config.n_points
                / epoch_s,
                "input_wait_s": wait_s,
                "epoch_s": epoch_s,
            })
            train_miou.reset()
            loss_acc = acc_acc = conf_acc = None
            if config.save_every_epochs and epoch % config.save_every_epochs == 0:
                save_checkpoint(config.ckpt_dir, state, step_idx + 1)
            if epoch % config.n_epochs_to_val == 0:
                val = evaluate(config, state, val_scenes, wire_spec=wire_spec,
                               chunk_iter=val_chunks() if val_chunks else None)
                logger.log(step_idx + 1, {f"val_{k}": v for k, v in val.items()})
                if best.maybe_save(state, step_idx + 1, val["miou"]):
                    summary["best_val_miou"] = val["miou"]
            wait_s = 0.0
            epoch_t0 = time.perf_counter()
    finally:
        logger.close()
    if max_seconds is not None and step_idx + 1 < total_steps:
        save_checkpoint(config.ckpt_dir, state, step_idx + 1)
    summary["final_step"] = int(state.step)
    summary.setdefault("best_val_miou", best.best if best.best > -np.inf else None)
    return summary


def evaluate(config: TrainConfig, state: TrainState, val_scenes, *, wire_spec=None,
             chunk_iter=None) -> dict:
    """One pass over the precomputed val chunks (or ``chunk_iter``) in
    batches of ``batch_size``, the last one padded: ``{'miou', 'loss',
    'accuracy'}``, loss and accuracy the means over batches.  The sums stay
    on the device and are fetched once."""
    it = pipeline.batched(
        chunk_iter if chunk_iter is not None
        else precompute.replay_val_chunks(config.precompute_dir, val_scenes),
        config.batch_size, config.use_colors, config.use_normals, pad_final=True,
        wire=config.wire_format)
    conf = loss_sum = acc_sum = None
    n_batches = 0
    batches = pipeline.prefetch(it)
    try:
        for batch in batches:
            m = steps.seg_eval_step(state, batch, num_classes=config.num_classes,
                                    wire_spec=wire_spec)
            conf = _sum(conf, m["confusion"])
            loss_sum = _sum(loss_sum, m["loss"])
            acc_sum = _sum(acc_sum, m["accuracy"])
            n_batches += 1
    finally:
        batches.close()
    miou = StreamingMeanIoU(config.num_classes)
    if not n_batches:
        return {"miou": miou.result()[0], "loss": 0.0, "accuracy": 0.0}
    fetched = torch.cat([loss_sum.reshape(1), acc_sum.reshape(1), conf.reshape(-1)]).cpu()
    fetched = fetched.numpy()
    miou.update_confusion(fetched[2:].reshape(conf.shape))
    return {"miou": miou.result()[0], "loss": float(fetched[0]) / n_batches,
            "accuracy": float(fetched[1]) / n_batches}


def main(argv=None) -> None:
    """``--device`` (default cuda) plus every ``TrainConfig`` field as a flag
    (``--config file.json`` first, flags over it); writes the config to
    ``{log_dir}/config.json`` and prints the summary."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda")
    known, rest = parser.parse_known_args(argv)
    config = TrainConfig.from_args(rest)
    os.makedirs(config.log_dir, exist_ok=True)
    with open(os.path.join(config.log_dir, "config.json"), "w") as f:
        f.write(config.to_json())
    print(train(config, device=known.device))


if __name__ == "__main__":
    main()
