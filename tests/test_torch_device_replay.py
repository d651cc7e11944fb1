"""The port's device-resident training input (``train/device_replay.py``)
against the JAX package's and the pack store's replay.

- ``DeviceReplay.index_stream`` gives the JAX package's indices, and with
  one epoch a pack-store epoch, the rows ``PackReader.replay_batches``
  gives, in the same order (remainders carried over);
- ``gather_batch`` equals ``unpack_batch`` of the same rows bit for bit;
- ``rotate_batch_z`` turns each sample about z by one angle: norms, z and
  the color columns unchanged (float32 rounding, 1e-5);
- the trainer's ``input='resident'`` run equals its ``input='packed'`` run
  on the q16 store bit for bit (losses, summary, final checkpoint): both
  read the same rows and decode them with the same ops (``wire_format=
  'packed_q16'`` in both, so validation reads the same batches);
- a corpus over ``device_replay_budget_mb`` raises, as in JAX.
"""
import json
import os

import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu.data.wire import WireSpec as JWireSpec
from pointcloud_segmentation_attention_tpu.train import device_replay as jreplay
from pointcloud_segmentation_attention_tpu_torch.data.scannet import packstore, precompute, scenes
from pointcloud_segmentation_attention_tpu_torch.data.wire import (
    WireSpec,
    pack_arrays,
    unpack_batch,
)
from pointcloud_segmentation_attention_tpu_torch.train import device_replay, latest_checkpoint
from pointcloud_segmentation_attention_tpu_torch.train import trainer
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig
from pointcloud_segmentation_attention_tpu_torch.utils.logging import read_metrics

TINY_HIERARCHY = {"sa_npoints": [16, 8, 4, 2], "sa_radii": [0.2, 0.4, 0.8, 1.2],
                  "sa_nsample": 4, "sa_mlps": [[8, 8], [8, 8], [8, 8], [8, 8]],
                  "fp_mlps": [[8], [8], [8], [8, 8]]}


def _corpus(n_rows: int, layout: str, n: int = 32, seed: int = 0):
    rng = np.random.RandomState(seed)
    spec = WireSpec(n=n, layout=layout)
    rows = pack_arrays((rng.rand(n_rows, n, 3) * [1.9, 1.9, 2.6]).astype(np.float32),
                       rng.randint(0, 21, (n_rows, n)), rng.rand(n_rows, n) > 0.3,
                       rng.randint(0, 256, (n_rows, n, 3)),
                       (rng.rand(n_rows, n, 3) * 2 - 1).astype(np.float32), spec)
    return rows, spec


def _write_pack(pack_dir: str, rows: np.ndarray, spec: WireSpec, epochs: int) -> None:
    """A pack store of ``epochs`` epoch files cut from ``rows``, as
    ``write_pack_from_npz`` lays them out."""
    per = len(rows) // epochs
    os.makedirs(pack_dir)
    for e in range(epochs):
        rows[e * per:(e + 1) * per].tofile(os.path.join(pack_dir, f"epoch-{e:04d}.pack"))
    with open(os.path.join(pack_dir, packstore.META_NAME), "w") as f:
        json.dump({"n": spec.n, "layout": spec.layout, "use_colors": spec.use_colors,
                   "use_normals": spec.use_normals, "row_nbytes": spec.row_nbytes,
                   "scenes": [f"s{i}" for i in range(per)], "epochs": epochs}, f)


@pytest.mark.parametrize("epoch_len", [5, 7, 15])
def test_index_stream_matches_jax_and_pack_replay(tmp_path, epoch_len):
    rows, spec = _corpus(14, "q16")
    if epoch_len > len(rows):
        for replay in (device_replay.DeviceReplay, jreplay.DeviceReplay):
            with pytest.raises(ValueError, match="epoch_len"):
                replay(rows, spec, epoch_len=epoch_len)
        return
    mine = device_replay.DeviceReplay(rows, spec, epoch_len=epoch_len, device="cpu")
    theirs = jreplay.DeviceReplay(rows, JWireSpec(*spec), epoch_len=epoch_len)
    got, want = mine.index_stream(3, seed=4), theirs.index_stream(3, seed=4)
    batches = [next(got) for _ in range(12)]
    for b in batches:
        w = next(want)
        assert b.dtype == np.int32 and w.dtype == np.int32
        np.testing.assert_array_equal(b, w)
    assert torch.equal(mine.device_corpus, torch.from_numpy(rows))
    if epoch_len == 7:  # two epoch files of 7 rows: the pack replay's rows and order
        _write_pack(str(tmp_path / "pack"), rows, spec, 2)
        packed = packstore.PackReader(str(tmp_path / "pack")).replay_batches(3, shuffle_seed=4)
        for b in batches:
            np.testing.assert_array_equal(next(packed)["packed"], rows[b])


def test_corpus_nbytes_matches_jax():
    for layout in ("f32", "q16"):
        spec = WireSpec(n=8192, layout=layout)
        assert device_replay.corpus_nbytes(1201, spec) == \
            jreplay.corpus_nbytes(1201, JWireSpec(*spec)) == 1201 * spec.row_nbytes


@pytest.mark.parametrize("layout", ["f32", "q16"])
def test_gather_batch_equals_unpack_batch(layout):
    rows, spec = _corpus(9, layout, n=33)  # row_nbytes % 4 != 0 for f32
    replay = device_replay.DeviceReplay(rows, spec, device="cpu")
    idx = np.array([4, 0, 8, 4], np.int32)
    got = device_replay.gather_batch(replay.device_corpus, idx, spec)
    want = unpack_batch(torch.from_numpy(rows[idx]), spec)
    assert sorted(got) == sorted(want) == ["features", "labels", "points", "weights"]
    for k in want:
        assert torch.equal(got[k], want[k]), k
    pinned_like = device_replay.gather_batch(replay.device_corpus, torch.from_numpy(idx), spec)
    assert torch.equal(pinned_like["points"], want["points"])


def test_rotate_batch_z_keeps_norms_z_and_colors():
    rows, spec = _corpus(4, "q16", n=64, seed=1)
    batch = device_replay.gather_batch(torch.from_numpy(rows), np.arange(4), spec)
    gen = torch.Generator().manual_seed(3)
    out = device_replay.rotate_batch_z(batch, spec, gen)
    p, q = batch["points"], out["points"]
    assert torch.equal(q[..., 2], p[..., 2])
    torch.testing.assert_close(q[..., :2].norm(dim=-1), p[..., :2].norm(dim=-1),
                               rtol=1e-5, atol=1e-5)
    f, g = batch["features"], out["features"]
    assert torch.equal(g[..., :3], f[..., :3])          # colors
    assert torch.equal(g[..., 5], f[..., 5])            # normals' z
    torch.testing.assert_close(g[..., 3:5].norm(dim=-1), f[..., 3:5].norm(dim=-1),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(out["labels"], batch["labels"])
    # One angle per sample, the same for its points and its normals.
    ang_p = torch.atan2(q[..., 1], q[..., 0]) - torch.atan2(p[..., 1], p[..., 0])
    ang_n = torch.atan2(g[..., 4], g[..., 3]) - torch.atan2(f[..., 4], f[..., 3])
    wrap = lambda a: torch.remainder(a, 2 * np.pi)  # noqa: E731
    per_sample = wrap(ang_p[:, :1])
    d = wrap(ang_p - per_sample + 1.0) - 1.0
    assert d.abs().max() < 1e-3
    d = wrap(ang_n - per_sample + 1.0) - 1.0
    assert d.abs().max() < 1e-3
    assert len(set(np.round(per_sample.flatten().numpy(), 3))) == 4


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("replay")
    root = str(d / "scannet")
    splits = scenes.write_synthetic_dataset(root, n_train=4, n_val=1, n_points=3000)
    pre = str(d / "chunks")
    precompute.precompute_train_chunks(root, splits["train"], pre, epochs=2, npoints=128)
    precompute.precompute_val_chunks(root, splits["val"], pre, npoints=128)
    base = dict(data_root=root, precompute_dir=pre, model="sem_seg_features",
                model_overrides=TINY_HIERARCHY, batch_size=2, n_points=128, epochs=2,
                n_epochs_to_val=1, n_devices=1, save_every_epochs=1)
    return d, base


def _run(d, base, tag, **over):
    cfg = TrainConfig(**{**base, "log_dir": str(d / tag), **over})
    summary = trainer.train(cfg, device="cpu")
    with np.load(latest_checkpoint(cfg.ckpt_dir)) as z:
        final = {k: z[k] for k in z.files}
    losses = [(r["train_loss"] if "train_loss" in r else r["val_loss"])
              for r in read_metrics(os.path.join(cfg.log_dir, "train_metrics.jsonl"))]
    return summary, final, losses


def test_resident_run_equals_packed_q16_run(store):
    d, base = store
    packed = _run(d, base, "packed_q16", input="packed", wire_format="packed_q16")
    # The same wire_format, so validation reads the same q16 batches too.
    resident = _run(d, base, "resident", input="resident", wire_format="packed_q16")
    assert resident[0] == packed[0] and resident[0]["final_step"] == 4
    assert resident[2] == packed[2] and len(packed[2]) == 4
    assert sorted(resident[1]) == sorted(packed[1])
    for k in packed[1]:
        np.testing.assert_array_equal(resident[1][k], packed[1][k], err_msg=k)


def test_resident_augment_trains(store):
    d, base = store
    summary, final, losses = _run(d, base, "augment", device_replay=True, resident_augment=True,
                                  epochs=1)
    assert summary["final_step"] == 2 and np.all(np.isfinite(losses))


def test_corpus_over_budget_raises(store):
    d, base = store
    cfg = TrainConfig(**{**base, "log_dir": str(d / "budget")}, input="resident",
                      device_replay_budget_mb=0)
    with pytest.raises(ValueError, match="device_replay_budget_mb"):
        trainer.train(cfg, device="cpu")
