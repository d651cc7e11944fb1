"""The comparison catches a broken timed path: a run at a tiny size on the
CPU, past the harness's look for a card, with one fault planted in the
program underneath, comes out not correct under the cell's own limits."""
from __future__ import annotations

import pytest
import torch

from pointcloud_segmentation_attention_tpu_torch.eval import resident_serving
from pointcloud_segmentation_attention_tpu_torch.train import device_sampler, steps
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from port_bench.tests.conftest import tiny_driver


def _state_unchanged(mp):
    def apply_gradients(self):
        self.step += 1
        return self.lr_schedule(self.step - 1)

    mp.setattr(TrainState, "apply_gradients", apply_gradients)


def _half_batch(mp):
    real = steps.seg_train_step

    def step(state, batch, *a, **k):
        half = batch["points"].shape[0] // 2
        return real(state, {key: v[:half] for key, v in batch.items()}, *a, **k)

    mp.setattr(steps, "seg_train_step", step)


def _altered_chunk_labels(mp):
    real = device_sampler.sample_chunk_batch

    def sample(*a, **k):
        out = real(*a, **k)
        out["labels"] = torch.where(out["labels"] > 0, out["labels"] % 20 + 1, out["labels"])
        return out

    mp.setattr(device_sampler, "sample_chunk_batch", sample)


def _altered_served_labels(mp):
    real = resident_serving.ResidentSceneServer._fetch

    def fetch(self, computed):
        name, labels = real(self, computed)
        labels = labels.copy()
        labels[::100] = (labels[::100] + 1) % 21
        return name, labels

    mp.setattr(resident_serving.ResidentSceneServer, "_fetch", fetch)


def _half_the_chunks_left_out(mp):
    real = resident_serving.make_resident_predict_step

    def make(*a, **k):
        step = real(*a, **k)

        def half(scene, idx):
            labels = step(scene, idx)
            labels[labels.shape[0] // 2:] = 0
            return labels

        return half

    mp.setattr(resident_serving, "make_resident_predict_step", make)


@pytest.mark.parametrize("workload, fault", [
    ("features_train", _state_unchanged),
    ("features_train", _half_batch),
    ("features_train", _altered_chunk_labels),
    ("attention_train", _half_batch),
    ("features_serve", _altered_served_labels),
    ("features_serve", _half_the_chunks_left_out),
])
def test_a_planted_fault_comes_out_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    d, cell = tiny_driver(workload)
    d.setup()
    if d.kind == "serve":
        d.window(1.0)
    d.release()
    checks = d.check(cell.limits)
    assert not all(c.ok for c in checks), [(c.name, c.value, c.limit) for c in checks]
