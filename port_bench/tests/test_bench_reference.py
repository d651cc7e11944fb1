"""The plain reference against the program, at a tiny size on the CPU: the
chunk draw bit for bit, a training step's numbers, the serving chunker and
served labels."""
from __future__ import annotations

import numpy as np
import torch

from pointcloud_segmentation_attention_tpu_torch.eval import resident_serving
from pointcloud_segmentation_attention_tpu_torch.train import device_sampler
from port_bench.drivers import train_sampler
from port_bench.lib import rooms
from port_bench.reference import serve as ref_serve
from port_bench.reference import train as ref_train
from port_bench.tests.conftest import TINY_ROOMS, tiny_driver

SEED = 2 ** 31 + 12345


def test_chunk_draw_equals_the_programs_sampler():
    rs = rooms.make_rooms(SEED, 4, TINY_ROOMS)
    scenes = device_sampler.ResidentScenes(rs, device="cpu")
    mine = [ref_train.Room(r) for r in rs]
    assert scenes.sub_len == ref_train.stripe_len(mine)
    feed = train_sampler.scene_id_stream(SEED, 4, 2, False)
    lengths = torch.tensor([r.n for r in mine])
    for step in range(4):
        ids = next(feed)["scene_ids"]
        g = train_sampler._stream_generator("cpu", SEED, 1000, step)
        draws = device_sampler.make_draws(scenes, ids, 2048, g)
        prog = device_sampler.sample_chunk_batch(scenes, ids, draws, 2048)
        g = train_sampler._stream_generator("cpu", SEED, 1000, step)
        centres = torch.randint(1 << 62, (2, ref_train.MAX_TRIES), generator=g) \
            % lengths[ids.long()][:, None]
        u = torch.rand((2, 2048), generator=g, dtype=torch.float32)
        want = ref_train.draw_batch(mine, ids.numpy(), centres.numpy(), u.numpy(),
                                    ref_train.stripe_len(mine), True, True, "cpu")
        assert set(prog) == set(want)
        for k in want:
            assert torch.equal(prog[k].to(want[k].dtype), want[k]), (step, k)


def test_training_step_numbers_agree():
    torch.set_num_threads(1)  # one summation order on both sides
    d, cell = tiny_driver("features_train", SEED)
    d.setup()
    d.release()
    r = d.readings(d.checked, d.reference_run("f32"))
    assert r["loss_gap_step1"] < 1e-6 and r["grad_norm_gap"] < 1e-5
    assert r["loss_gap"] < 2e-4 and r["change_norm_gap"] < 3e-3
    # The biases ahead of a train-mode BatchNorm are the leaves left out.
    assert all(n.endswith(".bias") and ".bn." not in n for n in d.extras["left_out_of_change"])


def test_serving_chunker_and_labels_agree():
    d, cell = tiny_driver("features_serve", SEED)
    d.setup()
    d.window(1.0)
    room = d.pool[0]
    wire = ref_serve.wire_q16(room, True, True)
    layout = resident_serving.SceneLayout("q16", len(room["points"]))
    host = layout.decode_host(layout.pack(room["points"], room["colors"], room["normals"]))
    np.testing.assert_array_equal(wire["points"], host["points"])
    idx, home = ref_serve.chunks(wire["points"], 2048)
    twin = resident_serving.deterministic_scene_chunks(wire["points"], [], 2048)
    np.testing.assert_array_equal(idx, twin.orig_idx)
    np.testing.assert_array_equal(home, twin.masks)
    assert ref_serve.chunk_count(wire["points"], 2048) == len(idx)
    d.release()
    assert d.check({"label_gap": 1e-3})[0].ok
