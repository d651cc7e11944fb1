"""The resident server's staged chunk count and chunks on the card
(``eval/resident_serving.py``): the count ``_stage`` reads back from the
card's chunker, and the chunks it lays out at the slots that count needs,
for rooms of 50k-440k vertices (the benchmark's room generator), against
the host count ``chunk_count`` and ``make_scene_chunker``; and labels
served twice through the pipeline (two rooms in flight, tensors made on
the staging stream and read on the compute stream) equal those served one
room at a time.  The file imports no JAX, so its tests run on the card's
machine::

    PSA_TEST_TPU=1 python -m pytest tests/test_torch_serving_card.py -m cuda

On the CPU they skip.
"""
import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu_torch import models
from pointcloud_segmentation_attention_tpu_torch.eval import resident_serving as rs
from port_bench.lib.rooms import make_room

NPOINTS = 8192
ROOM_SIZES = (50_000, 120_000, 250_000, 440_000)


@pytest.fixture(scope="module")
def server():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = models.seeded_model("sem_seg_features", seed=0, device="cuda")
    return rs.ResidentSceneServer(model, NPOINTS, batch_size=16, layout="q16",
                                  pipeline_depth=2, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", ROOM_SIZES)
def test_staged_count_and_chunks_on_the_card(server, n):
    room = make_room(n, 3)
    name, n_staged, n_pad, x, (scene, idx, mask, n_chunks), ready, _ = server._stage(room)
    ready.synchronize()
    layout = server._layout(n_pad)
    buf = layout.pack(room["points"], room["colors"], room["normals"])
    assert n_staged == n
    assert x == int(n_chunks) == rs.chunk_count(layout.decode_host(buf)["points"][:n], NPOINTS)
    assert len(idx) == rs._bucket(x, 4 * server.batch_size)
    want = rs.make_scene_chunker(layout, len(idx), NPOINTS)(torch.from_numpy(buf).cuda(), n)
    for got, ref in zip((idx, mask, n_chunks), want):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_pipelined_labels_equal_one_room_at_a_time(server):
    rooms = [dict(make_room(n, 5 + i), scene_name=f"room{i}")
             for i, n in enumerate((440_000, 50_000, 250_000, 120_000, 90_000))]
    alone = {}
    for room in rooms:
        alone[room["scene_name"]] = server.predict_scene(room)
        torch.cuda.synchronize()
    for _ in range(2):
        served = dict(server.predict_scenes(iter(rooms)))
        assert list(served) == [r["scene_name"] for r in rooms]
        for room in rooms:
            np.testing.assert_array_equal(served[room["scene_name"]], alone[room["scene_name"]])
