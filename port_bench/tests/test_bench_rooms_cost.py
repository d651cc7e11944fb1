"""The room generator and the cost model, on the CPU."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from port_bench.cost import kernels, model
from port_bench.lib import rooms

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
SIZE = {"median": 150000, "sigma": 0.5, "min": 50000, "max": 600000}
TINY = {"median": 20000, "sigma": 0.5, "min": 12000, "max": 40000}


def _cfg(name):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)


def test_rooms_are_one_set_in_an_order_drawn_from_the_seed():
    a = rooms.make_rooms(5, 4, TINY)
    b = rooms.make_rooms(5, 4, TINY)
    c = rooms.make_rooms(2 ** 31 + 6, 4, TINY)
    for ra, rb in zip(a, b):
        for k in ra:
            np.testing.assert_array_equal(ra[k], rb[k])
    key = [len(r["points"]) for r in a]
    assert sorted(key) == sorted(len(r["points"]) for r in c) and len(set(key)) == 4
    for r in a:
        twin = next(x for x in c if len(x["points"]) == len(r["points"]))
        np.testing.assert_array_equal(r["points"], twin["points"])
    r = a[0]
    assert r["points"].dtype == np.float32 and r["labels"].dtype == np.int32
    assert r["colors"].dtype == np.uint8
    np.testing.assert_allclose(np.linalg.norm(r["normals"], axis=1), 1.0, rtol=1e-5)
    assert r["labels"].min() >= 0 and r["labels"].max() <= 20
    assert 0.12 < (r["labels"] == 0).mean() < 0.18


def test_room_sizes_are_the_log_normals_quantiles():
    s = rooms.room_sizes(32, SIZE["median"], SIZE["sigma"], SIZE["min"], SIZE["max"])
    assert list(s) == sorted(s) and SIZE["min"] <= s.min() and s.max() <= SIZE["max"]
    assert abs(np.median(s) / SIZE["median"] - 1) < 0.03
    assert abs(np.std(np.log(s)) - SIZE["sigma"]) < 0.05


@pytest.mark.parametrize("n", [50000, 150000, 440000])
def test_room_density_stays_at_five_thousand_a_square_metre(n):
    r = rooms.make_room(n, 0)
    floor = r["points"][r["labels"] == 2]  # labelled floor vertices
    extent = floor[:, :2].max(0) - floor[:, :2].min(0)
    assert abs(n / (extent[0] * extent[1]) / 5000 - 1) < 0.02
    assert len(r["points"]) == n


def _chain(c_in, widths):
    total = 0
    for c in widths:
        total += c_in * c
        c_in = c
    return total


def test_forward_flops_match_a_hand_count():
    # sem_seg_features, one cloud of 8192: SA members, FP rows, the head.
    sa = [(1024 * 32, 9, (32, 32, 64)), (256 * 32, 67, (64, 64, 128)),
          (64 * 32, 131, (128, 128, 256)), (16 * 32, 259, (256, 256, 512))]
    fp = [(64, 768, (256, 256)), (256, 384, (256, 256)), (1024, 320, (256, 128)),
          (8192, 134, (128, 128, 128))]
    want = sum(2 * r * _chain(c, w) for r, c, w in sa + fp) + 2 * 8192 * (128 * 128 + 128 * 21)
    feats = _cfg("sem_seg_features")
    assert model.forward_flops(feats, 1, 8192) == want
    assert model.train_step_flops(feats, 16, 8192) == 3 * 16 * want
    # sem_seg_attention: xyz only (3 channels into SA1, 0 skip features at FP4),
    # plus per level K/V over every member, the query per group, two products.
    sa = [(1024 * 32, 3, (32, 32, 64)), (256 * 32, 67, (64, 64, 128)),
          (64 * 32, 131, (128, 128, 256)), (16 * 32, 259, (256, 256, 512))]
    fp[-1] = (8192, 128, (128, 128, 128))
    att = sum(2 * (r * 2 * c_out ** 2 + (r // 32) * c_out ** 2 + r * 2 * c_out)
              for r, _, (*_, c_out) in sa)
    want = (sum(2 * r * _chain(c, w) for r, c, w in sa + fp)
            + 2 * 8192 * (128 * 128 + 128 * 21) + att)
    assert model.forward_flops(_cfg("sem_seg_attention"), 1, 8192) == want
    # The K/V projections: ~17 G MACs a B16 forward (2 C^2 a member, 4 levels).
    kv = sum(16 * r * 2 * w[-1] ** 2 for r, _, w in sa)
    assert abs(kv / 1e9 - 17.2) < 0.1


def test_fps_bound_at_sa1_is_chip_smokes():
    # chip_smoke.py's kernel table: FPS SA1 B16 8192 -> 1024 bound 0.0180 ms (ops).
    assert round(kernels.bound_s(*kernels.fps(16, 8192, 1024)) * 1e3, 4) == 0.0180
    # Its ball query at SA1 counts every point when no ball fills: 0.0160 ms.
    assert round(kernels.bound_s(*kernels.ball_query(16, 8192, 1024, 32,
                                                     16 * 1024 * 8192)) * 1e3, 4) == 0.0160


def test_backward_bounds_only_where_gradients_flow():
    cfg = _cfg("sem_seg_features")
    serve = kernels.forward_bounds(cfg, 16, 8192, train=False)
    train = kernels.forward_bounds(cfg, 16, 8192, train=True)
    assert serve["group_gather_bwd"] == 0 and serve["three_interpolate_bwd"] == 0
    # No gather backward at SA1 (its input features need no gradient).
    want = sum(kernels.bound_s(*kernels.gather_bwd(16, n, 3 + c, m, 32))
               for n, c, m in ((1024, 64, 256), (256, 128, 64), (64, 256, 16)))
    assert train["group_gather_bwd"] == pytest.approx(want)
    for k in ("fps", "ball_query", "group_gather", "three_nn", "three_interpolate"):
        assert train[k] == serve[k]
