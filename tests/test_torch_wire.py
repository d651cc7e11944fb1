"""The port's packed wire (``data/wire.py``) and batching against the JAX
package's.

Seeded chunks are packed by both packages and must give the same bytes.
``unpack_batch`` runs in the port on the CPU, and in JAX two ways:

- op by op (eager), the expressions as written: on the f32 layout every
  output must be bit-identical; on the q16 layout the points may differ by
  1 float32 ulp (``mn + q * (scale / 65535)``) and the rest must not;
- jitted, as ``tests/test_wire.py`` and the JAX train step run it: XLA
  rewrites a division by a constant into a product with its reciprocal
  (``colors / 255``, ``normals / 127``, ``scale / 65535``), which is not
  correctly rounded, so float outputs may differ by 1 ulp there; integer
  outputs and the weights must be bit-identical.

The port keeps the correctly rounded division: its decoded colors equal the
host's f32 features bit for bit, on the CPU and on the card.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu.data import pipeline as jpipeline
from pointcloud_segmentation_attention_tpu.data import wire as jwire
from pointcloud_segmentation_attention_tpu.train import steps as jsteps
from pointcloud_segmentation_attention_tpu_torch import models as tmodels
from pointcloud_segmentation_attention_tpu_torch.data import pipeline as tpipeline
from pointcloud_segmentation_attention_tpu_torch.data import wire as twire
from pointcloud_segmentation_attention_tpu_torch.train import steps as tsteps
from test_torch_model import TINY

FORMATS = ["f32", "compact", "packed", "packed_q16", "packed_q16x4", "packedx2",
           "packed_q16x10", "packed_f32", "q16", "bogus"]
FEATURES = [(True, True), (True, False), (False, True), (False, False)]


def _chunks(b=3, n=64, seed=0):
    rng = np.random.RandomState(seed)
    extent = np.array([1.9, 1.9, 2.6], np.float32)
    return [{
        "points": (rng.rand(n, 3) * extent).astype(np.float32),
        "labels": rng.randint(0, 21, n).astype(np.int32),
        "colors": rng.randint(0, 256, (n, 3)).astype(np.int32),
        "normals": (rng.rand(n, 3) * 2 - 1).astype(np.float32),
        "weights": (rng.rand(n) > 0.3).astype(np.float32),
    } for _ in range(b)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n", [64, 33])
def test_wire_spec_matches_jax(fmt, n):
    for colors, normals in FEATURES:
        tspec, tk = twire.WireSpec.from_format(fmt, n, colors, normals)
        jspec, jk = jwire.WireSpec.from_format(fmt, n, colors, normals)
        assert tk == jk
        assert (tspec is None) == (jspec is None)
        if tspec is not None:
            assert tuple(tspec) == tuple(jspec)
            assert tspec.row_nbytes == jspec.row_nbytes
            assert tspec.header_nbytes == jspec.header_nbytes
            assert sum(nb for _, nb in tspec.sections()) == tspec.row_nbytes


@pytest.mark.parametrize("layout", ["f32", "q16"])
@pytest.mark.parametrize("n", [64, 33])
@pytest.mark.parametrize("features", FEATURES)
def test_pack_bytes_match_jax(layout, n, features):
    chunks = _chunks(n=n, seed=n)
    tspec = twire.WireSpec(n, layout, *features)
    jspec = jwire.WireSpec(n, layout, *features)
    got = twire.pack_chunks(chunks, tspec)
    want = jwire.pack_chunks(chunks, jspec)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    stacked = [np.stack([c[k] for c in chunks]) for k in ("points", "labels", "weights",
                                                          "colors", "normals")]
    args = stacked[:2] + [stacked[2] != 0, stacked[3] if features[0] else None,
                          stacked[4] if features[1] else None]
    np.testing.assert_array_equal(twire.pack_arrays(*args, tspec),
                                  jwire.pack_arrays(*args, jspec))


@pytest.mark.parametrize("layout", ["f32", "q16"])
@pytest.mark.parametrize("n", [64, 33])
@pytest.mark.parametrize("features", FEATURES)
def test_unpack_batch_matches_jax(layout, n, features):
    spec = twire.WireSpec(n, layout, *features)
    if n == 33 and features[0]:  # odd n with colors: rows of a multiple of 4 bytes plus 1
        assert spec.row_nbytes % 4 != 0
    packed = twire.pack_chunks(_chunks(n=n, seed=7 + n), spec)
    jspec = jwire.WireSpec(*spec)
    eager = jwire.unpack_batch(jnp.asarray(packed), jspec)
    jitted = jax.jit(lambda p: jwire.unpack_batch(p, jspec))(jnp.asarray(packed))
    got = twire.unpack_batch(_t(packed), spec)
    assert sorted(got) == sorted(eager) == sorted(jitted)
    for k in eager:
        g, w, wj = got[k].numpy(), np.asarray(eager[k]), np.asarray(jitted[k])
        assert g.dtype == w.dtype == wj.dtype and g.shape == w.shape == wj.shape, k
        if layout == "q16" and k == "points":
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
        if k in ("points", "features"):
            np.testing.assert_array_max_ulp(g, wj, maxulp=1)
        else:
            np.testing.assert_array_equal(g, wj, err_msg=k)
    # A batch's rows need not start at offset 0 of their storage.
    shifted = np.zeros((packed.shape[0], packed.shape[1] + 1), np.uint8)
    shifted[:, 1:] = packed
    again = twire.unpack_batch(_t(shifted)[:, 1:], spec)
    for k in got:
        np.testing.assert_array_equal(again[k].numpy(), got[k].numpy(), err_msg=k)


def test_unpack_class_weights_and_exact_colors():
    chunks = _chunks(seed=3)
    spec = twire.WireSpec(64, "f32")
    packed = _t(twire.pack_chunks(chunks, spec))
    cw = np.linspace(0, 2, 21).astype(np.float32)
    got = twire.unpack_batch(packed, spec, class_weights=cw)
    want = jwire.unpack_batch(jnp.asarray(packed.numpy()), jwire.WireSpec(*spec),
                              class_weights=cw)
    np.testing.assert_array_equal(got["weights"].numpy(), np.asarray(want["weights"]))
    # The decoded colors equal the host's f32 features exactly.
    host = tpipeline.make_batch(chunks, True, True, "f32")
    np.testing.assert_array_equal(got["features"][..., :3].numpy(), host["features"][..., :3])
    np.testing.assert_array_equal(got["points"].numpy(), host["points"])


@pytest.mark.parametrize("fmt", ["packed", "packed_q16", "packed_q16x4", "packedx3"])
def test_batched_and_expand_match_jax(fmt):
    chunks = _chunks(b=5, n=64, seed=9)
    got = list(tpipeline.batched(iter(chunks), 2, True, True, wire=fmt, pad_final=True))
    want = list(jpipeline.batched(iter(chunks), 2, True, True, wire=fmt, pad_final=True))
    assert len(got) == len(want) == 3
    spec, k = twire.WireSpec.from_format(fmt, 64, True, True)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == (["packed"] if k == 1
                                          else [f"packed{i}" for i in range(k)])
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])
        tg = tsteps.expand_wire_batch({key: _t(v) for key, v in g.items()}, spec)
        jw = jsteps.expand_wire_batch({key: jnp.asarray(v) for key, v in g.items()},
                                      jwire.WireSpec(*spec))
        whole = tsteps.expand_wire_batch(
            {"packed": _t(np.concatenate([g[key] for key in sorted(
                g, key=lambda s: int(s[6:] or 0))], axis=1))}, spec)
        for key in jw:
            np.testing.assert_array_equal(tg[key].numpy(), whole[key].numpy(), err_msg=key)
            if spec.layout == "q16" and key == "points":
                np.testing.assert_array_max_ulp(tg[key].numpy(), np.asarray(jw[key]), 1)
            else:
                np.testing.assert_array_equal(tg[key].numpy(), np.asarray(jw[key]), err_msg=key)
    # The keys of a split batch join in numeric order, not string order.
    split = twire.split_wire_batch({"packed": np.arange(2 * 60, dtype=np.uint8).reshape(2, 60)},
                                   12)
    keys = sorted(split, key=lambda s: int(s[6:] or 0))
    assert keys[-1] == "packed11"
    np.testing.assert_array_equal(np.concatenate([split[key] for key in keys], 1),
                                  np.arange(120, dtype=np.uint8).reshape(2, 60))


def test_packed_predict_equals_f32_predict_on_the_same_values():
    chunks = _chunks(b=2, n=256, seed=4)
    model = tmodels.get_model("sem_seg_features", device="cpu",
                              generator=torch.Generator().manual_seed(0), **TINY)
    spec = twire.WireSpec(256, "f32")
    packed = twire.pack_chunks(chunks, spec)
    got = tsteps.seg_predict_step_packed(model, packed, wire_spec=spec)
    # The f32 record carries normals as f16: feed the f32 path those values.
    for c in chunks:
        c["normals"] = c["normals"].astype(np.float16).astype(np.float32)
    host = tpipeline.make_batch(chunks, True, True, "f32")
    want = tsteps.seg_predict_step(model, _t(host["points"]), _t(host["features"]))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_prefetch_reraises_and_stops_on_close():
    def failing():
        yield 1
        raise KeyError("producer failed")

    it = tpipeline.prefetch(failing(), depth=2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer failed"):
        next(it)

    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    before = threading.active_count()
    it = tpipeline.prefetch(endless(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n
    assert list(tpipeline.prefetch(iter(range(5)))) == list(range(5))
