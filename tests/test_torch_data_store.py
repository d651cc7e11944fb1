"""The port's ScanNet store, precompute, pack store and replay against the
JAX package's: the same seeds and inputs must give identical files and
sequences.

- scene npy files and split lists: byte-identical files;
- precomputed npz chunks: every array equal in dtype, shape and bytes (an
  npz archive holds file times, so the archives themselves differ);
- pack stores: byte-identical ``epoch-*.pack`` files and ``meta.json``;
- replay streams, pack replay and ``batched(pad_final=True)``: the same
  items in the same order.
"""
import filecmp
import os

import numpy as np
import pytest

from pointcloud_segmentation_attention_tpu.data import pipeline as jpipeline
from pointcloud_segmentation_attention_tpu.data import wire as jwire
from pointcloud_segmentation_attention_tpu.data.scannet import chunks as jchunks
from pointcloud_segmentation_attention_tpu.data.scannet import label_map as jlabels
from pointcloud_segmentation_attention_tpu.data.scannet import packstore as jpack
from pointcloud_segmentation_attention_tpu.data.scannet import precompute as jpre
from pointcloud_segmentation_attention_tpu.data.scannet import precompute_cli as jcli
from pointcloud_segmentation_attention_tpu.data.scannet import scenes as jscenes
from pointcloud_segmentation_attention_tpu_torch.data import pipeline as tpipeline
from pointcloud_segmentation_attention_tpu_torch.data import wire as twire
from pointcloud_segmentation_attention_tpu_torch.data.scannet import chunks as tchunks
from pointcloud_segmentation_attention_tpu_torch.data.scannet import label_map as tlabels
from pointcloud_segmentation_attention_tpu_torch.data.scannet import packstore as tpack
from pointcloud_segmentation_attention_tpu_torch.data.scannet import precompute as tpre
from pointcloud_segmentation_attention_tpu_torch.data.scannet import precompute_cli as tcli
from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as tscenes


def _same_tree(a: str, b: str) -> list:
    """Relative paths of every file under ``a``; asserts ``b`` holds the same
    files with the same bytes."""
    files = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f
    return files


def _assert_npz_equal(a: str, b: str) -> None:
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k
            assert za[k].tobytes() == zb[k].tobytes(), k


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same small dataset written and precomputed by both packages."""
    d = tmp_path_factory.mktemp("store")
    out = {}
    for tag, scenes_lib, pre in (("jax", jscenes, jpre), ("port", tscenes, tpre)):
        root = str(d / tag / "scannet")
        splits = scenes_lib.write_synthetic_dataset(root, n_train=3, n_val=2, n_test=1,
                                                    n_points=2500, seed=5)
        chunks = str(d / tag / "chunks")
        n_train = pre.precompute_train_chunks(root, splits["train"], chunks, epochs=2,
                                              npoints=256, seed=1)
        n_val = pre.precompute_val_chunks(root, splits["val"], chunks, npoints=256)
        out[tag] = dict(root=root, splits=splits, chunks=chunks, counts=(n_train, n_val))
    return out


@pytest.mark.parametrize("coded", [dict(), dict(color_coded=True),
                                   dict(geometry_coded=True)])
def test_synthetic_dataset_files_identical(tmp_path, coded):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    sa = jscenes.write_synthetic_dataset(a, n_train=2, n_val=1, n_test=1, n_points=1500,
                                         seed=3, **coded)
    sb = tscenes.write_synthetic_dataset(b, n_train=2, n_val=1, n_test=1, n_points=1500,
                                         seed=3, **coded)
    assert sa == sb
    files = _same_tree(a, b)
    assert len(files) == 4 * 4 + 3  # four arrays of four scenes, three split lists
    for split in ("train", "val", "test"):
        assert tscenes.read_split(os.path.join(b, "splits"), split) == sa[split]
    name = sa["train"][0]
    _assert_items_equal(tscenes.load_scene_mapped(b, name), jscenes.load_scene_mapped(a, name))
    _assert_items_equal(tscenes.make_synthetic_scene(900, seed=8, **coded),
                        jscenes.make_synthetic_scene(900, seed=8, **coded))


def test_official_splits_equal_jax():
    for split, count in (("train", 1201), ("val", 312), ("test", 100)):
        names = tscenes.read_split(None, split)
        assert names == jscenes.read_split(None, split) and len(names) == count
    assert tscenes.official_splits_dir() != jscenes.official_splits_dir()
    _same_tree(jscenes.official_splits_dir(), tscenes.official_splits_dir())
    assert tscenes.read_split(tscenes.official_splits_dir(), "val")[:2] == \
        jscenes.read_split(jscenes.official_splits_dir(), "val")[:2]


def test_label_maps_equal_jax():
    assert tlabels.LABEL_MAP == jlabels.LABEL_MAP
    assert tlabels.INVERSE_LABEL_MAP == jlabels.INVERSE_LABEL_MAP
    assert tlabels.VALID_CLASS_IDS_NYU40 == jlabels.VALID_CLASS_IDS_NYU40
    ids = np.arange(-3, 60)
    np.testing.assert_array_equal(tlabels.map_labels(ids), jlabels.map_labels(ids))
    assert tlabels.map_labels(ids).dtype == jlabels.map_labels(ids).dtype
    compact = np.arange(21)
    np.testing.assert_array_equal(tlabels.map_to_nyu40(compact), jlabels.map_to_nyu40(compact))
    np.testing.assert_array_equal(tlabels.TRAIN_LABEL_WEIGHTS, jlabels.TRAIN_LABEL_WEIGHTS)


def test_eval_chunker_and_rotation_equal_jax():
    scene = jscenes.make_synthetic_scene(3000, seed=4)
    args = (scene["points"], scene["labels"], scene["colors"], scene["normals"], 512)
    _assert_items_equal(tchunks.grid_chunks_for_eval(*args, rng=np.random.RandomState(2)),
                        jchunks.grid_chunks_for_eval(*args, rng=np.random.RandomState(2)))
    _assert_items_equal(tchunks.grid_chunks_for_eval(*args), jchunks.grid_chunks_for_eval(*args))
    for normals in (scene["normals"], None):
        got = tchunks.random_z_rotation(scene["points"], normals, np.random.RandomState(9))
        want = jchunks.random_z_rotation(scene["points"], normals, np.random.RandomState(9))
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_precompute_files_equal_jax(stores):
    j, t = stores["jax"], stores["port"]
    assert j["counts"] == t["counts"]
    assert sorted(os.listdir(j["chunks"])) == sorted(os.listdir(t["chunks"]))
    assert len(os.listdir(t["chunks"])) == 3 * 2 + 2
    for name in os.listdir(j["chunks"]):
        _assert_npz_equal(os.path.join(j["chunks"], name), os.path.join(t["chunks"], name))
    with pytest.raises(FileExistsError, match="start_epoch"):
        tpre.precompute_train_chunks(t["root"], t["splits"]["train"], t["chunks"], epochs=1,
                                     npoints=256, seed=1)


def test_precompute_cli_shards_like_one_host(stores, tmp_path):
    j, t = stores["jax"], stores["port"]
    for h in range(2):
        argv = ["--data_root", t["root"], "--out_dir", str(tmp_path / "port"), "--epochs",
                "1", "--npoints", "256", "--seed", "1", "--num_hosts", "2", "--host_id",
                str(h)]
        tcli.main(argv)
        jcli.main(argv[:3] + [str(tmp_path / "jax")] + argv[4:])
    tcli.main(["--data_root", t["root"], "--out_dir", str(tmp_path / "port"), "--split",
               "val", "--npoints", "256"])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) + [f"val-{n}.npz"
                                                              for n in t["splits"]["val"]]
    for name in names:
        # Host-sharded chunks are the one-host chunks (seeded by scene name).
        _assert_npz_equal(str(tmp_path / "port" / name), os.path.join(t["chunks"], name))


def test_replay_streams_equal_jax(stores):
    j, t = stores["jax"], stores["port"]
    names = t["splits"]["train"]
    got = tpre.replay_train_chunks(t["chunks"], 2, names, shuffle_seed=4)
    want = jpre.replay_train_chunks(j["chunks"], 2, names, shuffle_seed=4)
    for _ in range(3 * 2 * 2 + 1):  # two passes and one item more
        _assert_items_equal(next(got), next(want))
    val_got = list(tpre.replay_val_chunks(t["chunks"], t["splits"]["val"]))
    val_want = list(jpre.replay_val_chunks(j["chunks"], j["splits"]["val"]))
    assert len(val_got) == len(val_want) == t["counts"][1]
    for g, w in zip(val_got, val_want):
        _assert_items_equal(g, w)
    for wire in ("f32", "compact", "packed_q16"):
        bg = list(tpipeline.batched(iter(val_got), 3, True, True, pad_final=True, wire=wire))
        bw = list(jpipeline.batched(iter(val_want), 3, True, True, pad_final=True, wire=wire))
        assert len(bg) == len(bw) == -(-len(val_got) // 3)
        for g, w in zip(bg, bw):
            _assert_items_equal(g, w)
    streams = [list(pre.eval_scene_stream(s["root"], s["splits"]["val"], npoints=256,
                                          with_labels=wl))
               for wl in (True, False) for pre, s in ((tpre, t), (jpre, j))]
    for got_items, want_items in (streams[:2], streams[2:]):
        for g, w in zip(got_items, want_items):
            _assert_items_equal(g, w)


@pytest.mark.parametrize("layout", ["q16", "f32"])
def test_pack_store_equal_jax(stores, tmp_path, layout):
    j, t = stores["jax"], stores["port"]
    names = t["splits"]["train"]
    tspec = twire.WireSpec(256, layout, True, True)
    jspec = jwire.WireSpec(256, layout, True, True)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tpack.write_pack_from_npz(t["chunks"], tdir, 1, names, tspec) == 3
    assert jpack.write_pack_from_npz(j["chunks"], jdir, 1, names, jspec) == 3
    # Growing the store adds an epoch; asking for fewer never shrinks it.
    assert tpack.write_pack_from_npz(t["chunks"], tdir, 2, names, tspec) == 3
    assert jpack.write_pack_from_npz(j["chunks"], jdir, 2, names, jspec) == 3
    assert tpack.write_pack_from_npz(t["chunks"], tdir, 1, names, tspec) == 0
    assert jpack.write_pack_from_npz(j["chunks"], jdir, 1, names, jspec) == 0
    assert _same_tree(jdir, tdir) == ["epoch-0000.pack", "epoch-0001.pack", "meta.json"]
    with pytest.raises(ValueError, match="scenes"):
        tpack.write_pack_from_npz(t["chunks"], tdir, 1, names[:2], tspec)
    with pytest.raises(ValueError, match="layout"):
        tpack.write_pack_from_npz(t["chunks"], tdir, 1, names,
                                  tspec._replace(layout="f32" if layout == "q16" else "q16"))

    reader = tpack.PackReader(tdir)
    assert reader.spec == tspec and reader.epochs == 2 and reader.scenes == names
    got = reader.replay_batches(2, shuffle_seed=7)
    want = jpack.PackReader(jdir).replay_batches(2, shuffle_seed=7)
    # Same order as the chunk replay it stands for: 3 rows an epoch carry over.
    chunks = tpre.replay_train_chunks(t["chunks"], 2, names, shuffle_seed=7)
    for _ in range(7):
        g, w = next(got), next(want)
        _assert_items_equal(g, w)
        np.testing.assert_array_equal(
            g["packed"], twire.pack_chunks([next(chunks), next(chunks)], tspec))
