"""Whole-scene prediction, the benchmark export and the evaluator of the
port against the JAX package's.

One set of weights (a port train state, saved and restored by the JAX
package) predicts the val scenes of a small store through the port's
``generate_predictions`` on the CPU and through the JAX package's, with
``make_sharded_predict_fn``.  Labels must agree on >= 99.9 % of vertices
(logits differ by matmul summation order, so a near-tie may flip).  With
the f32 packed spec the port's labels must equal, vertex for vertex, its
f32 path fed the values the record carries (normals rounded to f16).  The
exported txt files, ``evaluate``'s dict and its results file must equal
the JAX package's on the same label arrays.
"""
import json
import os

import numpy as np
import pytest
import torch

from pointcloud_segmentation_attention_tpu.data.scannet import scenes as jscenes
from pointcloud_segmentation_attention_tpu.eval import benchmark as jbench
from pointcloud_segmentation_attention_tpu.eval import full_scene as jfull
from pointcloud_segmentation_attention_tpu.train import checkpoints as jckpt
from pointcloud_segmentation_attention_tpu.train import trainer as jtrainer
from pointcloud_segmentation_attention_tpu.utils.config import TrainConfig as JConfig
from pointcloud_segmentation_attention_tpu_torch.data import wire as twire
from pointcloud_segmentation_attention_tpu_torch.data.scannet import precompute as tpre
from pointcloud_segmentation_attention_tpu_torch.data.scannet.label_map import map_to_nyu40
from pointcloud_segmentation_attention_tpu_torch.eval import benchmark as tbench
from pointcloud_segmentation_attention_tpu_torch.eval import full_scene as tfull
from pointcloud_segmentation_attention_tpu_torch.train import checkpoints as tckpt
from pointcloud_segmentation_attention_tpu_torch.train import trainer as ttrainer
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig
from test_torch_trainer import TINY_HIERARCHY

NPOINTS, BATCH = 512, 4
CONFIG = dict(model="sem_seg_features", model_overrides=TINY_HIERARCHY, n_points=NPOINTS)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Predictions of both packages over two val scenes from one state."""
    d = tmp_path_factory.mktemp("predict")
    root = str(d / "scannet")
    splits = jscenes.write_synthetic_dataset(root, n_train=1, n_val=2, n_points=4000, seed=2)
    state = ttrainer.make_eval_state(TrainConfig(**CONFIG), device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # non-trivial BN statistics, so eval-mode BN is not the identity
        for name, buf in state.model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) * 0.4 + 0.8 if name.endswith("var")
                      else torch.randn(buf.shape, generator=g) * 0.1)
    path = tckpt.save_checkpoint(str(d / "ckpt"), state, 0)
    jstate = jckpt.restore_checkpoint(path, jtrainer.make_eval_state(JConfig(**CONFIG)))
    jpredict, _ = jfull.make_sharded_predict_fn(jstate, n_devices=1, return_labels=True)
    names = splits["val"]
    out = dict(root=root, names=names, model=state.model, dir=d)
    out["jax"] = list(jfull.generate_predictions(jpredict, root, names, str(d / "jax"),
                                                 batch_size=BATCH, npoints=NPOINTS))
    out["port"] = list(tfull.generate_predictions(
        tfull.make_predict_fn(state.model, device="cpu"), root, names, str(d / "port"),
        batch_size=BATCH, npoints=NPOINTS))
    return out


def test_generate_predictions_agrees_with_jax(served):
    d = served["dir"]
    assert [r["scene_name"] for r in served["port"]] == served["names"]
    for got, want in zip(served["port"], served["jax"]):
        name = got["scene_name"]
        assert got["predictions"].shape == want["predictions"].shape
        assert got["predictions"].dtype == want["predictions"].dtype == np.int32
        agree = float((got["predictions"] == want["predictions"]).mean())
        print(f"{name}: labels agree with JAX on {agree:.5%}")
        assert agree >= 0.999
        np.testing.assert_array_equal(got["labels"], want["labels"])
        for suffix in ("_points.npy", "_gt.npy"):
            a, b = (np.load(os.path.join(d, tag, name + suffix)) for tag in ("port", "jax"))
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.load(os.path.join(d, "port", name + "_labels.npy")),
                                      got["predictions"])
        txt = tbench.load_ids(os.path.join(d, "port", name + ".txt"))
        np.testing.assert_array_equal(txt, tbench.map_to_nyu40_for_benchmark(got["predictions"]))


def test_packed_f32_labels_equal_the_f32_path(served):
    model, root, names = served["model"], served["root"], served["names"]
    spec = twire.WireSpec(NPOINTS, "f32")
    packed = list(tfull.generate_predictions(
        tfull.make_predict_fn(model, device="cpu", wire_spec=spec), root, names,
        str(served["dir"] / "packed"), batch_size=BATCH, npoints=NPOINTS, save_npy=False,
        wire_spec=spec))
    predict = tfull.make_predict_fn(model, device="cpu")
    for scene, got, plain in zip(tpre.eval_scene_stream(root, names, npoints=NPOINTS),
                                 packed, served["port"]):
        scene["normals"] = scene["normals"].astype(np.float16).astype(np.float32)
        want = tfull.predict_scene_chunks(predict, scene, True, True, BATCH)
        np.testing.assert_array_equal(got["predictions"], want)
        assert float((got["predictions"] == plain["predictions"]).mean()) >= 0.999
    q16 = twire.WireSpec(NPOINTS, "q16")
    quant = list(tfull.generate_predictions(
        tfull.make_predict_fn(model, device="cpu", wire_spec=q16), root, names[:1],
        str(served["dir"] / "q16"), batch_size=BATCH, npoints=NPOINTS, wire_spec=q16))
    assert quant[0]["predictions"].shape == served["port"][0]["predictions"].shape


def test_export_and_evaluate_equal_jax(served, tmp_path):
    pred_files = {"port": [], "jax": []}
    gt_files = {"port": [], "jax": []}
    for tag, bench in (("port", tbench), ("jax", jbench)):
        for r in served["jax"]:
            p = str(tmp_path / f"{tag}_{r['scene_name']}.txt")
            g = str(tmp_path / f"{tag}_{r['scene_name']}_gt.txt")
            bench.export_benchmark_txt(p, r["predictions"])
            bench.export_ids(g, map_to_nyu40(r["labels"]))
            pred_files[tag].append(p)
            gt_files[tag].append(g)
    for a, b in zip(pred_files["port"] + gt_files["port"], pred_files["jax"] + gt_files["jax"]):
        assert open(a).read() == open(b).read()
    got = tbench.evaluate(pred_files["port"], gt_files["port"], str(tmp_path / "port.txt"))
    want = jbench.evaluate(pred_files["jax"], gt_files["jax"], str(tmp_path / "jax.txt"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert (np.isnan(got[k]) and np.isnan(want[k])) or got[k] == want[k], k
    assert open(tmp_path / "port.txt").read() == open(tmp_path / "jax.txt").read()
    # The benchmark mIoU is the mean IoU over the NYU40 ids present, from the
    # in-memory labels.
    conf = np.zeros((41, 41), np.int64)
    for r in served["jax"]:
        gt = map_to_nyu40(r["labels"])
        pred = tbench.map_to_nyu40_for_benchmark(r["predictions"])
        keep = np.isin(gt, tbench.VALID_CLASS_IDS)
        np.add.at(conf, (gt[keep], pred[keep]), 1)
    ious = []
    for c in tbench.VALID_CLASS_IDS:
        tp = conf[c, c]
        denom = conf[c].sum() + conf[tbench.VALID_CLASS_IDS, c].sum() - tp
        if denom:
            ious.append(tp / denom)
    assert got["mean_iou"] == pytest.approx(float(np.mean(ious)), rel=1e-12)
    short = str(tmp_path / "short_gt.txt")
    tbench.export_ids(short, np.ones(7, np.int64))
    with pytest.raises(ValueError, match="prediction count"):
        tbench.evaluate(pred_files["port"][:1], [short])


def test_groundtruth_export_equals_jax(tmp_path):
    tsv = tmp_path / "labels.tsv"
    tsv.write_text("id\traw_category\tnyu40id\n1\tchair\t5\n2\ttable\t7\n3\tlamp\t\n")
    agg = {"segGroups": [{"label": "chair", "segments": [0, 2]},
                         {"label": "table", "segments": [1]},
                         {"label": "lamp", "segments": [3]}]}
    seg = {"segIndices": [0, 0, 1, 2, 3, 3, 4]}
    (tmp_path / "agg.json").write_text(json.dumps(agg))
    (tmp_path / "seg.json").write_text(json.dumps(seg))
    mapping = tbench.read_label_mapping_tsv(str(tsv))
    assert mapping == jbench.read_label_mapping_tsv(str(tsv)) == {"chair": 5, "table": 7}
    got = tbench.export_groundtruth_from_json(str(tmp_path / "agg.json"),
                                              str(tmp_path / "seg.json"), mapping,
                                              str(tmp_path / "port.txt"))
    want = jbench.export_groundtruth_from_json(str(tmp_path / "agg.json"),
                                               str(tmp_path / "seg.json"), mapping,
                                               str(tmp_path / "jax.txt"))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    np.testing.assert_array_equal(tbench.map_to_nyu40_for_benchmark(np.arange(21)),
                                  jbench.map_to_nyu40_for_benchmark(np.arange(21)))
