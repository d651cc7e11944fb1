"""Real-data readiness drill: the COMPLETE raw-ScanNet path on a fabricated
scan, one command (the port's own copy of the JAX package's
``recipes/realdata_drill.py``; the same fabricated files byte for byte).

Real ScanNet cannot ship with the repository (its terms of service), so this
drill keeps the day-1-on-real-data path turnkey by exercising every stage
against a synthetic scan in the official raw layout:

  1. fabricate ``{scan}/{scene}_vh_clean_2.ply`` (binary PLY with faces),
     ``..._vh_clean_2.0.010000.segs.json``, ``{scene}.aggregation.json``,
     and a ``scannetv2-labels.combined.tsv``
  2. ``preprocessing.collect_scannet_scene`` — segs+aggregation+tsv -> NYU40
     vertex labels -> scene-store npy (ref collect_scannet_scenes.py:21-102)
  3. the precompute CLI (train + val chunks)
  4. one training epoch through ``train.trainer`` (checkpoint + val) on
     ``device``
  5. full-scene stitched prediction on ``device`` + benchmark txt export
     (ref generate_predictions.py:94-186)
  6. ``eval.benchmark.export_groundtruth_from_json`` (ref
     generate_groundtruth.py:117-136)
  7. ``eval.benchmark.evaluate`` over the txt files — and the calibration
     check: a PERFECT predictor (ground-truth labels round-tripped through
     the 21-class <-> NYU40 maps) must score mean IoU 1.0.

Run: ``python -m pointcloud_segmentation_attention_tpu_torch.recipes.realdata_drill
[--device cuda|cpu]`` (the card unless ``--device cpu``).
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, List

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.data.scannet import (
    precompute_cli,
    preprocessing,
    scenes,
)
from pointcloud_segmentation_attention_tpu_torch.eval import benchmark, full_scene
from pointcloud_segmentation_attention_tpu_torch.train import trainer
from pointcloud_segmentation_attention_tpu_torch.train.checkpoints import (
    best_checkpoint,
    latest_checkpoint,
    restore_checkpoint,
)
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig

# Raw category name -> NYU40 id for the fabricated scan (subset of the real
# combined-labels tsv; all ids are in the benchmark's VALID_CLASS_IDS).
DRILL_CATEGORIES = {"wall": 1, "floor": 2, "bed": 4, "chair": 5}


def _surface_grid(origin, u_vec, v_vec, nu, nv):
    """Rectangular vertex grid + two-triangle-per-cell faces."""
    us = np.linspace(0, 1, nu)
    vs = np.linspace(0, 1, nv)
    pts = (np.asarray(origin)[None, None]
           + us[:, None, None] * np.asarray(u_vec)[None, None]
           + vs[None, :, None] * np.asarray(v_vec)[None, None])
    pts = pts.reshape(-1, 3)
    faces = []
    for i in range(nu - 1):
        for j in range(nv - 1):
            a = i * nv + j
            b = a + 1
            c = a + nv
            d = c + 1
            faces.append((a, b, c))
            faces.append((b, d, c))
    return pts.astype(np.float32), np.asarray(faces, np.int64)


def build_fake_room(n_grid: int = 24, seed: int = 0):
    """A room of labelled surfaces: floor, one wall, a bed box top, a chair
    seat.  Returns (points, colors, faces, surface_id per vertex,
    surface_names)."""
    rng = np.random.RandomState(seed)
    surfaces = [
        ("floor", (0, 0, 0), (4, 0, 0), (0, 4, 0)),
        ("wall", (0, 0, 0), (4, 0, 0), (0, 0, 2.5)),
        ("bed", (0.5, 2.2, 0.5), (1.6, 0, 0), (0, 1.2, 0)),
        ("chair", (3.0, 0.8, 0.45), (0.5, 0, 0), (0, 0.5, 0)),
    ]
    pts_all: List[np.ndarray] = []
    faces_all: List[np.ndarray] = []
    sid_all: List[np.ndarray] = []
    names = []
    offset = 0
    for sid, (name, origin, u, v) in enumerate(surfaces):
        nu = n_grid if name in ("floor", "wall") else max(4, n_grid // 3)
        pts, faces = _surface_grid(origin, u, v, nu, nu)
        pts = pts + rng.normal(0, 0.003, pts.shape).astype(np.float32)
        pts_all.append(pts)
        faces_all.append(faces + offset)
        sid_all.append(np.full(len(pts), sid, np.int64))
        names.append(name)
        offset += len(pts)
    points = np.concatenate(pts_all)
    faces = np.concatenate(faces_all)
    sids = np.concatenate(sid_all)
    palette = np.array([[200, 190, 180], [180, 180, 200],
                        [90, 60, 160], [160, 90, 40]], np.uint8)
    colors = palette[sids]
    return points, colors, faces, sids, names


def write_binary_ply(path: str, points, colors, faces) -> None:
    """Official-layout binary_little_endian PLY: x/y/z f32 + rgb uchar
    vertices, uchar-count int32-index triangle faces (the format
    ``preprocessing.read_ply_mesh`` must parse on real scans)."""
    n, f = len(points), len(faces)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        f"element face {f}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                    ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    verts = np.empty(n, vdt)
    verts["x"], verts["y"], verts["z"] = points.T.astype(np.float32)
    verts["red"], verts["green"], verts["blue"] = colors.T.astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(verts.tobytes())
        for tri in faces:
            fh.write(struct.pack("<B3i", 3, *[int(t) for t in tri]))


def fabricate_raw_scan(scan_dir: str, scene_name: str, n_grid: int = 24,
                       segs_per_surface: int = 3, seed: int = 0) -> Dict:
    """Write the full official raw layout; returns ground-truth info."""
    os.makedirs(scan_dir, exist_ok=True)
    points, colors, faces, sids, names = build_fake_room(n_grid, seed)
    write_binary_ply(
        os.path.join(scan_dir, f"{scene_name}_vh_clean_2.ply"),
        points, colors, faces,
    )
    # Over-segmentation: split each surface into segs_per_surface segments
    # along x (like the real 0.010000 segmentation, just coarser).
    seg_indices = np.zeros(len(points), np.int64)
    seg_groups = []
    next_seg = 0
    for sid, name in enumerate(names):
        on = np.where(sids == sid)[0]
        order = np.argsort(points[on, 0], kind="stable")
        parts = np.array_split(on[order], segs_per_surface)
        segs = []
        for part in parts:
            seg_indices[part] = next_seg
            segs.append(next_seg)
            next_seg += 1
        seg_groups.append({
            "id": sid, "objectId": sid, "label": name, "segments": segs,
        })
    with open(os.path.join(
            scan_dir, f"{scene_name}_vh_clean_2.0.010000.segs.json"), "w") as f:
        json.dump({"segIndices": [int(s) for s in seg_indices]}, f)
    with open(os.path.join(scan_dir, f"{scene_name}.aggregation.json"), "w") as f:
        json.dump({"segGroups": seg_groups}, f)
    tsv = os.path.join(scan_dir, "scannetv2-labels.combined.tsv")
    with open(tsv, "w") as f:
        f.write("id\traw_category\tcategory\tnyu40id\n")
        for i, (name, nyu) in enumerate(DRILL_CATEGORIES.items()):
            f.write(f"{i}\t{name}\t{name}\t{nyu}\n")
    gt_nyu40 = np.array([DRILL_CATEGORIES[names[s]] for s in sids], np.int64)
    return {"tsv": tsv, "gt_nyu40": gt_nyu40, "n_vertices": len(points)}


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def run_drill(workdir: str, n_grid: int = 24, npoints: int = 512,
              batch_size: int = 2, precompute_epochs: int = 2,
              seed: int = 0, device="cuda") -> Dict:
    """The full pipeline, training and predicting on ``device`` (no
    fallback: 'cuda' without a card raises); returns {model_miou,
    perfect_miou, ...}."""
    scene_name = "scene9999_00"
    scan_dir = os.path.join(workdir, "scans", scene_name)
    data_root = os.path.join(workdir, "scannet")
    info = fabricate_raw_scan(scan_dir, scene_name, n_grid=n_grid, seed=seed)

    # 2. raw scan -> scene store (segs + aggregation + tsv).
    labels = preprocessing.collect_scannet_scene(
        scan_dir, scene_name, data_root, label_map_tsv=info["tsv"])
    _check((labels == info["gt_nyu40"]).all(), "label resolution drifted")
    scenes.write_split(os.path.join(data_root, "splits"), "train", [scene_name])
    scenes.write_split(os.path.join(data_root, "splits"), "val", [scene_name])

    # 3. precompute CLI (the real batch job, both splits).
    chunk_dir = os.path.join(workdir, "chunks")
    precompute_cli.main([
        "--data_root", data_root, "--out_dir", chunk_dir,
        "--epochs", str(precompute_epochs), "--npoints", str(npoints),
        "--seed", str(seed),
    ])
    precompute_cli.main([
        "--data_root", data_root, "--out_dir", chunk_dir, "--split", "val",
        "--npoints", str(npoints), "--seed", str(seed),
    ])

    # 4. one epoch of training (runs a val pass -> best checkpoint).
    cfg = TrainConfig(
        data_root=data_root, split_dir=os.path.join(data_root, "splits"),
        precompute_dir=chunk_dir, model="sem_seg_features",
        use_colors=True, use_normals=True, batch_size=1,
        n_points=npoints, epochs=1, n_epochs_to_val=1, save_every_epochs=1,
        log_dir=os.path.join(workdir, "logs"),
        ckpt_dir=os.path.join(workdir, "ckpt"), n_devices=1, seed=seed,
    )
    trainer.train(cfg, max_steps=1, device=device)

    # 5. full-scene stitched prediction + benchmark txt.  Restore the
    # periodic checkpoint (the best-val one may not exist after one step:
    # an untrained model's val mIoU can be NaN).
    state = trainer.make_eval_state(cfg, device=device)
    ckpt = latest_checkpoint(cfg.ckpt_dir) or best_checkpoint(cfg.ckpt_dir)
    _check(ckpt is not None, "training produced no checkpoint")
    state = restore_checkpoint(ckpt, state)
    predict_fn, _ = full_scene.make_sharded_predict_fn(state.model, n_devices=1,
                                                       return_labels=True, device=device)
    out_dir = os.path.join(workdir, "pred")
    results = list(full_scene.generate_predictions(
        predict_fn, data_root, [scene_name], out_dir,
        use_colors=True, use_normals=True, batch_size=batch_size,
        npoints=npoints,
    ))
    pred_txt = os.path.join(out_dir, f"{scene_name}.txt")
    _check(os.path.exists(pred_txt), f"no prediction file {pred_txt}")
    _check(len(results[0]["predictions"]) == info["n_vertices"],
           "not one stitched label per vertex")

    # 6. ground-truth export from the raw jsons.
    gt_dir = os.path.join(workdir, "gt")
    os.makedirs(gt_dir, exist_ok=True)
    gt_txt = os.path.join(gt_dir, f"{scene_name}.txt")
    mapping = benchmark.read_label_mapping_tsv(info["tsv"])
    gt_ids = benchmark.export_groundtruth_from_json(
        os.path.join(scan_dir, f"{scene_name}.aggregation.json"),
        os.path.join(scan_dir, f"{scene_name}_vh_clean_2.0.010000.segs.json"),
        mapping, gt_txt,
    )
    _check((gt_ids == info["gt_nyu40"]).all(), "exported ground truth drifted")

    # 7. offline evaluation — model score + the perfect-predictor calibration.
    model_scores = benchmark.evaluate(
        [pred_txt], [gt_txt],
        output_file=os.path.join(workdir, "results.txt"))
    perfect_txt = os.path.join(out_dir, f"{scene_name}_perfect.txt")
    scene = scenes.load_scene_mapped(data_root, scene_name)
    benchmark.export_benchmark_txt(perfect_txt, scene["labels"])
    perfect_scores = benchmark.evaluate([perfect_txt], [gt_txt])
    return {
        "model_miou": model_scores["mean_iou"],
        "perfect_miou": perfect_scores["mean_iou"],
        "n_vertices": info["n_vertices"],
        "results_file": os.path.join(workdir, "results.txt"),
    }


def main(argv=None):
    import argparse
    import tempfile

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--workdir", default=None)
    p.add_argument("--npoints", type=int, default=2048)
    p.add_argument("--n_grid", type=int, default=48)
    args = p.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="psa_drill_")
    out = run_drill(workdir, n_grid=args.n_grid, npoints=args.npoints, device=args.device)
    print(json.dumps(out))
    _check(out["perfect_miou"] == 1.0, "perfect predictor must score 1.0")
    return out


if __name__ == "__main__":
    main()
