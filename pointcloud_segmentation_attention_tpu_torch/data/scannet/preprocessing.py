"""Offline PLY preprocessing: mesh reading, vertex normals, scene -> npy
(numpy only).  The port's own copy of the JAX package's
``data/scannet/preprocessing.py``: the same arrays and the same files.

Equivalent of ``attention_points/scannet_dataset/local_dataset_computations/``:
``ply_to_npy.py:12-149`` (PlyData -> points/colors/labels npy),
``normal_extraction.py`` + ``normal_computation_meshlab.py:9-22``
(angle-weighted vertex normals, Report.pdf Eq. 3 — computed here directly
instead of driving meshlabserver), and ``scannet_download_script.py``
(stubbed: ScanNet requires a signed ToS and a download this package does not
make).

The PLY reader is self-contained (ascii, binary little- and big-endian),
covering the two layouts ScanNet ships: ``*_vh_clean_2.ply`` (x y z
[nx ny nz] red green blue [alpha] + faces) and ``*_vh_clean_2.labels.ply``
(x y z label ...).  A binary face element whose every list holds three
indices (ScanNet's triangles) is read with one structured ``np.frombuffer``;
any other list element is read row by row, as the JAX package reads every
one.  Both give the JAX package's arrays.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.data.scannet import scenes as scenes_lib

_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _parse_header(f) -> Tuple[str, List[Tuple[str, int, list]]]:
    """Returns (fmt, [(element_name, count, [(prop_name, dtype | ('list', ct, it))])])."""
    line = f.readline().decode("ascii").strip()
    if line != "ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[Tuple[str, int, list]] = []
    while True:
        line = f.readline().decode("ascii").strip()
        if line == "end_header":
            break
        parts = line.split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], ("list", _PLY_DTYPES[parts[2]],
                                                   _PLY_DTYPES[parts[3]])))
            else:
                elements[-1][2].append((parts[2], _PLY_DTYPES[parts[1]]))
    return fmt, elements


def _read_ascii_element(f, count: int, props: list) -> Dict[str, np.ndarray]:
    cols: Dict[str, list] = {name: [] for name, _ in props}
    for _ in range(count):
        vals = f.readline().split()
        i = 0
        for name, spec in props:
            if isinstance(spec, tuple):  # list property
                k = int(vals[i]); i += 1
                cols[name].append([float(v) for v in vals[i:i + k]])
                i += k
            else:
                cols[name].append(float(vals[i])); i += 1
    return {k: np.asarray(v) for k, v in cols.items()}


def _read_triangles(f, count: int, props: list, order: str) -> Optional[Dict[str, np.ndarray]]:
    """The element read in one pass when every list in it holds 3 items
    (its count field as declared, then 3 items); None, with the file
    position restored, when one does not."""
    fields = []
    for name, spec in props:
        if isinstance(spec, tuple):
            _, count_t, item_t = spec
            fields += [(f"{name} count", order + count_t), (name, order + item_t, (3,))]
        else:
            fields.append((name, order + spec))
    dtype = np.dtype(fields)
    start = f.tell()
    buf = f.read(dtype.itemsize * count)
    if len(buf) == dtype.itemsize * count:
        arr = np.frombuffer(buf, dtype)
        if all((arr[f"{name} count"] == 3).all()
               for name, spec in props if isinstance(spec, tuple)):
            return {name: arr[name] for name, _ in props}
    f.seek(start)
    return None


def _read_binary_element(f, count: int, props: list, order: str) -> Dict[str, np.ndarray]:
    if any(isinstance(spec, tuple) for _, spec in props):
        if count:  # an empty element takes the row loop's (0,) arrays
            triangles = _read_triangles(f, count, props, order)
            if triangles is not None:
                return triangles
        # Per-row read: lists of any other length.
        cols: Dict[str, list] = {name: [] for name, _ in props}
        for _ in range(count):
            for name, spec in props:
                if isinstance(spec, tuple):
                    _, count_t, item_t = spec
                    k = int(np.frombuffer(f.read(np.dtype(count_t).itemsize),
                                          order + count_t)[0])
                    cols[name].append(np.frombuffer(
                        f.read(np.dtype(item_t).itemsize * k), order + item_t))
                else:
                    cols[name].append(np.frombuffer(
                        f.read(np.dtype(spec).itemsize), order + spec)[0])
        return {k: np.asarray(v) for k, v in cols.items()}
    dtype = np.dtype([(name, order + spec) for name, spec in props])
    arr = np.frombuffer(f.read(dtype.itemsize * count), dtype)
    return {name: arr[name] for name, _ in props}


def read_ply_mesh(path: str) -> Dict[str, Optional[np.ndarray]]:
    """Read a PLY mesh: returns dict with ``points`` (N,3) float32 and, when
    present, ``colors`` (N,3), ``normals`` (N,3), ``labels`` (N,), ``faces``
    (F,3) (ref ply_to_npy.py:12-64 used plyfile for the same fields)."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        order = {"ascii": "=", "binary_little_endian": "<",
                 "binary_big_endian": ">"}[fmt]
        data: Dict[str, Dict[str, np.ndarray]] = {}
        for name, count, props in elements:
            if fmt == "ascii":
                data[name] = _read_ascii_element(f, count, props)
            else:
                data[name] = _read_binary_element(f, count, props, order)

    v = data.get("vertex", {})
    out: Dict[str, Optional[np.ndarray]] = {
        "points": np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32),
        "colors": None, "normals": None, "labels": None, "faces": None,
    }
    if "red" in v:
        out["colors"] = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.int32)
    if "nx" in v:
        out["normals"] = np.stack([v["nx"], v["ny"], v["nz"]], 1).astype(np.float32)
    if "label" in v:
        out["labels"] = np.asarray(v["label"]).astype(np.int32)
    if "face" in data:
        faces = data["face"].get("vertex_indices", data["face"].get("vertex_index"))
        if isinstance(faces, np.ndarray) and faces.ndim == 2:  # (F, 3) in one array
            out["faces"] = faces.astype(np.int64)
        else:
            out["faces"] = np.asarray([list(fc) for fc in faces], np.int64)
    return out


def compute_vertex_normals(points: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Angle-weighted vertex normals (Report.pdf Eq. 3, the meshlab filter the
    reference drove via ``normal_computation_meshlab.py:9-22``): each incident
    face's unit normal contributes weighted by the corner angle at the vertex.
    Vertices with no faces get +z."""
    points = np.asarray(points, np.float64)
    faces = np.asarray(faces, np.int64)
    acc = np.zeros_like(points)
    p0, p1, p2 = points[faces[:, 0]], points[faces[:, 1]], points[faces[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    norm = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = fn / np.maximum(norm, 1e-20)

    def corner_angle(a, b, c):
        u, w = b - a, c - a
        cosang = (u * w).sum(1) / np.maximum(
            np.linalg.norm(u, axis=1) * np.linalg.norm(w, axis=1), 1e-20)
        return np.arccos(np.clip(cosang, -1.0, 1.0))

    angles = [corner_angle(p0, p1, p2), corner_angle(p1, p2, p0),
              corner_angle(p2, p0, p1)]
    for k in range(3):
        np.add.at(acc, faces[:, k], fn * angles[k][:, None])
    n = np.linalg.norm(acc, axis=1, keepdims=True)
    degenerate = (n < 1e-12).reshape(-1)
    acc[degenerate] = [0.0, 0.0, 1.0]
    n[degenerate] = 1.0
    return (acc / n).astype(np.float32)


def ply_scene_to_npy(
    mesh_path: str,
    data_root: str,
    scene_name: str,
    labels_path: Optional[str] = None,
) -> None:
    """One scene: mesh PLY (+ labels PLY) -> the four npy arrays of the scene
    store (ref ply_to_npy.py:67-149 wrote the same points/labels/colors layout;
    normals are computed here instead of a meshlab round trip).  Labels are
    stored raw (NYU40)."""
    mesh = read_ply_mesh(mesh_path)
    points = mesh["points"]
    colors = mesh["colors"]
    if colors is None:
        colors = np.zeros((len(points), 3), np.int32)
    normals = mesh["normals"]
    if normals is None:
        if mesh["faces"] is not None:
            normals = compute_vertex_normals(points, mesh["faces"])
        else:
            normals = np.tile(np.array([0, 0, 1], np.float32), (len(points), 1))
    labels = mesh["labels"]
    if labels is None and labels_path is not None:
        labels = read_ply_mesh(labels_path)["labels"]
    if labels is None:
        labels = np.zeros(len(points), np.int32)
    scenes_lib.save_scene(data_root, scene_name, {
        "points": points.astype(np.float32),
        "labels": labels.astype(np.int32),
        "colors": colors.astype(np.int32),
        "normals": normals.astype(np.float32),
    })


def convert_scans(scans_dir: str, data_root: str) -> List[str]:
    """Batch conversion over a ScanNet ``scans/`` directory
    (ref extract_ply_files.py:8-17 + ply_to_npy.py main loop).
    Returns the converted scene names."""
    converted = []
    for name in sorted(os.listdir(scans_dir)):
        mesh = os.path.join(scans_dir, name, f"{name}_vh_clean_2.ply")
        labels = os.path.join(scans_dir, name, f"{name}_vh_clean_2.labels.ply")
        if not os.path.exists(mesh):
            continue
        ply_scene_to_npy(mesh, data_root, name,
                         labels if os.path.exists(labels) else None)
        converted.append(name)
    return converted


def collect_scannet_scene(
    scan_dir: str,
    scene_name: str,
    data_root: str,
    raw_to_nyu40: Optional[Dict[str, int]] = None,
    label_map_tsv: Optional[str] = None,
) -> np.ndarray:
    """Raw ScanNet scan -> scene-store npy, labels resolved through
    segs.json + aggregation.json + the combined-labels tsv
    (ref ``pointnet2_tensorflow/scannet/preprocessing/collect_scannet_scenes.py
    :21-102`` and ``attention_points/benchmark/generate_groundtruth.py``).

    Expects the official per-scan layout::

        {scan_dir}/{scene}_vh_clean_2.ply
        {scan_dir}/{scene}_vh_clean_2.0.010000.segs.json
        {scan_dir}/{scene}.aggregation.json

    Returns the per-vertex NYU40 label array.  Either ``raw_to_nyu40`` (a
    mapping from raw category names) or ``label_map_tsv`` must be given.
    """
    from pointcloud_segmentation_attention_tpu_torch.eval.benchmark import (
        read_label_mapping_tsv,
    )

    if raw_to_nyu40 is None:
        if label_map_tsv is None:
            raise ValueError("need raw_to_nyu40 or label_map_tsv")
        raw_to_nyu40 = read_label_mapping_tsv(label_map_tsv)

    mesh = read_ply_mesh(os.path.join(scan_dir, f"{scene_name}_vh_clean_2.ply"))
    points = mesh["points"]

    import json
    with open(os.path.join(scan_dir,
                           f"{scene_name}_vh_clean_2.0.010000.segs.json")) as f:
        seg_indices = np.asarray(json.load(f)["segIndices"], np.int64)
    with open(os.path.join(scan_dir, f"{scene_name}.aggregation.json")) as f:
        agg = json.load(f)
    # segment id -> NYU40 id of its aggregated object (ref :55-77).
    seg_label: Dict[int, int] = {}
    for obj in agg["segGroups"]:
        nyu = raw_to_nyu40.get(obj["label"], 0)
        for s in obj["segments"]:
            seg_label[int(s)] = nyu
    labels = np.array([seg_label.get(int(s), 0) for s in seg_indices], np.int32)

    colors = mesh["colors"]
    if colors is None:
        colors = np.zeros((len(points), 3), np.int32)
    normals = mesh["normals"]
    if normals is None and mesh["faces"] is not None:
        normals = compute_vertex_normals(points, mesh["faces"])
    if normals is None:
        normals = np.tile(np.array([0, 0, 1], np.float32), (len(points), 1))
    scenes_lib.save_scene(data_root, scene_name, {
        "points": points.astype(np.float32),
        "labels": labels,
        "colors": colors.astype(np.int32),
        "normals": normals.astype(np.float32),
    })
    return labels


def download_scannet(*args, **kwargs):
    """ScanNet download requires a signed terms-of-service token and a
    network download (ref scannet_download_script.py:1-265); this package
    makes neither, and raises as the JAX package does."""
    raise RuntimeError(
        "ScanNet download is gated behind the ScanNet ToS; obtain the data "
        "with the official download script and run convert_scans() on it."
    )
