"""Headless visualization: colored PLY export of predictions (the port's own
copy of the JAX package's ``viz/ply_export.py``; the same files byte for
byte).

Replaces the reference's interactive pptk viewer
(``visualization/qualitative_animations.py``) with a headless artifact: a
binary PLY of the scene colored by predicted (or GT) label, viewable in
MeshLab/CloudCompare.  Ref for PLY writing:
``pointnet2_tensorflow/utils/pc_util.py:292-315``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from pointcloud_segmentation_attention_tpu_torch.viz.palette import colorize_labels


def write_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """Write points (N,3) f32 [+ colors (N,3) u8] as binary little-endian PLY."""
    points = np.asarray(points, np.float32)
    n = len(points)
    has_color = colors is not None
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        colors = np.asarray(colors, np.uint8)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = points
            rec["rgb"] = colors
        else:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3)])
            rec["xyz"] = points
        f.write(rec.tobytes())


def read_ply(path: str):
    """Minimal binary/ascii PLY vertex reader (xyz [+rgb])."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(h.split()[-1] for h in header if h.startswith("element vertex")))
        props = [h.split()[-1] for h in header if h.startswith("property")]
        has_color = "red" in props
        binary = any("binary_little_endian" in h for h in header)
        if binary:
            if has_color:
                rec = np.frombuffer(
                    f.read(n * (12 + 3)),
                    dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)], count=n,
                )
                return rec["xyz"].copy(), rec["rgb"].copy()
            rec = np.frombuffer(f.read(n * 12), dtype=[("xyz", np.float32, 3)], count=n)
            return rec["xyz"].copy(), None
        rows = [f.readline().split() for _ in range(n)]
        arr = np.array(rows, np.float64)
        xyz = arr[:, :3].astype(np.float32)
        rgb = arr[:, 3:6].astype(np.uint8) if has_color and arr.shape[1] >= 6 else None
        return xyz, rgb


def export_labeled_scene(path: str, points: np.ndarray, labels: np.ndarray) -> None:
    """Scene colored by label palette -> PLY."""
    write_ply(path, points, colorize_labels(labels))
