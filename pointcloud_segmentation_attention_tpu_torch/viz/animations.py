"""Headless qualitative animations (the port's own copy of the JAX package's
``viz/animations.py``; the same frames byte for byte).

Replaces the reference's pptk-based viewers
(``visualization/qualitative_animations.py`` — rotate scene around its
centroid, record frames; ``labels_during_training.py`` — replay predictions
from different train steps): renders rotating views of a labeled scene to PNG
frames with the compiled z-buffer splat renderer (``native.render_ball``),
ready for ``ffmpeg -i frame_%03d.png`` like the reference's docstring recipe.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np

from pointcloud_segmentation_attention_tpu_torch import native
from pointcloud_segmentation_attention_tpu_torch.viz.palette import colorize_labels


def _project(points: np.ndarray, angle: float, size: int, elevation: float = 0.6):
    """Rotate around the scene centroid's z-axis, tilt, orthographic project
    to screen coords (x,y pixels + depth)."""
    center = points.mean(axis=0)
    p = points - center
    c, s = np.cos(angle), np.sin(angle)
    rot_z = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    ce, se = np.cos(elevation), np.sin(elevation)
    rot_x = np.array([[1, 0, 0], [0, ce, -se], [0, se, ce]], np.float32)
    p = p @ rot_z.T @ rot_x.T
    scale = (size * 0.45) / max(np.abs(p[:, :2]).max(), 1e-6)
    screen = np.empty_like(p)
    screen[:, 0] = p[:, 0] * scale + size / 2
    screen[:, 1] = p[:, 1] * scale + size / 2
    screen[:, 2] = p[:, 2]
    return screen


def render_frame(
    points: np.ndarray, labels: np.ndarray, angle: float,
    size: int = 480, radius: int = 2,
) -> np.ndarray:
    """One rotating-view frame (H, W, 3) uint8, colored by label palette."""
    screen = _project(points.astype(np.float32), angle, size)
    colors = colorize_labels(labels)
    return native.render_ball(screen, colors, h=size, w=size, radius=radius)


def write_png(path: str, image: np.ndarray) -> None:
    """Minimal PNG writer (no deps): 8-bit RGB."""
    h, w, _ = image.shape
    raw = b"".join(
        b"\x00" + image[y].astype(np.uint8).tobytes() for y in range(h)
    )

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", header))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def rotation_animation(
    points: np.ndarray, labels: np.ndarray, out_dir: str,
    n_frames: int = 36, size: int = 480, max_points: Optional[int] = 100000,
    seed: int = 0,
) -> List[str]:
    """Write n_frames rotating views; returns the frame paths.
    ffmpeg recipe (from the reference's docstring):
    ``ffmpeg -framerate 12 -i frame_%03d.png -pix_fmt yuv420p out.mp4``."""
    os.makedirs(out_dir, exist_ok=True)
    if max_points and len(points) > max_points:
        sel = np.random.RandomState(seed).choice(len(points), max_points, False)
        points, labels = points[sel], labels[sel]
    paths = []
    for i in range(n_frames):
        angle = 2 * np.pi * i / n_frames
        frame = render_frame(points, labels, angle, size)
        path = os.path.join(out_dir, f"frame_{i:03d}.png")
        write_png(path, frame)
        paths.append(path)
    return paths


def training_label_replay(
    points: np.ndarray, prediction_steps: Sequence[np.ndarray], out_dir: str,
    size: int = 480, angle: float = 0.8,
) -> List[str]:
    """One frame per training-step prediction array (the
    ``labels_during_training`` capability): watch labels evolve over training."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, preds in enumerate(prediction_steps):
        frame = render_frame(points, preds, angle, size)
        path = os.path.join(out_dir, f"step_{i:03d}.png")
        write_png(path, frame)
        paths.append(path)
    return paths
