"""The port's ``viz/`` and its ball-splat renderer against the JAX package's,
on the CPU.

The palette, PLY export, curve extraction, PNG writer and rotating-view
frames are numpy in both packages and the port keeps its own copies: the
same arrays and the same files byte for byte.  ``native.render_ball`` is
the port's own build of the JAX package's C++ renderer: it must equal
``render_ball_numpy`` byte for byte (half-pixel coordinates, tied depths,
splats off the screen, NaN depths) and the JAX package's compiled
renderer.
"""
import filecmp
import os
import shutil
import subprocess

import numpy as np
import pytest

from pointcloud_segmentation_attention_tpu import native as jnative
from pointcloud_segmentation_attention_tpu import viz as jviz
from pointcloud_segmentation_attention_tpu.viz import animations as janim
from pointcloud_segmentation_attention_tpu_torch import native as tnative
from pointcloud_segmentation_attention_tpu_torch import viz as tviz
from pointcloud_segmentation_attention_tpu_torch.utils.logging import MetricLogger
from pointcloud_segmentation_attention_tpu_torch.viz import animations as tanim


def _same_bytes(a, b):
    assert filecmp.cmp(a, b, shallow=False), (a, b)


def test_palette_matches_jax():
    np.testing.assert_array_equal(tviz.LABEL_COLORS_FLOAT, jviz.LABEL_COLORS_FLOAT)
    np.testing.assert_array_equal(tviz.LABEL_COLORS_U8, jviz.LABEL_COLORS_U8)
    labels = np.arange(0, 130)  # the 21 classes, then the 50 part ids and beyond
    got = tviz.colorize_labels(labels)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jviz.colorize_labels(labels))
    assert not (got[21:] == 0).all(axis=1).any()  # wrapped ids skip the black slot


@pytest.mark.parametrize("with_colors", [False, True])
def test_write_ply_matches_jax_and_reads_back(with_colors, tmp_path):
    rng = np.random.RandomState(0)
    points = rng.randn(37, 3).astype(np.float32)
    colors = rng.randint(0, 256, (37, 3)).astype(np.uint8) if with_colors else None
    jpath, tpath = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jviz.write_ply(jpath, points, colors)
    tviz.write_ply(tpath, points, colors)
    _same_bytes(jpath, tpath)
    xyz, rgb = tviz.read_ply(tpath)
    np.testing.assert_array_equal(xyz, points)
    if with_colors:
        np.testing.assert_array_equal(rgb, colors)
    else:
        assert rgb is None
    jxyz, jrgb = jviz.read_ply(tpath)
    np.testing.assert_array_equal(xyz, jxyz)


def test_read_ascii_ply_and_labeled_scene_match_jax(tmp_path):
    path = str(tmp_path / "a.ply")
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                "property float y\nproperty float z\nproperty uchar red\n"
                "property uchar green\nproperty uchar blue\nend_header\n"
                "0 0 0 255 0 0\n1.5 2 -3 0 255 0\n0.25 0.5 0.75 1 2 3\n")
    for got, want in zip(tviz.read_ply(path), jviz.read_ply(path)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    points = np.random.RandomState(1).rand(25, 3).astype(np.float32)
    labels = np.arange(25) * 3
    jviz.export_labeled_scene(str(tmp_path / "j.ply"), points, labels)
    tviz.export_labeled_scene(str(tmp_path / "t.ply"), points, labels)
    _same_bytes(str(tmp_path / "j.ply"), str(tmp_path / "t.ply"))


def test_extract_curve_matches_jax_and_plots(tmp_path):
    logger = MetricLogger(str(tmp_path), "train", tensorboard=False)
    for step in range(1, 6):
        logger.log(step, {"train_loss": 1.0 / step})
        if step % 2 == 0:
            logger.log(step, {"val_miou": 0.1 * step})
    logger.close()
    path = logger.path
    for key in ("train_loss", "val_miou", "missing"):
        assert tviz.extract_curve(path, key) == jviz.extract_curve(path, key)
    assert tviz.extract_curve(path, "val_miou") == ([2, 4], [0.2, 0.4])
    out = str(tmp_path / "curves.png")
    assert tviz.plot_curves({"run": path}, "train_loss", out_path=out, title="t") == out
    assert os.path.getsize(out) > 0


def _splat_case(case):
    """(points (N, 3) float32, colors (N, 3) uint8, h, w) of one case."""
    rng = np.random.RandomState(sorted(SPLAT_CASES).index(case))
    h, w = 40, 56
    if case == "half_pixels":  # x, y on .5 (and -.5): lround goes away from zero
        xy = rng.randint(-3, 60, (300, 2)) + 0.5
        xy[:40] *= -1
        points = np.concatenate([xy, rng.rand(300, 1)], 1)
    elif case == "equal_depths":  # ties: the earlier point keeps the pixel
        base = rng.rand(100, 3) * [w, h, 1]
        points = np.concatenate([base, base, base + [0.2, -0.2, 0.0]])
        points[:, 2] = np.round(points[:, 2], 1)
    elif case == "off_screen":  # splats across and beyond every edge
        points = rng.rand(400, 3) * [w + 30, h + 30, 3] - [15, 15, 1]
    elif case == "nan_and_inf_depths":
        points = rng.rand(200, 3) * [w, h, 1]
        points[::7, 2] = np.nan
        points[1::7, 2] = np.inf
        points[2::7, 2] = -np.inf
    elif case == "seeded_scene":
        points = rng.rand(2000, 3) * [w, h, 4]
    elif case == "empty":
        points = np.zeros((0, 3))
    else:
        raise ValueError(case)
    colors = rng.randint(0, 256, (len(points), 3))
    return points.astype(np.float32), colors.astype(np.uint8), h, w


SPLAT_CASES = ("half_pixels", "equal_depths", "off_screen", "nan_and_inf_depths",
               "seeded_scene", "empty")


@pytest.mark.parametrize("case", SPLAT_CASES)
def test_render_ball_equals_its_plain_version_byte_for_byte(case):
    points, colors, h, w = _splat_case(case)
    for radius in (0, 1, 2, 3, 5):
        got = tnative.render_ball(points, colors, h=h, w=w, radius=radius, background=7)
        want = tnative.render_ball_numpy(points, colors, h=h, w=w, radius=radius,
                                         background=7)
        assert got.dtype == want.dtype == np.uint8 and got.shape == (h, w, 3)
        assert got.tobytes() == want.tobytes(), (case, radius)
        if len(points):
            assert (got != 7).any()


@pytest.mark.parametrize("case", ["half_pixels", "equal_depths", "off_screen",
                                  "seeded_scene"])
def test_render_ball_equals_jax_compiled_renderer(case):
    assert jnative.available()  # g++ is here: the JAX package runs its C++
    points, colors, h, w = _splat_case(case)
    for radius in (1, 2, 3):
        want = jnative.render_ball(points, colors, h=h, w=w, radius=radius)
        got = tnative.render_ball(points, colors, h=h, w=w, radius=radius)
        assert got.tobytes() == want.tobytes(), (case, radius)


def test_render_ball_refuses_bad_input():
    colors = np.zeros((2, 3), np.uint8)
    for fn in (tnative.render_ball, tnative.render_ball_numpy):
        with pytest.raises(ValueError, match="both be"):
            fn(np.zeros((2, 2), np.float32), colors)
        with pytest.raises(ValueError, match="both be"):
            fn(np.zeros((3, 3), np.float32), colors)
        with pytest.raises(ValueError, match="finite"):
            fn(np.array([[np.nan, 0, 0], [0, 0, 0]], np.float32), colors)
        with pytest.raises(ValueError, match="finite"):
            fn(np.array([[0, 2.0 ** 31, 0], [0, 0, 0]], np.float32), colors)


def test_frames_match_jax_byte_for_byte(tmp_path):
    """``write_png``, ``rotation_animation`` (subsampled) and
    ``training_label_replay`` write JAX's files."""
    rng = np.random.RandomState(2)
    points = (rng.rand(600, 3) * [4, 3, 2.5]).astype(np.float32)
    labels = rng.randint(0, 21, 600)
    jframes = janim.rotation_animation(points, labels, str(tmp_path / "j"), n_frames=3,
                                       size=64, max_points=400)
    tframes = tanim.rotation_animation(points, labels, str(tmp_path / "t"), n_frames=3,
                                       size=64, max_points=400)
    assert [os.path.basename(p) for p in tframes] == [os.path.basename(p) for p in jframes]
    for j, t in zip(jframes, tframes):
        _same_bytes(j, t)
    steps = [labels, (labels + 5) % 21]
    jsteps = janim.training_label_replay(points, steps, str(tmp_path / "js"), size=48)
    tsteps = tanim.training_label_replay(points, steps, str(tmp_path / "ts"), size=48)
    for j, t in zip(jsteps, tsteps):
        _same_bytes(j, t)
    image = rng.randint(0, 256, (5, 7, 3)).astype(np.uint8)
    janim.write_png(str(tmp_path / "j.png"), image)
    tanim.write_png(str(tmp_path / "t.png"), image)
    _same_bytes(str(tmp_path / "j.png"), str(tmp_path / "t.png"))
    frame = tanim.render_frame(points, labels, 0.3, size=64)
    np.testing.assert_array_equal(frame, janim.render_frame(points, labels, 0.3, size=64))


def test_native_library_hashes_every_source_and_raises_on_a_failed_build(tmp_path, monkeypatch):
    """The library's name changes with either source, so an edited renderer
    is never served by a stale build; a missing compiler or a failed build
    raises with the reason, and nothing falls back."""
    sources = []
    for src in tnative.SOURCES:
        sources.append(str(tmp_path / os.path.basename(src)))
        shutil.copy(src, sources[-1])
    monkeypatch.setattr(tnative, "SOURCES", tuple(sources))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    before = tnative.library_path()
    with open(sources[1], "a") as f:
        f.write("\n// edited\n")
    assert tnative.library_path() != before
    with open(sources[1], "a") as f:
        f.write("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build"):
        tnative.render_ball(np.zeros((1, 3), np.float32), np.zeros((1, 3), np.uint8))

    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(subprocess, "run", no_compiler)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.build()
    assert not os.path.exists(tnative.library_path())
