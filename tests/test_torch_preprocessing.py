"""The port's raw-scan path against the JAX package's, on the CPU.

``data/scannet/preprocessing.py`` is numpy in both packages and the port
keeps its own copy: the PLY reader must return JAX's arrays exactly (same
dtype and shape) for ascii, binary little- and big-endian files, with and
without normals, labels and faces (the port reads all-triangle binary faces
in one pass, anything else row by row); the vertex normals must be
bit-identical; ``ply_scene_to_npy`` / ``convert_scans`` and
``collect_scannet_scene`` must write the same ``.npy`` files.  The drill's
fabricated scan must be JAX's byte for byte, and the whole drill runs on
the CPU through ``main --device cpu`` with the perfect predictor scoring 1.
"""
import filecmp
import functools
import json
import os

import numpy as np
import pytest

from pointcloud_segmentation_attention_tpu.data.scannet import preprocessing as jprep
from pointcloud_segmentation_attention_tpu.recipes import realdata_drill as jdrill
from pointcloud_segmentation_attention_tpu_torch.data.scannet import preprocessing as tprep
from pointcloud_segmentation_attention_tpu_torch.recipes import realdata_drill as tdrill
from pointcloud_segmentation_attention_tpu_torch.train import trainer as ttrainer

PLY_TYPES = {"f4": "float", "f8": "double", "u1": "uchar", "i1": "char", "u2": "ushort",
             "i2": "short", "i4": "int", "u4": "uint"}


def _same_tree(a, b):
    """Every file under ``a`` and ``b`` has the same relative path and bytes."""
    files = []
    for root in (a, b):
        files.append(sorted(os.path.relpath(os.path.join(d, f), root)
                            for d, _, fs in os.walk(root) for f in fs))
    assert files[0] == files[1] and files[0]
    for rel in files[0]:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel


def _write_ply(path, fmt, vertex, faces=None, count_t="u1", index_t="i4",
               face_prop="vertex_indices"):
    """A PLY of ``vertex`` ([(name, dtype code, (N,) values)]) and optional
    ``faces`` (a list of index lists, ragged allowed), in ``fmt`` 'ascii',
    '<' or '>'."""
    n = len(vertex[0][2])
    fmt_name = {"ascii": "ascii", "<": "binary_little_endian", ">": "binary_big_endian"}[fmt]
    header = ["ply", f"format {fmt_name} 1.0", f"element vertex {n}"]
    header += [f"property {PLY_TYPES[code]} {name}" for name, code, _ in vertex]
    if faces is not None:
        header += [f"element face {len(faces)}",
                   f"property list {PLY_TYPES[count_t]} {PLY_TYPES[index_t]} {face_prop}"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if fmt == "ascii":
            for i in range(n):
                f.write((" ".join(str(v[i]) for _, _, v in vertex) + "\n").encode())
            for face in faces or []:
                f.write((f"{len(face)} " + " ".join(str(int(v)) for v in face) + "\n").encode())
            return
        rec = np.empty(n, [(name, fmt + code) for name, code, _ in vertex])
        for name, _, values in vertex:
            rec[name] = values
        f.write(rec.tobytes())
        for face in faces or []:
            f.write(np.array([len(face)], fmt + count_t).tobytes())
            f.write(np.asarray(face, fmt + index_t).tobytes())


def _vertex(n, seed, normals=False, colors=True, alpha=False, label=False):
    rng = np.random.RandomState(seed)
    xyz = rng.randn(n, 3).astype(np.float32)
    out = [(k, "f4", xyz[:, i]) for i, k in enumerate("xyz")]
    if normals:
        nrm = rng.randn(n, 3).astype(np.float32)
        out += [(k, "f4", nrm[:, i]) for i, k in enumerate(("nx", "ny", "nz"))]
    if colors:
        rgb = rng.randint(0, 256, (n, 3))
        out += [(k, "u1", rgb[:, i]) for i, k in enumerate(("red", "green", "blue"))]
    if alpha:
        out.append(("alpha", "u1", np.full(n, 255)))
    if label:
        out.append(("label", "u2", rng.randint(0, 41, n)))
    return out


def _triangles(n, f, seed):
    return np.random.RandomState(seed).randint(0, n, (f, 3)).tolist()


def _mesh_case(case, path):
    """Write one PLY layout of ``case`` to ``path``."""
    if case == "ascii_faces":
        _write_ply(path, "ascii", _vertex(40, 1), _triangles(40, 60, 1))
    elif case == "ascii_normals_labels":
        _write_ply(path, "ascii", _vertex(30, 2, normals=True, label=True))
    elif case == "binary_drill":  # the drill's writer: the official layout
        points, colors, faces, _, _ = tdrill.build_fake_room(n_grid=6)
        tdrill.write_binary_ply(path, points, colors, faces)
    elif case == "binary_normals_alpha_labels":
        _write_ply(path, "<", _vertex(50, 3, normals=True, alpha=True, label=True),
                   _triangles(50, 80, 3), index_t="u4", face_prop="vertex_index")
    elif case == "big_endian":
        _write_ply(path, ">", _vertex(50, 4, normals=True, label=True), _triangles(50, 70, 4),
                   count_t="i4")
    elif case == "binary_quads":  # four indices a face: the row-by-row read
        faces = np.random.RandomState(5).randint(0, 30, (20, 4)).tolist()
        _write_ply(path, "<", _vertex(30, 5), faces)
    elif case == "binary_no_faces":
        _write_ply(path, "<", _vertex(30, 6), [])
    else:
        raise ValueError(case)


MESH_CASES = ("ascii_faces", "ascii_normals_labels", "binary_drill",
              "binary_normals_alpha_labels", "big_endian", "binary_quads", "binary_no_faces")


@pytest.mark.parametrize("case", MESH_CASES)
def test_read_ply_mesh_matches_jax_exactly(case, tmp_path):
    path = str(tmp_path / "mesh.ply")
    _mesh_case(case, path)
    want, got = jprep.read_ply_mesh(path), tprep.read_ply_mesh(path)
    assert set(got) == set(want)
    for key, value in want.items():
        if value is None:
            assert got[key] is None, key
            continue
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    if case.startswith("binary") or case == "big_endian":
        assert got["faces"] is not None and got["points"].dtype == np.float32


def test_binary_triangle_reader_restores_position_on_other_lists(tmp_path):
    """A face element that starts with triangles and then holds a quad is
    read row by row from its start: the single-pass read gives up and
    rewinds (both packages then refuse the ragged faces alike)."""
    path = str(tmp_path / "mixed.ply")
    _write_ply(path, "<", _vertex(10, 7), [[0, 1, 2], [1, 2, 3], [0, 1, 2, 3]])
    with open(path, "rb") as f:
        _, elements = tprep._parse_header(f)
        tprep._read_binary_element(f, elements[0][1], elements[0][2], "<")
        start = f.tell()
        assert tprep._read_triangles(f, 3, elements[1][2], "<") is None
        assert f.tell() == start
    for prep in (jprep, tprep):
        with pytest.raises(ValueError):
            prep.read_ply_mesh(path)


@pytest.mark.parametrize("mesh", ["random_with_degenerate_faces", "drill_room"])
def test_vertex_normals_bit_identical_to_jax(mesh):
    if mesh == "drill_room":
        points, _, faces, _, _ = tdrill.build_fake_room(n_grid=10, seed=3)
    else:
        rng = np.random.RandomState(11)
        points = rng.randn(200, 3).astype(np.float32)
        faces = rng.randint(0, 180, (400, 3))  # vertices 180-199 have no face
        faces[:20, 1] = faces[:20, 0]           # degenerate faces
    want = jprep.compute_vertex_normals(points, faces)
    got = tprep.compute_vertex_normals(points, faces)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_convert_scans_writes_jax_npy_files(tmp_path):
    scans = tmp_path / "scans"
    for name in ("scene0000_00", "scene0001_00", "scene0002_00"):
        os.makedirs(scans / name)
    # Faces, no normals (computed), a labels PLY beside it.
    _write_ply(str(scans / "scene0000_00" / "scene0000_00_vh_clean_2.ply"), "ascii",
               _vertex(40, 8), _triangles(40, 60, 8))
    _write_ply(str(scans / "scene0000_00" / "scene0000_00_vh_clean_2.labels.ply"), "<",
               _vertex(40, 8, colors=False, label=True))
    # The drill's binary layout, no labels.
    points, colors, faces, _, _ = tdrill.build_fake_room(n_grid=6)
    tdrill.write_binary_ply(str(scans / "scene0001_00" / "scene0001_00_vh_clean_2.ply"),
                            points, colors, faces)
    # scene0002_00 has no mesh: skipped.
    want = jprep.convert_scans(str(scans), str(tmp_path / "jax"))
    got = tprep.convert_scans(str(scans), str(tmp_path / "port"))
    assert got == want == ["scene0000_00", "scene0001_00"]
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    # A mesh with normals and labels and no faces, one scene at a time.
    mesh = str(tmp_path / "normals.ply")
    _mesh_case("ascii_normals_labels", mesh)
    jprep.ply_scene_to_npy(mesh, str(tmp_path / "jax1"), "s")
    tprep.ply_scene_to_npy(mesh, str(tmp_path / "port1"), "s")
    _same_tree(str(tmp_path / "jax1"), str(tmp_path / "port1"))


def test_fabricated_scan_and_collect_match_jax(tmp_path):
    """``fabricate_raw_scan(seed=0)`` writes JAX's files byte for byte, and
    ``collect_scannet_scene`` resolves them to JAX's labels and store, from
    the tsv or from a mapping; neither given raises."""
    scene = "scene9999_00"
    jinfo = jdrill.fabricate_raw_scan(str(tmp_path / "jscan"), scene, n_grid=10, seed=0)
    tinfo = tdrill.fabricate_raw_scan(str(tmp_path / "tscan"), scene, n_grid=10, seed=0)
    _same_tree(str(tmp_path / "jscan"), str(tmp_path / "tscan"))
    assert tinfo["n_vertices"] == jinfo["n_vertices"]
    np.testing.assert_array_equal(tinfo["gt_nyu40"], jinfo["gt_nyu40"])
    scan = str(tmp_path / "tscan")
    want = jprep.collect_scannet_scene(scan, scene, str(tmp_path / "jroot"),
                                       label_map_tsv=tinfo["tsv"])
    got = tprep.collect_scannet_scene(scan, scene, str(tmp_path / "troot"),
                                      label_map_tsv=tinfo["tsv"])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tinfo["gt_nyu40"])
    _same_tree(str(tmp_path / "jroot"), str(tmp_path / "troot"))
    mapped = tprep.collect_scannet_scene(scan, scene, str(tmp_path / "troot2"),
                                         raw_to_nyu40=dict(tdrill.DRILL_CATEGORIES))
    np.testing.assert_array_equal(mapped, want)
    with pytest.raises(ValueError, match="raw_to_nyu40 or label_map_tsv"):
        tprep.collect_scannet_scene(scan, scene, str(tmp_path / "troot3"))


def test_download_scannet_raises_as_jax():
    for prep in (jprep, tprep):
        with pytest.raises(RuntimeError, match="ScanNet ToS"):
            prep.download_scannet()


def test_realdata_drill_main_on_cpu(tmp_path, monkeypatch, capsys):
    """The whole raw-scan path on the CPU (n_grid 12, 256-point chunks): the
    perfect predictor scores 1, one stitched label per vertex of JAX's
    fabricated room, the printed summary is the returned one."""
    monkeypatch.setattr(ttrainer, "MetricLogger",
                        functools.partial(ttrainer.MetricLogger, tensorboard=False))
    work = str(tmp_path / "drill")
    out = tdrill.main(["--device", "cpu", "--workdir", work, "--n_grid", "12",
                       "--npoints", "256"])
    n = jdrill.fabricate_raw_scan(str(tmp_path / "jscan"), "scene9999_00", n_grid=12)[
        "n_vertices"]
    assert out["perfect_miou"] == 1.0 and out["n_vertices"] == n == 320
    assert np.isfinite(out["model_miou"])
    assert np.load(os.path.join(work, "pred", "scene9999_00_labels.npy")).shape == (n,)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert os.path.exists(out["results_file"])
