"""The harness: the manifest against its format, files found by name,
the result line, no fallback without a card, and what it may import."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from port_bench import run
from port_bench.lib import common, spec

ROOT = spec.ROOT
BENCH = spec.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _manifest():
    return spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_manifest_keeps_to_its_format():
    m = _manifest()
    assert list(m) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                       "per_layer"]
    assert m["paths"] == ["port_bench"] and m["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= m["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = spec.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
    assert any(e["name"] == "setup_s" and e["bound"] <= 0.25 for e in m["end_to_end"])
    for e in m["end_to_end"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert set(p) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(p["unit"]) and os.path.exists(os.path.join(BENCH, "metrics",
                                                                      p["name"] + ".py"))
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = spec.Cell(w["name"])
        e2e = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        # Each per-layer metric moves an end-to-end metric its cells report.
        assert all(p["moves"] in e2e for p in cell.per_layer)
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_a_new_configuration_traffic_and_metric_are_files_found_by_name(tmp_path):
    """A later cell needs new files and entries only."""
    bench = tmp_path / "port_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = _manifest()
    cfg = spec.load_json(os.path.join(BENCH, "configs", "sem_seg_features.json"))
    (bench / "configs" / "dummy_model.json").write_text(json.dumps({**cfg, "name": "dummy_model"}))
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {**spec.load_json(os.path.join(BENCH, "traffic", "train_sampler_b16.json")),
         "batch_size": 4}))
    (bench / "limits" / "dummy_cell.json").write_text(json.dumps({"loss_gap": 1e-3}))
    (bench / "metrics" / "dummy_metric.py").write_text("def read(ctx):\n    return 42.0\n")
    m["configs"].append({"name": "dummy_model", "source": "https://example.org/dummy",
                         "file": "port_bench/configs/dummy_model.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "dummy_cell", "config": "dummy_model", "traffic": "dummy_mix",
                           "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "dummy_metric", "unit": "%", "better": "higher",
                           "source": "device_trace", "layer": "a test",
                           "moves": "train_points_per_s", "workloads": ["dummy_cell"]})
    m["end_to_end"][0]["workloads"].append("dummy_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = spec.Cell("dummy_cell", root=str(tmp_path), bench_dir=str(bench))
    assert cell.config["name"] == "dummy_model" and cell.traffic["batch_size"] == 4
    assert cell.limits == {"loss_gap": 1e-3}
    assert [p["name"] for p in cell.per_layer] == ["dummy_metric"]
    assert cell.reader("dummy_metric")({}) == 42.0
    assert cell.driver_class().kind == "train"
    assert {e["name"] for e in cell.end_to_end} == {"train_points_per_s", "setup_s"}


def test_result_line_has_its_keys_and_the_checks_last():
    checks = [common.Check("loss_gap", 1e-6, 2e-4), common.Check("grad_norm_gap", 0.5, 1e-3)]
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 123, "busy_s": 0.5, "window_s": 1.0}
    out = run.result_line(False, 10, 0, {"idle.train": {"value": 50.0, "unit": "%"}}, device,
                          checks, {"device_ops": [["gemm", 0.1]], "idle_gaps": []})
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert out["checks"]["grad_norm_gap"] == {"value": 0.5, "limit": 1e-3}
    assert [c.ok for c in checks] == [True, False]
    assert not common.Check("x", float("nan"), 1.0).ok
    json.dumps(out)


def test_no_card_means_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "features_train",
                        "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["jax.numpy", "jaxlib", "flax.linen", "pointcloud_segmentation_attention_tpu.ops",
            "pointcloud_segmentation_attention_tpu_torch.ops", "jaxtyping", "torch"]
    assert spec.forbidden_modules(mods) == ["flax.linen", "jax.numpy", "jaxlib",
                                            "pointcloud_segmentation_attention_tpu.ops"]


@pytest.mark.parametrize("modules, port_allowed", [
    (["port_bench.run", "port_bench.lib.spec", "port_bench.lib.trace", "port_bench.lib.readers",
      "port_bench.drivers.train_sampler", "port_bench.drivers.serve_stream"], True),
    (["port_bench.reference.model", "port_bench.reference.train",
      "port_bench.reference.serve", "port_bench.reference.geometry"], False),
])
def test_what_the_harness_and_the_reference_import(modules, port_allowed):
    code = ("import sys, json; sys.path.insert(0, %r)\n" % ROOT
            + "".join(f"import {m}\n" for m in modules)
            + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env={k: v for k, v in os.environ.items()
                                         if k != "PYTHONSTARTUP"})
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not spec.forbidden_modules(top)
    assert ("pointcloud_segmentation_attention_tpu_torch" in top) == port_allowed


def test_no_harness_file_reads_the_jax_packages_benchmark_files():
    pattern = re.compile(r"(?<![\w.])bench\.py\b|\bBENCH_r\d|\bMULTICHIP_r\d|\bBASELINE\.(json|md)")
    here = os.path.abspath(__file__)
    for d, _, files in os.walk(BENCH):
        for f in files:
            path = os.path.join(d, f)
            if f.endswith((".py", ".json")) and path != here:
                with open(path) as fh:
                    assert not pattern.search(fh.read()), path
