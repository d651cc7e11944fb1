"""Run the sem_seg ablation recipes at the sizes of the JAX package's vendored
``RESULTS_*.json`` and keep each result beside the card it ran on.

Each run is the recipe's own ``main`` in a child process (``python -m
pointcloud_segmentation_attention_tpu_torch.recipes.<recipe> --device cuda
--workdir W --results_path P``), with the arguments that give the vendored
size: Table 1's seed-1 repeat calls ``run_attention_ablation(seed=1)``
(that ``main`` has no ``--seed``), the wire parity runs ``--epochs 150`` and
``diversity_matched`` ``--budget_s 1500`` (their ``main`` defaults are 200 and
1200, as in the JAX package).  Each result goes to
``<out_dir>/RESULTS_<name>.json``, named as the vendored file it sits beside:

    {"result": <the recipe's JSON, unchanged>, "device": <nvidia-smi's
     "name, power limit">, "command": [...], "wall_seconds": s}

and each child's output to ``<out_dir>/logs/<name>.log``.  A run that fails
is reported and the others still run; the exit code is then 1.

Run: ``python -m pointcloud_segmentation_attention_tpu_torch.recipes.vendored_runs
[--only NAME ...] [--out_dir results_torch]``
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Sequence

PACKAGE = "pointcloud_segmentation_attention_tpu_torch"

# name (the vendored file's stem after RESULTS_) -> (recipe module, main's extra arguments)
RUNS = {
    "context_margin": ("context_margin", []),
    "attention_ablation": ("attention_ablation", []),
    "attention_ablation_seed1": ("attention_ablation", None),  # run_attention_ablation(seed=1)
    "feature_ablation": ("feature_ablation", []),
    "attention_q16_convergence": ("attention_wire_parity", ["--epochs", "150"]),
    "diversity_matched": ("diversity_matched", ["--budget_s", "1500"]),
}


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them; raises
    where ``nvidia-smi`` cannot be read, so that no record goes without its
    card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"nvidia-smi gives no card line: {e}") from e
    return out.strip().splitlines()[0]


def command(name: str, workdir: str, results_path: str) -> List[str]:
    """The child process's argument list for run ``name``, on the card."""
    recipe, extra = RUNS[name]
    if extra is None:
        code = (f"from {PACKAGE}.recipes.{recipe} import run_attention_ablation; "
                f"run_attention_ablation({workdir!r}, seed=1, results_path={results_path!r}, "
                "device='cuda')")
        return [sys.executable, "-c", code]
    return [sys.executable, "-m", f"{PACKAGE}.recipes.{recipe}", "--device", "cuda",
            "--workdir", workdir, "--results_path", results_path, *extra]


def run_one(name: str, argv: Sequence[str], results_path: str, out_dir: str,
            device_line: str) -> Dict:
    """Run ``argv``, wrap the JSON it wrote at ``results_path`` and write
    ``<out_dir>/RESULTS_<name>.json``; returns the wrapped record."""
    os.makedirs(os.path.join(out_dir, "logs"), exist_ok=True)
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, "logs", f"{name}.log"), "w") as log:
        rc = subprocess.run(list(argv), stdout=log, stderr=subprocess.STDOUT).returncode
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{name}: exit code {rc} after {wall:.1f} s "
                           f"(see {out_dir}/logs/{name}.log)")
    with open(results_path) as f:
        result = json.load(f)
    record = {"result": result, "device": device_line,
              "command": [os.path.basename(argv[0]), *argv[1:]], "wall_seconds": wall}
    with open(os.path.join(out_dir, f"RESULTS_{name}.json"), "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--only", nargs="*", default=None, choices=list(RUNS))
    p.add_argument("--out_dir", default="results_torch")
    args = p.parse_args(argv)
    device_line = card_line()
    failed = []
    for name in args.only or RUNS:
        work = os.path.relpath(tempfile.mkdtemp(prefix=".recipe_runs_", dir=os.getcwd()))
        try:
            results_path = os.path.join(work, "result.json")
            argv_ = command(name, os.path.join(work, "run"), results_path)
            print(f"[vendored] {name}: {' '.join(argv_)}", flush=True)
            rec = run_one(name, argv_, results_path, args.out_dir, device_line)
            print(f"[vendored] {name}: {rec['wall_seconds']:.1f} s on {device_line}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 -- report it, run the rest, exit 1
            failed.append(name)
            print(f"[vendored] {name} FAILED: {e}", flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"failed": failed, "device": device_line}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
