"""Readings that the limits of ``limits/<cell>.json`` are set from, on the
chip at the cell's own size:

    python3 port_bench/tools/calibrate.py --workload <name> --seeds 1,2,3 \
        [--controls 3] [--seconds 3] > readings.jsonl

For each seed, one line: the program's readings against the float32
reference (after a set-up and, for serving, a short window at the cell's
load), and for the first ``--controls`` seeds also the control's (the
reference computed in TF32, the next precision below the configuration's
float32) and those of the faults each check is shown to catch.  All seeds
run in one process, so the kernels build once.  The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def train_readings(d, controls: bool):
    want = d.reference_run("f32")
    out = {"program": d.readings(d.checked, want),
           "worst_leaves": [d.extras["worst_change_leaf"], d.extras["worst_grad_leaf"]]}
    if controls:
        for variant in ("tf32", "half_batch", "altered_labels"):
            out[variant] = d.readings(d.reference_run(variant), want)
    return out


def serve_readings(d, controls: bool):
    import torch

    def served(r, _):
        return torch.from_numpy(d.served[r][1]).to(d.device)

    out = {"program": d.readings(served)}
    if controls:
        def tf32(r, _):
            return d.reference_logits(d.served[r][0], tf32=True).argmax(dim=1)

        def altered(r, _):
            lab = served(r, None).long()
            g = torch.Generator(device=d.device).manual_seed(r)
            flip = torch.rand(lab.shape, generator=g, device=d.device) < 0.01
            return torch.where(flip, (lab + 1) % d.cfg["num_classes"], lab)

        def dropped(r, _):
            lab = served(r, None)
            g = torch.Generator(device=d.device).manual_seed(r)
            return torch.where(torch.rand(lab.shape, generator=g, device=d.device) < 0.5,
                               torch.zeros_like(lab), lab)

        for name, fn in (("tf32", tf32), ("altered_labels", altered), ("half_dropped", dropped)):
            out[name] = d.readings(fn)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from port_bench.lib import spec

    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        d = cell.driver_class()(cell.config, cell.traffic, seed, torch.device("cuda:0"))
        d.setup()
        t_setup = time.perf_counter() - t0
        if d.kind == "serve":
            d.window(args.seconds)
        d.release()
        t1 = time.perf_counter()
        fn = train_readings if d.kind == "train" else serve_readings
        rec = fn(d, i < args.controls)
        rec.update(workload=args.workload, seed=seed, setup_s=t_setup,
                   check_s=time.perf_counter() - t1, phases=d.extras.get("setup_phases_s"))
        print(json.dumps(rec), flush=True)
        del d
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
