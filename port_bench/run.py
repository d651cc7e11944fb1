"""Run one cell of the port's benchmark once:

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Loads and warms up the cell (``setup_s``,
process start to the first timed operation), measures for ``--seconds``,
and with ``--trace 1`` profiles a further stretch; then frees the
program's state and holds what the window's path produced against the
plain reference.  Progress goes to standard error; the compared numbers
with their limits are its last lines; the last line of standard output
is the result as one JSON object.  Without a CUDA device, or with fewer
than the cell needs, it exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _since_process_start() -> float:
    """Seconds since this process was started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _profile_factory():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return lambda: torch.profiler.profile(activities=acts)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks, breakdown=None) -> dict:
    """The result object: the keys the benchmark's format names, then ``checks`` last,
    each compared number beside its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out


def run(args) -> int:
    # Every kernel or build cache a library may keep goes to fixed
    # directories inside the checkout, so only a checkout's first run builds.
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    sys.path.insert(0, ROOT)
    import torch

    from port_bench.lib import common, spec, trace

    log(f"[start] torch imported {_since_process_start():.3f} s after process start")
    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}: no result")
        return 2
    dev = torch.device("cuda:0")
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {common.nvidia_smi()}")
    driver = cell.driver_class()(cell.config, cell.traffic, args.seed, dev)
    log(f"[start] the program imported, the device up {_since_process_start():.3f} s after "
        "process start")
    driver.setup()
    setup_s = _since_process_start()
    log(f"[setup] {setup_s:.3f} s")
    # Set-up's objects out of the collector's way, so that no long collection
    # of them lands in the window.
    gc.collect()
    gc.freeze()
    rec = driver.window(args.seconds)
    log(f"[window] {json.dumps({k: v for k, v in rec.items() if k != 'pool_counts'})}; "
        f"extras {json.dumps(driver.extras, default=str)}; nvidia-smi: {common.nvidia_smi()}")
    traced = summary = None
    if args.trace:
        for attempt in range(1, 4):
            traced = driver.traced(_profile_factory())
            summary = trace.summarize(traced["prof"])
            if summary.kernels:
                break
            log(f"[trace] session {attempt} recorded no kernel; again")
        del traced["prof"]
        log(f"[trace] window {summary.window_s:.6f} s, busy {summary.busy_s:.6f} s, "
            f"kernels {summary.kernels}, groups {json.dumps(summary.group_s)}, "
            f"own {json.dumps(summary.own_s)}")
    peak = torch.cuda.max_memory_allocated(dev)
    driver.release()
    checks = driver.check(cell.limits)
    log(f"[check] extras {json.dumps(driver.extras, default=str)}")
    correct = all(c.ok for c in checks) and rec["failed"] == 0

    if args.trace:
        ctx = {"cell": cell, "driver": driver, "window": rec, "traced": traced,
               "trace": summary, "seconds": args.seconds}
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **rec["metrics"]}
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {**common.device_info(cell.chips), "memory_peak_bytes": int(peak)}
    if args.trace:
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = result_line(correct, rec["attempted"], rec["failed"], metrics, device, checks,
                         trace.breakdown(summary) if args.trace else None)

    found = spec.forbidden_modules(list(sys.modules))
    if found:
        log(f"modules of JAX or of the JAX package are loaded: {found}: no result")
        return 3
    for c in checks:
        log(f"{c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return run(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
