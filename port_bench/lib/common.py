"""Pieces every driver shares: seeds, the weights the benchmark makes, the
device's description and the checks' record."""
from __future__ import annotations

import contextlib
import dataclasses
import math
import subprocess
import time
from typing import Dict

import numpy as np
import torch


def mix(seed: int, *tags: int) -> int:
    """A 63-bit integer drawn from (seed, tags): any whole seed, also past 32
    bits, gives its own stream."""
    return int(np.random.SeedSequence((int(seed),) + tags).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def make_weights(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights for a model with these state-dict entries, from ``seed``, made
    on ``device`` by one generator in two calls: (in, out) kernels
    Xavier-uniform, biases uniform in [-0.05, 0.05]; BatchNorm scale uniform
    in [0.8, 1.2], bias normal(0, 0.05), running mean normal(0, 0.1) and
    variance uniform in [0.5, 1.5], so that BN is not the identity in eval
    mode."""
    uniform, normal = {}, {}
    for name, shape in shapes.items():
        n = int(np.prod(shape)) if len(shape) else 1
        if name.endswith("bn.bias") or name.endswith("bn.mean"):
            normal[name] = n
        else:
            uniform[name] = n
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, 303))
    u = torch.rand(sum(uniform.values()), generator=g, device=device)
    z = torch.randn(sum(normal.values()), generator=g, device=device)
    out, ou, oz = {}, 0, 0
    for name, shape in shapes.items():
        if name in uniform:
            x = u[ou:ou + uniform[name]].reshape(shape)
            ou += uniform[name]
            if name.endswith("bn.scale"):
                x = 0.8 + 0.4 * x
            elif name.endswith("bn.var"):
                x = 0.5 + x
            elif name.endswith("kernel"):
                x = (2.0 * x - 1.0) * math.sqrt(6.0 / (shape[0] + shape[1]))
            else:
                x = (2.0 * x - 1.0) * 0.05
        else:
            x = z[oz:oz + normal[name]].reshape(shape)
            oz += normal[name]
            x = x * (0.1 if name.endswith("bn.mean") else 0.05)
        out[name] = x.contiguous()
    return out


@contextlib.contextmanager
def timed(record: Dict, name: str):
    """Add the seconds the block takes to ``record[name]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record[name] = record.get(name, 0.0) + time.perf_counter() - t0


def device_info(count: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


@dataclasses.dataclass
class Check:
    """One compared number: ``ok`` when ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit
