"""Metric logging: a JSONL file, plus TensorBoard events when
``torch.utils.tensorboard`` imports.

One record per logged step, ``{"step", "time", <metric>: float, ...}``, in
``{log_dir}/{name}_metrics.jsonl``: the format of the JAX package's
``utils/logging.py``, so its curve plotting reads either package's logs.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    def __init__(self, log_dir: str, name: str = "train", tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, name))
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def read_metrics(path: str):
    """A metrics JSONL file as a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
