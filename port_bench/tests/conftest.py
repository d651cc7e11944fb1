"""Shared pieces of the benchmark's CPU tests: a cell cut to a size the
CPU runs in seconds (2 clouds of 2,048 points, rooms of 12k-40k vertices)
at the configurations' own widths."""
from __future__ import annotations

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench.lib import spec  # noqa: E402

TINY_ROOMS = {"median": 20000, "sigma": 0.5, "min": 12000, "max": 40000}


def tiny_driver(workload: str, seed: int = 11, device="cpu"):
    """A driver of ``workload`` cut to the tiny size, and its cell."""
    cell = spec.Cell(workload)
    cfg = {**cell.config, "n_train_scenes": 4, "n_serve_scenes": 3}
    traffic = {**cell.traffic, "batch_size": 2, "npoints": 2048, "room_points": TINY_ROOMS,
               "warmup_steps": 1, "profile_steps": 2, "check_rooms": 2}
    return cell.driver_class()(cfg, traffic, seed, device), cell


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
