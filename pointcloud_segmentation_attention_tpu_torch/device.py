"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """The ``torch.device`` to run on; raises if CUDA is asked for and absent.
    Entry points default to ``"cuda"`` and run on the CPU only when the
    caller passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain versions")
    return dev
