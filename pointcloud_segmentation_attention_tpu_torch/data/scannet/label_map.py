"""ScanNet class weights for training (numpy only).

The port's own copy of the JAX package's ``data/scannet/label_map.py``
weights: the published train-split histogram over the 21 compact classes
and ``1 / log(1.2 + freq)`` weights with the unannotated class zeroed.
"""
from __future__ import annotations

import numpy as np

# Train-set label histogram over the 21 compact classes (index 0 =
# unannotated), the published constants of the reference.
REFERENCE_LABEL_COUNTS = np.array([
    43590149, 41822096, 31929944, 5646791, 3762480, 9929883, 3401149,
    4921067, 6294926, 5426047, 3292834, 678377, 667652, 2675491, 3012156,
    721874, 437510, 435576, 359104, 475034, 4869969,
], np.int64)


def compute_class_weights(counts: np.ndarray) -> np.ndarray:
    """w_c = 1 / log(1.2 + freq_c), float64, with the unannotated class zeroed."""
    counts = np.asarray(counts, np.float64)
    freq = counts / counts.sum()
    weights = 1.0 / np.log(1.2 + freq)
    weights[0] = 0.0
    return weights


TRAIN_LABEL_WEIGHTS = compute_class_weights(REFERENCE_LABEL_COUNTS)
