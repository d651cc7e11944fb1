"""NYU40 <-> [0, 20] label mapping and ScanNet class weights (numpy only).

The port's own copy of the JAX package's ``data/scannet/label_map.py``: the
20 benchmark NYU40 ids, the compact map and its inverse, and the published
train-split histogram over the 21 compact classes with its
``1 / log(1.2 + freq)`` weights (the unannotated class zeroed).
"""
from __future__ import annotations

import numpy as np

# The 20 ScanNet-benchmark NYU40 class ids, in benchmark order.
VALID_CLASS_IDS_NYU40 = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39,
)

# NYU40 id -> compact [0, 20] id; everything not listed maps to 0 (unannotated).
LABEL_MAP = {0: 0}
for _i, _nyu in enumerate(VALID_CLASS_IDS_NYU40):
    LABEL_MAP[_nyu] = _i + 1

# compact id -> NYU40 id (0 stays 0).
INVERSE_LABEL_MAP = {v: k for k, v in LABEL_MAP.items()}

_LUT = np.zeros(41, np.int32)
for _nyu, _compact in LABEL_MAP.items():
    _LUT[_nyu] = _compact


def map_labels(labels: np.ndarray) -> np.ndarray:
    """NYU40 ids -> [0, 20] int32; ids outside [0, 40] clamp to 40 -> 0."""
    idx = np.clip(np.asarray(labels, np.int64), 0, 40)
    return _LUT[idx]


def map_to_nyu40(labels: np.ndarray) -> np.ndarray:
    """[0, 20] -> NYU40 int64 (0 -> 0).  The benchmark exporter's variant
    that maps 0 to wall is ``eval.benchmark.map_to_nyu40_for_benchmark``."""
    lut = np.zeros(21, np.int64)
    for compact, nyu in INVERSE_LABEL_MAP.items():
        lut[compact] = nyu
    return lut[np.asarray(labels, np.int64)]


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
