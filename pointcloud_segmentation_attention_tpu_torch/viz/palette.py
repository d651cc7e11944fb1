"""21-class label color palette: the port's own copy of the JAX package's
``viz/palette.py``.

Reference: ``attention_points/visualization/qualitative_animations.py:29-33``
(the per-class colors used for qualitative result videos), normalized here to
0-255 ints for PLY export.
"""
from __future__ import annotations

import numpy as np

# Per-class RGB (0-1 floats as in the reference), index = [0, 20] label.
LABEL_COLORS_FLOAT = np.array([
    (0.0, 0.0, 0.0),        # 0 unannotated - black
    (0.6, 0.6, 0.6),        # 1 wall
    (0.6, 0.4, 0.2),        # 2 floor
    (0.3, 0.6, 0.9),        # 3 cabinet
    (0.9, 0.1, 0.1),        # 4 bed
    (0.1, 0.7, 0.1),        # 5 chair
    (0.9, 0.5, 0.1),        # 6 sofa
    (0.8, 0.8, 0.1),        # 7 table
    (0.5, 0.2, 0.6),        # 8 door
    (0.1, 0.8, 0.8),        # 9 window
    (0.9, 0.1, 0.6),        # 10 bookshelf
    (0.4, 0.9, 0.4),        # 11 picture
    (0.2, 0.2, 0.9),        # 12 counter
    (0.7, 0.4, 0.4),        # 13 desk
    (0.4, 0.7, 0.7),        # 14 curtain
    (0.7, 0.7, 0.3),        # 15 refrigerator
    (0.3, 0.3, 0.7),        # 16 shower curtain
    (0.9, 0.7, 0.3),        # 17 toilet
    (0.3, 0.9, 0.7),        # 18 sink
    (0.7, 0.3, 0.9),        # 19 bathtub
    (0.5, 0.5, 0.2),        # 20 otherfurniture
], np.float32)

LABEL_COLORS_U8 = (LABEL_COLORS_FLOAT * 255).astype(np.uint8)


def colorize_labels(labels: np.ndarray) -> np.ndarray:
    """(N,) int labels -> (N, 3) uint8 colors.  Labels beyond the 21-class
    ScanNet palette (e.g. the 50 ShapeNet part ids) cycle through it,
    skipping the black 'unannotated' slot."""
    labels = np.asarray(labels, np.int64)
    n = len(LABEL_COLORS_U8)
    wrapped = np.where(labels < n, labels, (labels - n) % (n - 1) + 1)
    return LABEL_COLORS_U8[wrapped]
