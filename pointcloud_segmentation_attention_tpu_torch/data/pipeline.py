"""Per-point feature assembly for model input (host-side numpy)."""
from __future__ import annotations

from typing import Optional

import numpy as np


def assemble_features(
    colors: Optional[np.ndarray],
    normals: Optional[np.ndarray],
    use_colors: bool,
    use_normals: bool,
) -> Optional[np.ndarray]:
    """Concat the selected per-point features: colors scaled from [0, 255]
    to [0, 1], then normals.  None when no features are selected."""
    parts = []
    if use_colors and colors is not None:
        parts.append(np.asarray(colors, np.float32) / 255.0)
    if use_normals and normals is not None:
        parts.append(np.asarray(normals, np.float32))
    if not parts:
        return None
    return np.concatenate(parts, axis=-1)
