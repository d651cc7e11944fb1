"""Headless visualization of the port: palettes, PLY export, metric curves and
rotating-view PNG frames (the JAX package's ``viz/`` exports)."""
from pointcloud_segmentation_attention_tpu_torch.viz.palette import (
    LABEL_COLORS_FLOAT,
    LABEL_COLORS_U8,
    colorize_labels,
)
from pointcloud_segmentation_attention_tpu_torch.viz.ply_export import (
    export_labeled_scene,
    read_ply,
    write_ply,
)
from pointcloud_segmentation_attention_tpu_torch.viz.curves import extract_curve, plot_curves

__all__ = [
    "LABEL_COLORS_FLOAT", "LABEL_COLORS_U8", "colorize_labels",
    "export_labeled_scene", "read_ply", "write_ply",
    "extract_curve", "plot_curves",
]
