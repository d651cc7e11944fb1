"""Serving path of the port: chunk, predict, stitch."""
from pointcloud_segmentation_attention_tpu_torch.eval.full_scene import (
    make_predict_fn,
    predict_scene_chunks,
    scene_chunks,
)

__all__ = ["make_predict_fn", "predict_scene_chunks", "scene_chunks"]
