"""Serving and scoring of the port: chunk, predict, stitch; the ScanNet
benchmark export and its evaluator."""
from pointcloud_segmentation_attention_tpu_torch.eval.benchmark import (
    CLASS_LABELS,
    VALID_CLASS_IDS,
    evaluate,
    export_benchmark_txt,
    export_groundtruth_from_json,
    export_ids,
    load_ids,
    map_to_nyu40_for_benchmark,
)
from pointcloud_segmentation_attention_tpu_torch.eval.full_scene import (
    generate_predictions,
    make_predict_fn,
    predict_scene_chunks,
    scene_chunks,
)

__all__ = ["CLASS_LABELS", "VALID_CLASS_IDS", "evaluate", "export_benchmark_txt",
           "export_groundtruth_from_json", "export_ids", "generate_predictions", "load_ids",
           "make_predict_fn", "map_to_nyu40_for_benchmark", "predict_scene_chunks",
           "scene_chunks"]
