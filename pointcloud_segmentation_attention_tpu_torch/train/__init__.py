"""Training-side modules of the port ported so far: the weight bridge and the
prediction step."""
from pointcloud_segmentation_attention_tpu_torch.train.checkpoints import (
    export_jax_variables,
    load_jax_checkpoint,
    load_jax_variables,
)
from pointcloud_segmentation_attention_tpu_torch.train.steps import seg_predict_step

__all__ = ["export_jax_variables", "load_jax_checkpoint", "load_jax_variables",
           "seg_predict_step"]
