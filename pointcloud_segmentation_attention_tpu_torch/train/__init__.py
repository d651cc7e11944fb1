"""Training-side modules of the port: the train state (Adam), the train,
eval and prediction steps, losses, metrics, schedules and the checkpoint
bridge to the JAX package."""
from pointcloud_segmentation_attention_tpu_torch.train.checkpoints import (
    export_jax_state,
    export_jax_variables,
    load_jax_checkpoint,
    load_jax_state,
    load_jax_variables,
    save_jax_checkpoint,
)
from pointcloud_segmentation_attention_tpu_torch.train.steps import (
    seg_eval_step,
    seg_predict_step,
    seg_train_step,
)
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState

__all__ = ["TrainState", "export_jax_state", "export_jax_variables", "load_jax_checkpoint",
           "load_jax_state", "load_jax_variables", "save_jax_checkpoint", "seg_eval_step",
           "seg_predict_step", "seg_train_step"]
