"""Training-side modules of the port: the train state (Adam), the train,
eval and prediction steps, losses, metrics, schedules, the checkpoint bridge
to the JAX package and the checkpoint manager.  The trainer entry point is
``train/trainer.py``."""
from pointcloud_segmentation_attention_tpu_torch.train.checkpoints import (
    BestKeeper,
    best_checkpoint,
    export_jax_state,
    export_jax_variables,
    load_jax_checkpoint,
    load_jax_state,
    load_jax_variables,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    save_jax_checkpoint,
)
from pointcloud_segmentation_attention_tpu_torch.train.steps import (
    seg_eval_step,
    seg_predict_step,
    seg_predict_step_packed,
    seg_train_step,
)
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState

__all__ = ["BestKeeper", "TrainState", "best_checkpoint", "export_jax_state",
           "export_jax_variables", "latest_checkpoint", "load_jax_checkpoint", "load_jax_state",
           "load_jax_variables", "restore_checkpoint", "save_checkpoint", "save_jax_checkpoint",
           "seg_eval_step", "seg_predict_step", "seg_predict_step_packed", "seg_train_step"]
