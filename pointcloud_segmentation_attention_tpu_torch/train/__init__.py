"""Training-side modules of the port: the train state (Adam), the train,
eval and prediction steps, losses, metrics, schedules, the checkpoint bridge
to the JAX package and the checkpoint manager, BN folding for serving,
the device-resident replay and the on-device chunk sampler; the
classification and part-segmentation steps (``cls_steps``).  The trainer
entry points are ``train/trainer.py`` (ScanNet), ``train/cls_trainer.py``
(ModelNet), ``train/partseg_trainer.py`` (ShapeNet-part),
``train/v1_partseg_trainer.py`` (the PointNet v1 joint part segmenter on h5
shards), ``train/s3dis_trainer.py`` (S3DIS) and
``train/v1_scannet_trainer.py`` (the upstream ScanNet v1 trainer)."""
from pointcloud_segmentation_attention_tpu_torch.train.bn_fold import fold_batchnorm_for_inference
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
from pointcloud_segmentation_attention_tpu_torch.train.cls_steps import (
    cls_eval_step,
    cls_train_step,
    partseg_eval_step,
    partseg_train_step,
)
from pointcloud_segmentation_attention_tpu_torch.train.device_replay import (
    DeviceReplay,
    make_resident_train_step,
)
from pointcloud_segmentation_attention_tpu_torch.train.device_sampler import (
    ResidentScenes,
    make_sampling_train_step,
    sample_chunk_batch,
)
from pointcloud_segmentation_attention_tpu_torch.train.steps import (
    seg_eval_step,
    seg_predict_step,
    seg_predict_step_packed,
    seg_train_step,
)
from pointcloud_segmentation_attention_tpu_torch.train.train_state import TrainState
from pointcloud_segmentation_attention_tpu_torch.train.v1_scannet_trainer import (
    eval_whole_scenes,
    get_batch_wdp,
    train_scannet_v1,
)

__all__ = ["BestKeeper", "DeviceReplay", "ResidentScenes", "TrainState", "best_checkpoint",
           "cls_eval_step", "cls_train_step", "partseg_eval_step", "partseg_train_step",
           "eval_whole_scenes", "export_jax_state", "get_batch_wdp", "export_jax_variables", "fold_batchnorm_for_inference",
           "latest_checkpoint", "load_jax_checkpoint", "load_jax_state", "load_jax_variables",
           "make_resident_train_step", "make_sampling_train_step", "restore_checkpoint",
           "sample_chunk_batch", "save_checkpoint", "save_jax_checkpoint", "seg_eval_step",
           "seg_predict_step", "seg_predict_step_packed", "seg_train_step",
           "train_scannet_v1"]
