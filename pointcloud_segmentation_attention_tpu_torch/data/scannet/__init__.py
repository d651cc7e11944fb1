"""ScanNet data of the port (numpy only): the scene store and splits, label
maps, chunkers, precompute and replay, the packed-record store, and the
raw-scan PLY preprocessing (``preprocessing``)."""
from pointcloud_segmentation_attention_tpu_torch.data.scannet import (  # noqa: F401
    preprocessing,
)
