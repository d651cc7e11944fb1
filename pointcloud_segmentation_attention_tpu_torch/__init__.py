"""PyTorch/CUDA port of ``pointcloud_segmentation_attention_tpu``.

PointNet++ semantic segmentation served on an NVIDIA H100: plain PyTorch
for the dense layers, hand-written CUDA kernels (``csrc/``) for the
geometry ops.  Imports torch and numpy only; the kernels are built at first
use on a CUDA tensor.
"""
__version__ = "0.1.0"
