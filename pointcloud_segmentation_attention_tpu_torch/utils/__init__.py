"""Tools of the port: the trainer configuration, metric logging, profiling
(traces, and the program's spans and counters),
and measurement scripts that run on the card (``h2d_bench``, ``bench_ops``,
``mem_analysis``, ``trace_breakdown``, ``tree_timing``, ``plan_sweep``)."""
from pointcloud_segmentation_attention_tpu_torch.utils.config import TrainConfig
from pointcloud_segmentation_attention_tpu_torch.utils.logging import MetricLogger, read_metrics
from pointcloud_segmentation_attention_tpu_torch.utils.profiler import trace

__all__ = ["TrainConfig", "MetricLogger", "read_metrics", "trace"]
