"""Share of training steps that replayed the step's CUDA graph, in %: the
program's counter ``train.graph_replays`` over its ``train.steps`` counter,
over the traced sessions.  None where the program has no counters or
counted no step or replay."""
from pointcloud_segmentation_attention_tpu_torch.utils import profiler


def read(ctx):
    if not hasattr(profiler, "snapshot"):
        return None
    counters = profiler.snapshot()["counters"]
    steps, replays = counters.get("train.steps", 0), counters.get("train.graph_replays", 0)
    if not steps or not replays:
        return None
    return 100.0 * replays / steps
