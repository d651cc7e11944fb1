"""kNN calls a training step: the program's counter ``knn.calls`` over its
``train.steps`` counter, over the traced sessions.  None where the program
has no counters or counted no step or call."""
from pointcloud_segmentation_attention_tpu_torch.utils import profiler


def read(ctx):
    if not hasattr(profiler, "snapshot"):
        return None
    counters = profiler.snapshot()["counters"]
    steps, calls = counters.get("train.steps", 0), counters.get("knn.calls", 0)
    if not steps or not calls:
        return None
    return calls / steps
