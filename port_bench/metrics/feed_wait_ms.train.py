"""Time a training step waits for its scene ids from the prefetch thread,
in ms a step of the traced stretch: the program's span ``prefetch.wait``
over the ``train.steps`` counter.  None where the program has no spans or
counted no step."""
from pointcloud_segmentation_attention_tpu_torch.utils import profiler


def read(ctx):
    if not hasattr(profiler, "snapshot"):
        return None
    snap = profiler.snapshot()
    steps = snap["counters"].get("train.steps", 0)
    span = snap["spans"].get("prefetch.wait")
    if not steps or span is None:
        return None
    return 1e3 * span["total_s"] / steps
