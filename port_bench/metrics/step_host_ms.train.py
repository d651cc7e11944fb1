"""Host time to issue a training step (the program's span ``train.step``:
the sampler's cut, forward, backward and optimizer as queued on the host,
under the profiler's cost per op), in ms a step of the traced stretch:
the span's total over the ``train.steps`` counter.  None where the
program has no spans or counted no step."""
from pointcloud_segmentation_attention_tpu_torch.utils import profiler


def read(ctx):
    if not hasattr(profiler, "snapshot"):
        return None
    snap = profiler.snapshot()
    steps = snap["counters"].get("train.steps", 0)
    span = snap["spans"].get("train.step")
    if not steps or span is None:
        return None
    return 1e3 * span["total_s"] / steps
