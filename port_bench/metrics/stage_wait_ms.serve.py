"""Time the serving thread waits for the staging thread, in ms a room of
the traced stretch: the program's span ``prefetch.wait`` (the consumer's
wait on the staged-scene queue) over the ``serve.rooms`` counter.  None
where the program has no spans or counted no room."""
from pointcloud_segmentation_attention_tpu_torch.utils import profiler


def read(ctx):
    if not hasattr(profiler, "snapshot"):
        return None
    snap = profiler.snapshot()
    rooms = snap["counters"].get("serve.rooms", 0)
    span = snap["spans"].get("prefetch.wait")
    if not rooms or span is None:
        return None
    return 1e3 * span["total_s"] / rooms
