"""Time the serving thread waits for a room's labels to reach the host, in
ms a room of the traced stretch: the program's span ``serve.label_wait``
(the CUDA event waits of the fetch) over the ``serve.rooms`` counter.
None where the program has no spans or counted no room."""
from pointcloud_segmentation_attention_tpu_torch.utils import profiler


def read(ctx):
    if not hasattr(profiler, "snapshot"):
        return None
    snap = profiler.snapshot()
    rooms = snap["counters"].get("serve.rooms", 0)
    span = snap["spans"].get("serve.label_wait")
    if not rooms or span is None:
        return None
    return 1e3 * span["total_s"] / rooms
