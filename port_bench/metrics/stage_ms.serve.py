"""Host time the server's staging thread spends on a room (the program's
span ``serve.stage``: pack, decode, chunk count and upload), in ms a room
of the traced stretch: the span's total over the ``serve.rooms`` counter.
None where the program has no spans or counted no room."""
from pointcloud_segmentation_attention_tpu_torch.utils import profiler


def read(ctx):
    if not hasattr(profiler, "snapshot"):
        return None
    snap = profiler.snapshot()
    rooms = snap["counters"].get("serve.rooms", 0)
    span = snap["spans"].get("serve.stage")
    if not rooms or span is None:
        return None
    return 1e3 * span["total_s"] / rooms
