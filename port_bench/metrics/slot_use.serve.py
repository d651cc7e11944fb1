"""Share of the predict slots the server scheduled that held a chunk, in
percent: the program's counters ``serve.chunks`` (the card's chunker's
count) over ``serve.slots`` (batches run times the batch size) in the
traced stretch.  None where the program has no counters or scheduled no
slot."""
from pointcloud_segmentation_attention_tpu_torch.utils import profiler


def read(ctx):
    if not hasattr(profiler, "snapshot"):
        return None
    counters = profiler.snapshot()["counters"]
    slots = counters.get("serve.slots", 0)
    if not slots:
        return None
    return 100.0 * counters.get("serve.chunks", 0) / slots
