"""Model matmul FLOPs of the window's training steps (three forwards a step, from the widths) over its wall time and the float32 peak, in percent."""
from port_bench.lib import readers


def read(ctx):
    return readers.mfu_train(ctx)
