"""Forward FLOPs of the chunks the window's rooms need (the reference chunker's count, not the slots scheduled) over its wall time and the float32 peak, in percent."""
from port_bench.lib import readers


def read(ctx):
    return readers.mfu_serve(ctx)
