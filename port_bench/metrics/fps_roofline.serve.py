"""FPS (csrc/fps.cu): its bound time at each level's shape over its kernel time in the traced serving stretch, in percent."""
from port_bench.lib import readers


def read(ctx):
    return readers.roofline(ctx, 'fps')
