"""The seven csrc/ kernels pooled: their bound times over their kernel times in the traced training stretch, in percent."""
from port_bench.lib import readers


def read(ctx):
    return readers.roofline(ctx, None)
