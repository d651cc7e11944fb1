"""Kernels the device ran a training step in the traced stretch, as the profiler counts them."""
from port_bench.lib import readers


def read(ctx):
    return readers.per_unit(ctx, ctx['trace'].kernels)
