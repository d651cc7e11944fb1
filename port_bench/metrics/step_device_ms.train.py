"""Kernel time a training step in the traced stretch, in ms."""
from port_bench.lib import readers


def read(ctx):
    return readers.per_unit(ctx, ctx['trace'].kernel_s) * 1e3
