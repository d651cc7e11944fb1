"""Kernel time a served room in the traced stretch, which serves the
whole pool once in pool order, in ms."""
from port_bench.lib import readers


def read(ctx):
    return readers.per_unit(ctx, ctx['trace'].kernel_s) * 1e3
