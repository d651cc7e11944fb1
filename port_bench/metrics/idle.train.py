"""Share of the window in which no kernel ran, in percent: the traced stretch's busy time (the union of kernel intervals) a step over the window's wall time a step."""
from port_bench.lib import readers


def read(ctx):
    return readers.idle_share(ctx)
