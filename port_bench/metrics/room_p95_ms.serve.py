"""95th percentile, over every room of the window, of the time from the
room's hand-over to its labels coming back, in ms.  The closed loop keeps
the server at its capacity, where a tail swings with the smallest change,
so it is a per-layer metric beside the throughput."""


def read(ctx):
    return ctx["window"]["metrics"]["serve_room_p95_ms"]
