"""The Point Transformer's matmul FLOPs of the window's training steps
(three forwards a step, from the widths: ``cost/point_transformer.py``)
over the window's wall time and the float32 peak, in percent.  None where
the configuration has no Point Transformer widths."""
from port_bench.cost import kernels
from port_bench.cost import point_transformer as cost


def read(ctx):
    d, w = ctx["driver"], ctx["window"]
    if "planes" not in d.cfg or not w.get("steps"):
        return None
    flops = cost.train_step_flops(d.cfg, d.traffic["batch_size"], d.traffic["npoints"])
    return 100.0 * flops * w["steps"] / w["wall_s"] / kernels.peak_flops()
