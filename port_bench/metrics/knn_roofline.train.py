"""The kNN kernel (csrc/knn.cu): the bound time of the kNN calls the
Point Transformer needs a step (``cost/point_transformer.py``) over the
kernel's device time, in percent, over the traced training stretch.  None
where the traced record holds no kNN kernel time."""
from port_bench.cost import point_transformer as cost


def read(ctx):
    tr = ctx["traced"]
    spent = tr.get("knn_kernel_s")
    if not spent:
        return None
    d = ctx["driver"]
    bound = cost.knn_bound_s(d.cfg, d.traffic["batch_size"], d.traffic["npoints"])
    return 100.0 * bound * tr["steps"] / spent
