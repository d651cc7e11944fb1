"""Device time of the kernels launched under the program's span
``nn.vector_attention`` (the Point Transformer layers' forward), in ms a
step of the traced stretch.  None where the traced record holds none."""


def read(ctx):
    tr = ctx["traced"]
    spent = tr.get("vector_attention_fwd_s")
    if not spent:
        return None
    return 1e3 * spent / tr["steps"]
