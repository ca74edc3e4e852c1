"""Device ms a step of the traced window in kernels that are neither matrix products
nor the port's own kernels (AdamW, norms, the loss and the recomputation's
passes), by the frozen kernel groups of ``bench/lib/trace.py``."""


def read(ctx):
    other = ctx.trace["group_s"].get("other", 0.0)
    n = ctx.trace_steps
    return 1e3 * other / n if n and other else None
