"""Mean time a pod step spent in Python's garbage collector in the measured
window: the program's ``serve_step_gc_seconds``, sum over count over every
pod."""


def read(ctx):
    s, n = ctx.registry.get("serve_step_gc_seconds", (0.0, 0))
    return 1e3 * s / n if n else None
