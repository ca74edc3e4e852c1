"""Mean host time a pod step took to queue the decode half of its dispatch in
the measured window, over the steps that decoded: the program's
``serve_step_decode_dispatch_seconds``, sum over count over every pod."""


def read(ctx):
    s, n = ctx.registry.get("serve_step_decode_dispatch_seconds", (0.0, 0))
    return 1e3 * s / n if n else None
