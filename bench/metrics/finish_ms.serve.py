"""Mean host time a pod step spent from its readback to its return in the
measured window (advancing the slots, retirement, the outputs): the
program's ``serve_step_finish_seconds``, sum over count over every pod."""


def read(ctx):
    s, n = ctx.registry.get("serve_step_finish_seconds", (0.0, 0))
    return 1e3 * s / n if n else None
