"""Mean host time a pod step spent admitting from its waiting queue in the
measured window (block reservation, prefix match, the chunk carry's
preparation): the program's ``serve_step_admit_seconds``, sum over count
over every pod."""


def read(ctx):
    s, n = ctx.registry.get("serve_step_admit_seconds", (0.0, 0))
    return 1e3 * s / n if n else None
