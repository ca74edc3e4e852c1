"""Mean host time a pod step spent between admission and its dispatch in the
measured window (scheduling the chunk, uploading the host mirrors): the
program's ``serve_step_prepare_seconds``, sum over count over every pod."""


def read(ctx):
    s, n = ctx.registry.get("serve_step_prepare_seconds", (0.0, 0))
    return 1e3 * s / n if n else None
