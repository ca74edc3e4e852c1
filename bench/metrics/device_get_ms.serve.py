"""Mean host time a pod step waited on its readback in the measured window:
the program's ``serve_step_device_get_seconds``, sum over count over every
pod."""


def read(ctx):
    s, n = ctx.registry.get("serve_step_device_get_seconds", (0.0, 0))
    return 1e3 * s / n if n else None
