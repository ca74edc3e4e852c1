"""Mean time a request waited from submission to admission in the measured
window: the program's ``serve_request_queued_seconds`` histogram, sum over
count, over every pod."""


def read(ctx):
    s, n = ctx.registry.get("serve_request_queued_seconds", (0.0, 0))
    return 1e3 * s / n if n else None
