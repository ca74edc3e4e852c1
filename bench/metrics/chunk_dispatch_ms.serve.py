"""Mean host time a pod step took to queue the prefill chunk half of its
dispatch and its first-token pick in the measured window, over the steps
that carried a chunk: the program's ``serve_step_chunk_dispatch_seconds``,
sum over count over every pod."""


def read(ctx):
    s, n = ctx.registry.get("serve_step_chunk_dispatch_seconds", (0.0, 0))
    return 1e3 * s / n if n else None
