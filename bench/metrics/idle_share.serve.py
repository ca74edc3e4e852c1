"""Share of the traced serving window in which no kernel ran on the
device (the profiler's timeline)."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1 - t["busy_s"] / t["window_s"]) if t["busy_s"] else None
