"""An entry point's share of its roofline over a traced window: the sum
over its calls of each call's bound time (the larger of its FLOPs over the
bf16 peak and its bytes over HBM bandwidth) over the device time under its
``bench.op.<name>`` ranges. None where it was not called or no device time
was found under it."""
from bench.lib import counts


def share(ctx, op: str, counter: str):
    calls = ctx.calls.get(op) or []
    device_s = ctx.trace["range_s"].get(op, 0.0)
    if not calls or device_s <= 0:
        return None
    count = getattr(counts, counter)
    bound = 0.0
    for c in calls:
        flops, data = count(c)
        bound += max(flops / ctx.peaks["bf16_flops"],
                     data / ctx.peaks["hbm_bytes"])
    return 100.0 * bound / device_s
