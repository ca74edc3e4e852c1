"""The served model FLOPs of the measured window (a traced run measures
its window untraced, then traces) over the chip's bf16 peak: the whole
prompt's forward for each request whose first token streamed in the
window, and one decode forward for each later token streamed in it,
each 2 · N a token (N without the input embedding table) plus causal
attention's QKᵀ and PV products at its position; over the window's
seconds times the peak."""
from bench.lib import counts


def read(ctx):
    cfg = ctx.cfg
    N = counts.dense_params(ctx.layout, cfg)
    flops = 0.0
    for s in ctx.sent:
        for idx, t in s.streamed:
            if not ctx.t0 < t <= ctx.t1:
                continue
            if idx == 0:
                flops += counts.forward_flops(N, cfg, 0, s.prompt)
            else:
                flops += counts.forward_flops(N, cfg, s.prompt + idx - 1, 1)
    if not flops:
        return None
    return 100.0 * flops / (ctx.window_s * ctx.peaks["bf16_flops"])
