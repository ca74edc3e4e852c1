"""The training step's model FLOPs over the chip's bf16 peak: 6 · N ·
tokens (N the parameters a token passes through, the input embedding
table and the unchosen routed experts left out) plus causal attention's
QKᵀ and PV products, forward and backward (three times the forward's),
of every step of the measured window (a traced run measures its window
untraced, then traces), over the window's seconds times the peak.
Recomputation under remat is not counted."""
from bench.lib import counts


def read(ctx):
    cfg, mix = ctx.cfg, ctx.mix
    B, S = mix["batch"], mix["seq_len"]
    N = counts.dense_params(ctx.layout, cfg)
    per_step = 6.0 * N * B * S + 3 * B * counts.attn_flops(cfg, 1) * \
        counts.causal_pairs(0, S)
    return 100.0 * ctx.steps * per_step / (ctx.window_s *
                                           ctx.peaks["bf16_flops"])
