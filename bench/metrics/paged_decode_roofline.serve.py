"""Bound time over device time of the paged decode attention entry point
(``kernels.ops.paged_decode_attention``), counted by
``bench/lib/counts.paged_decode``."""
from bench.lib import roofline

OPS = ("paged_decode_attention",)


def read(ctx):
    return roofline.share(ctx, "paged_decode_attention", "paged_decode")
