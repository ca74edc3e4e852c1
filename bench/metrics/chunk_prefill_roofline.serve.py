"""Bound time over device time of the chunked-prefill attention entry
point (``kernels.ops.chunk_prefill_attention``), counted by
``bench/lib/counts.chunk_prefill``."""
from bench.lib import roofline

OPS = ("chunk_prefill_attention",)


def read(ctx):
    return roofline.share(ctx, "chunk_prefill_attention", "chunk_prefill")
