"""Bound time over device time of the flash backward entry point
(``kernels.ops._flash_bwd``), counted by ``bench/lib/counts.flash_bwd``."""
from bench.lib import roofline

OPS = ("_flash_bwd",)


def read(ctx):
    return roofline.share(ctx, "_flash_bwd", "flash_bwd")
