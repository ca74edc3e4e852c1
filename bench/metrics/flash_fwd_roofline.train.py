"""Bound time over device time of the flash forward entry point
(``kernels.ops._flash_fwd``, recomputed forwards included): the bound of a
call is the larger of its FLOPs over the bf16 peak and its bytes, read and
written once, over HBM bandwidth (``bench/lib/counts.flash_fwd``)."""
from bench.lib import roofline

OPS = ("_flash_fwd",)


def read(ctx):
    return roofline.share(ctx, "_flash_fwd", "flash_fwd")
