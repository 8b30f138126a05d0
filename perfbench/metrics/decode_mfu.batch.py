"""decode_mfu.batch: The real segments' model FLOPs over the traced window, percent of the bf16 peak."""

from perfbench.readers import decode_mfu


def read(ctx):
    return decode_mfu(ctx)
