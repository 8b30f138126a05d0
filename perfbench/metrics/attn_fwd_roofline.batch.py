"""attn_fwd_roofline.batch: The attention forward kernel's least time over its device time, percent."""

from perfbench.readers import attn_fwd_roofline


def read(ctx):
    return attn_fwd_roofline(ctx)
