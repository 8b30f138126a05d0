"""window_roofline.batch: The greedy window kernel's least time over its device time, percent."""

from perfbench.readers import window_roofline


def read(ctx):
    return window_roofline(ctx)
