"""device_idle.batch: Percent of the traced window with no device operation running."""

from perfbench.readers import device_idle


def read(ctx):
    return device_idle(ctx)
