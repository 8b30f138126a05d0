"""pad_share.serve: Percent of the decode calls' row slots that held no audio segment."""

from perfbench.readers import pad_share


def read(ctx):
    return pad_share(ctx)
