"""songs_per_batch.serve: Songs a transcribe_many call of the server's MicroBatcher in the window."""

from perfbench.readers import songs_per_batch


def read(ctx):
    return songs_per_batch(ctx)
