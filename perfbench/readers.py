"""The reductions behind the per-layer metrics, each from what a traced run
recorded (perfbench/core.py's Context): the server's /healthz counts, the
decode calls and songs the wrappers saw, and the profiler's summary. Each
returns a number, or None where the run gives it nothing to read; a share
of a roofline or a peak is never read as 0 for want of a kernel."""

from __future__ import annotations

from perfbench import trace, yardstick

# the kernels by the names the card's trace gives them
WINDOW_KERNEL = 'fw_kernel<'
ATTN_FWD_KERNEL = 'faf_kernel<'
WINDOW = 32


def songs_per_batch(ctx):
    """Requests answered over transcribe_many calls of the server's
    MicroBatcher in the window (/healthz, after minus before)."""
    before, after = ctx.healthz
    if before is None or after is None:
        return None
    batches = after['batches'] - before['batches']
    if batches <= 0:
        return None
    return (after['requests'] - before['requests']) / batches


def pad_share(ctx):
    """Percent of the decode calls' row slots (rows x chain positions)
    that held no segment of audio."""
    slots = sum(c['rows'] * c['positions'] for c in ctx.calls)
    real = sum(len(s['tokens']) for s in ctx.songs)
    if slots <= 0:
        return None
    return 100.0 * (1.0 - real / slots)


def decode_mfu(ctx):
    """Percent of the bf16 dense peak that the real segments' model FLOPs
    (encoder, memory encoder, the decode of the steps each decoded) make
    over the traced window."""
    window = ctx.trace.get('window_s', 0.0)
    if window <= 0 or not ctx.songs:
        return None
    memory = bool(ctx.sizes.get('segmem_length'))
    flops = sum(yardstick.segment_flops(ctx.sizes, ctx.steps_of(row, ctx.eos),
                                        memory)
                for s in ctx.songs for row in s['tokens'])
    return 100.0 * flops / (window * yardstick.PEAKS['bf16_flops'])


def _call_windows(ctx, call):
    """(rows, pos0) of each window launch of a decode call: per chain
    position, the windows until every row has finished."""
    out = []
    for p in range(call['positions']):
        toks = call['tokens'] if call['tokens'].ndim == 2 \
            else call['tokens'][:, p]
        steps = max((ctx.steps_of(toks[r], ctx.eos)
                     for r in range(call['real_rows'])), default=0)
        out += [(call['rows'], w) for w in range(0, steps, WINDOW)]
    return out


def window_roofline(ctx):
    """Percent of the window kernel's device time that its least time
    (yardstick.window_bound_s of each launch's rows and position) is."""
    t = trace.kernel_seconds(ctx.trace, WINDOW_KERNEL)
    if t <= 0:
        return None
    lenc = ctx.sizes['frames'] + (ctx.sizes.get('segmem_length') or 0)
    bound = sum(yardstick.window_bound_s(ctx.sizes, rows, pos0, lenc,
                                         WINDOW, ctx.config['tier'])[0]
                for c in ctx.calls for rows, pos0 in _call_windows(ctx, c))
    return 100.0 * bound / t


def attn_fwd_roofline(ctx):
    """Percent of the attention forward kernel's device time that its
    least time is: the memory encoder's attention over max_length tokens
    for every row of every chain position of the segment-memory calls."""
    t = trace.kernel_seconds(ctx.trace, ATTN_FWD_KERNEL)
    if t <= 0:
        return None
    s = ctx.sizes
    length = s['max_length']
    bound = sum(yardstick.attention_bound_s(c['rows'], length, length,
                                            s['num_heads'], s['d_kv'],
                                            False)[0] * c['positions']
                for c in ctx.calls if c['kind'] == 'segmem')
    return 100.0 * bound / t


def device_idle(ctx):
    """Percent of the traced window in which no device operation ran."""
    window = ctx.trace.get('window_s', 0.0)
    if window <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace['busy_s'] / window)
