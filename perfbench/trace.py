"""The traced run: torch.profiler over the measured window, reduced to the
device's busy time, kernel time by name, and the longest device
operations and idle gaps, each gap named by the innermost of the
benchmark's own spans open at its middle. The spans are taken on the host
clock from whichever thread makes the call and placed on the trace's clock
by the window's own annotation."""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
WINDOW_SPAN = 'pb.window'


class Tracer:
    """Spans of one run (only while on) and the profiler around its
    window."""

    def __init__(self, on: bool):
        self.on = on
        self.spans = []
        self._lock = threading.Lock()
        self.summary = {}

    @contextmanager
    def _timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.spans.append((t0, t1, name))

    def span(self, name: str):
        """A named host span (nothing when tracing is off)."""
        return self._timed(name) if self.on else nullcontext()

    @contextmanager
    def profiled(self):
        """Profile the block when on; the reduction lands in .summary."""
        if not self.on:
            yield
            return
        import torch
        from torch.profiler import (
            ProfilerActivity,
            profile,
            record_function,
        )
        cuda = torch.cuda.is_available()
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
            t_window = time.perf_counter()
            with record_function(WINDOW_SPAN):
                yield
            if cuda:
                torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get('traceEvents', [])
        anchor = next((float(e['ts']) for e in events
                       if e.get('name') == WINDOW_SPAN
                       and e.get('cat') == 'user_annotation'), None)
        spans = []
        if anchor is not None:
            off = anchor - t_window * 1e6
            spans = [(t0 * 1e6 + off, t1 * 1e6 + off, name)
                     for t0, t1, name in self.spans]
        self.summary = reduce_events(events, spans)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events, spans=(), top: int = 10) -> dict:
    """Chrome-trace events and spans (start, end, name) on the trace's
    clock (us) -> {'busy_s', 'window_s', 'kernel_s' (by name),
    'device_ops', 'idle_gaps'}. The window runs from the first to the last
    event of the profiled block; busy is the union of the device's
    operations inside it."""
    dev, host = [], []
    for e in events:
        if e.get('ph') != 'X' or 'ts' not in e:
            continue
        s = float(e['ts'])
        end = s + float(e.get('dur', 0.0))
        cat = e.get('cat', '')
        if cat in DEVICE_CATS:
            dev.append((s, end, e.get('name', '')))
        else:
            host.append((s, end))
    if not dev:
        return {'busy_s': 0.0, 'window_s': 0.0, 'kernel_s': {},
                'device_ops': [], 'idle_gaps': []}
    t0 = min([s for s, _, _ in dev] + [s for s, _ in host])
    t1 = max([e for _, e, _ in dev] + [e for _, e in host])
    busy = _merge([(s, e) for s, e, _ in dev])
    kernel_s = defaultdict(float)
    for s, e, name in dev:
        kernel_s[name] += (e - s) * 1e-6
    gaps = []
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for i in range(0, len(edges), 2):
        if edges[i + 1] > edges[i]:
            gaps.append((edges[i], edges[i + 1]))
    named = defaultdict(float)
    for (s, e), name in zip(gaps, _innermost(spans, [(s + e) / 2
                                                     for s, e in gaps])):
        named[name] += (e - s) * 1e-6
    return {
        'busy_s': sum(e - s for s, e in busy) * 1e-6,
        'window_s': (t1 - t0) * 1e-6,
        'kernel_s': dict(kernel_s),
        'device_ops': sorted(([short_name(k), v] for k, v in
                              kernel_s.items()), key=lambda kv: -kv[1])[:top],
        'idle_gaps': sorted(([k, v] for k, v in named.items()),
                            key=lambda kv: -kv[1])[:top],
    }


def _innermost(spans, times):
    """For each of the ascending `times`, the shortest span open at it,
    or 'no span' (one sweep over the spans by start)."""
    spans = sorted(spans)
    out, active, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            active.append(spans[i])
            i += 1
        active = [sp for sp in active if sp[1] >= t]
        best = min(active, key=lambda sp: sp[1] - sp[0], default=None)
        out.append('no span' if best is None else best[2])
    return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    cut = name.find('(')
    return (name[:cut] if cut > 0 else name)[:120]


def kernel_seconds(summary: dict, needle: str) -> float:
    """Device seconds of the kernels whose name holds `needle`."""
    return sum(v for k, v in summary.get('kernel_s', {}).items()
               if needle in k)
