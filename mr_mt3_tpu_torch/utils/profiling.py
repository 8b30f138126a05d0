"""Profiling and timing helpers (port of mr_mt3_tpu/utils/profiling.py).

`trace(logdir)` records a region with torch.profiler (CPU ops and, on the
card, CUDA kernels) and writes a Chrome trace, `<logdir>/trace.json`
(chrome://tracing or Perfetto). `Timer` and `benchmark` take wall-clock
times that wait for the card: a CUDA tensor's device is synchronized
before the clock is read, as the JAX helpers wait for the device by
copying a result to the host.

The JAX module's enable_compilation_cache and honor_platform_env are not
ported: PyTorch compiles no XLA programs to cache, and the port takes its
device from the caller (`device=`), not from JAX_PLATFORMS.

In one process torch.profiler has lost kernel events after some 30-40
sessions on the H100 (PERF.md), so a check should not rest on a trace
alone: Timer, benchmark or CUDA events give the times.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Any, Callable, Iterator

import torch


def _first_tensor(value: Any):
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for item in value:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def wait_for(value: Any) -> None:
    """Block until the device holding `value` (a tensor, or the first
    tensor of a dict, list or tuple) has finished its queued work; a CPU
    tensor or a non-tensor needs no wait."""
    t = _first_tensor(value)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the region, CUDA activity included where a card
    is present; writes <logdir>/trace.json when the region ends. Yields
    the profiler (its key_averages() and events())."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


class Timer:
    """Wall-clock timer; measure(sync_value) waits for the device holding
    sync_value before reading the clock."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, sync_value: Any = None):
        t0 = time.perf_counter()
        yield
        wait_for(sync_value)
        self.times.append(time.perf_counter() - t0)

    @property
    def best(self) -> float:
        return min(self.times)

    @property
    def mean(self) -> float:
        return statistics.fmean(self.times)


def benchmark(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> dict:
    """Run fn(*args) `warmup` times, then `iters` timed times, each waiting
    for fn's result on its device: {'best_s', 'mean_s', 'times'}."""
    for _ in range(warmup):
        wait_for(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        wait_for(fn(*args))
        times.append(time.perf_counter() - t0)
    return {'best_s': min(times), 'mean_s': statistics.fmean(times),
            'times': times}
