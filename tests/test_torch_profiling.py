"""utils/profiling.py on the CPU: Timer, benchmark and trace (the card's
checks are chip_smoke.py's `profiling` phase)."""

import json
import time

import pytest
import torch

from mr_mt3_tpu_torch.utils import profiling


def test_timer_records_each_measure():
    timer = profiling.Timer()
    x = torch.ones(4)
    for pause in (0.02, 0.01):
        with timer.measure(sync_value={'out': [x]}):
            time.sleep(pause)
    assert len(timer.times) == 2
    assert timer.best == min(timer.times) >= 0.01
    assert timer.mean == pytest.approx(sum(timer.times) / 2)
    assert timer.times[0] >= 0.02


def test_benchmark_warms_up_and_returns_the_jax_keys():
    calls = []

    def fn(a, b):
        calls.append(1)
        time.sleep(0.005)
        return (a @ b, None)
    a = torch.ones(8, 8)
    out = profiling.benchmark(fn, a, a, warmup=2, iters=4)
    assert set(out) == {'best_s', 'mean_s', 'times'}
    assert len(calls) == 6 and len(out['times']) == 4
    assert out['best_s'] == min(out['times']) >= 0.005
    assert out['mean_s'] >= out['best_s']


def test_wait_for_finds_the_first_tensor(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, 'synchronize',
                        lambda device=None: seen.append(device))
    profiling.wait_for([None, {'a': torch.ones(1)}])
    profiling.wait_for(3.0)
    assert seen == []        # CPU tensors and non-tensors need no wait


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / 'prof')) as prof:
        (a @ a).sum()
    names = {e.key for e in prof.key_averages()}
    assert 'aten::mm' in names
    trace = json.loads((tmp_path / 'prof' / 'trace.json').read_text())
    assert any(e.get('name') == 'aten::mm' for e in trace['traceEvents'])
