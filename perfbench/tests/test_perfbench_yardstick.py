"""The yardstick reproduces the bounds of the port's kernel table (PERF.md
§6), the trace reduction counts busy time and names idle gaps, and the
traffic generator gives every seed the same work."""

import numpy as np
import pytest

from perfbench import core, trace, traffic, yardstick

MT3 = {'num_decoder_layers': 8, 'd_model': 512, 'num_heads': 6, 'd_kv': 64,
       'd_ff': 1024, 'vocab_size': 1536, 'num_layers': 8, 'mel_bins': 512,
       'frames': 256, 'max_length': 1024, 'segmem_length': 64,
       'segmem_num_layers': 1}


@pytest.mark.parametrize('tier,ms,by', [
    ('fused_int4', 0.0144, 'bytes'),
    ('fused', 0.0269, 'bytes'),
    ('fused_bf16', 0.0513, 'bytes'),
])
def test_window_bound(tier, ms, by):
    # the window at B=8, pos0 992, Lenc 256, 32 steps (PERF.md §6)
    s, bound_by = yardstick.window_bound_s(MT3, 8, 992, 256, 32, tier)
    assert round(s * 1e3, 4) == ms
    assert bound_by == by


def test_attention_bound():
    # the memory encoder's attention forward at B=8, L=1024 (PERF.md §6)
    s, by = yardstick.attention_bound_s(8, 1024, 1024, 6, 64, False)
    assert round(s * 1e3, 4) == 0.0130
    assert by == 'operations'


def test_decode_flops_grow_with_steps():
    a = yardstick.segment_flops(MT3, 512, memory=False)
    b = yardstick.segment_flops(MT3, 1024, memory=False)
    c = yardstick.segment_flops(MT3, 1024, memory=True)
    assert 0 < a < b < c
    # ~52 MFLOP of projections and lm_head a row-step, plus attention
    per_step = (b - a) / 512
    assert 4.5e7 < per_step < 7e7


def test_reduce_events_busy_and_gaps():
    spans = [(0.0, 100.0, 'decode'), (0.0, 200.0, 'transcribe_many')]
    ev = [
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'pb.window',
         'ts': 0.0, 'dur': 200.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'void fw_kernel<2, 0>(Args)',
         'ts': 10.0, 'dur': 50.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'void fw_kernel<2, 0>(Args)',
         'ts': 40.0, 'dur': 40.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'logmel_kernel(Args)',
         'ts': 150.0, 'dur': 10.0},
    ]
    out = trace.reduce_events(ev, spans)
    assert out['window_s'] == pytest.approx(200e-6)
    assert out['busy_s'] == pytest.approx(80e-6)
    assert trace.kernel_seconds(out, 'fw_kernel<') == pytest.approx(90e-6)
    gaps = dict(out['idle_gaps'])
    # 0-10 under the decode span; 80-150 (its middle past the decode
    # span) and 160-200 under the call alone
    assert gaps['decode'] == pytest.approx(10e-6)
    assert gaps['transcribe_many'] == pytest.approx(110e-6)
    assert out['device_ops'][0][0] == 'void fw_kernel<2, 0>'


def _mixes(kind):
    names = sorted({c['traffic'] for c in core.manifest()['workloads']})
    return [n for n in names if traffic.load(n)['kind'] == kind]


@pytest.mark.parametrize('name', _mixes('closed_calls'))
def test_closed_loop_schedule_is_the_seeds_alike(name):
    """A closed loop's window covers only the start of its pool: every
    seed sends the same lengths in the same order."""
    mix = traffic.load(name)
    first, due = traffic.schedule(mix, 1, 51.0)
    assert due is None and len(first) == mix['pool']
    for seed in (2, 2 ** 31 + 12345):
        assert (traffic.schedule(mix, seed, 51.0)[0] == first).all()


@pytest.mark.parametrize('name', _mixes('open_http'))
def test_open_loop_sends_one_multiset(name):
    """An open loop sends its whole schedule: the seed reorders the
    lengths and the gaps, and changes neither multiset."""
    mix = traffic.load(name)
    a, due_a = traffic.schedule(mix, 1, 51.0)
    b, due_b = traffic.schedule(mix, 2 ** 31 + 12345, 51.0)
    assert sorted(a) == sorted(b) and not (a == b).all()
    np.testing.assert_allclose(np.sort(np.diff(due_a, prepend=0.0)),
                               np.sort(np.diff(due_b, prepend=0.0)),
                               atol=1e-9)
