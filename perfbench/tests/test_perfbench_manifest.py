"""BENCHMARK.json against the benchmark's contract, and each entry's files:
names and units of the allowed characters, every configuration, traffic
mix and per-layer metric a file found by its name."""

import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PERFBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PERFBENCH)

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./\-]{1,200}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


@pytest.fixture(scope='module')
def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def one_line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level_keys(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= bench['run_seconds'] <= 51
    assert isinstance(bench['run_seconds'], int)
    assert 1 <= len(bench['paths']) <= 16
    for p in bench['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
        assert not p.endswith('_torch')
    assert len(bench['command']) <= 32
    assert all(one_line(w) for w in bench['command'])
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 65536


def test_names_and_units(bench):
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [e['name'] for e in bench[group]]
        assert len(names) == len(set(names)), group
        for name in names:
            assert NAME.match(name), name
    for m in bench['end_to_end'] + bench['per_layer']:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
        assert m['source'] in SOURCES
    for c in bench['workloads']:
        assert NAME.match(c['config']) and NAME.match(c['traffic'])
        assert one_line(c['why']) and c['chips'] in (1, 4)


@pytest.mark.parametrize('group,keys', [
    ('configs', {'name', 'source', 'file', 'reduced', 'why'}),
    ('workloads', {'name', 'config', 'traffic', 'chips', 'why'}),
])
def test_entry_keys(bench, group, keys):
    for e in bench[group]:
        assert set(e) == keys, e['name']


def test_configs_have_files(bench):
    used = {c['config'] for c in bench['workloads']}
    files = set()
    for c in bench['configs']:
        assert c['name'] in used
        assert c['file'].startswith('perfbench/')
        assert c['file'] not in files
        files.add(c['file'])
        assert one_line(c['source']) and one_line(c['why'])
        assert len(c['reduced']) <= 16
        with open(os.path.join(ROOT, c['file'])) as f:
            conf = json.load(f)
        for key in ('program_config', 'program_overrides', 'sizes', 'tier',
                    'dtype', 'limits', 'assumed'):
            assert key in conf, (c['name'], key)


def test_metrics(bench):
    e2e = {m['name'] for m in bench['end_to_end']}
    assert 'setup_s' in e2e
    cells = {c['name'] for c in bench['workloads']}
    for m in bench['end_to_end']:
        assert 0 < m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
        assert set(m.get('workloads', cells)) <= cells
    for m in bench['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in e2e and one_line(m['layer'])
        moved = next(e for e in bench['end_to_end'] if e['name'] == m['moves'])
        assert set(m['workloads']) <= set(moved.get('workloads', cells))
        assert os.path.exists(os.path.join(PERFBENCH, 'metrics',
                                           m['name'] + '.py'))
    for cell in cells:
        reports = [m for m in bench['end_to_end']
                   if cell in m.get('workloads', cells)]
        assert len(reports) >= 2, cell
        assert any(cell in m['workloads'] for m in bench['per_layer']), cell


def test_traffic_files(bench):
    for c in bench['workloads']:
        path = os.path.join(PERFBENCH, 'traffic', c['traffic'] + '.json')
        with open(path) as f:
            mix = json.load(f)
        assert mix['kind'] in ('open_http', 'closed_calls')
        for key in ('seconds_range', 'batch_size', 'judge_segments',
                    'judge_min_steps'):
            assert key in mix, (c['traffic'], key)


def test_four_chip_share(bench):
    four = sum(1 for c in bench['workloads'] if c['chips'] == 4)
    assert four <= max(1, len(bench['workloads']) // 4)


def test_run_seconds_fit_full_check(bench):
    # 24 cells: 2 + 14 x 24 runs, each run_seconds + 60, each cell 180 s
    # of compilation, 1200 s spare, within 43200 s
    rs = bench['run_seconds']
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
