"""Each cell's run, on the CPU at a tiny size (perfbench/tests/tiny.py),
through core.run: the same path as on the card, the program's kernels in
their plain versions. The control (the reference one precision step
below) and faults planted in the program's timed path must come out not
correct. The test limit, 0.15, lies between the widest gaps at these
sizes (seeds 1-4): sound runs 0 (mt3) and 0-0.020 (mr_mt3, its bf16 model
against the reference's emulation), the control 0.61-2.53."""

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import core
from perfbench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LIMIT = 0.15
SEED = 2 ** 31 + 12345
CELLS = ['mt3.clips-open', 'mr_mt3.songs', 'mr_mt3.clips-batch',
         'mt3.songs-b64']


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def run(cell, traced=False, seed=SEED, control=False, config=None):
    bench = core.manifest()
    _, conf, mix = core.cell_parts(bench, cell)
    patch = tiny.config_patch(conf, LIMIT)
    patch.update(config or {})
    return core.run(cell, seed, 2.0, traced, device='cpu',
                    config_patch=patch, mix_patch=tiny.mix_patch(mix),
                    bench=bench, control=control)


@pytest.mark.parametrize('cell', CELLS)
def test_dry_run(cell):
    res = run(cell)
    assert res['correct'], res['checks']
    assert res['failed'] == 0 and res['attempted'] > 0
    names = {m['name'] for m in core.manifest()['end_to_end']
             if cell in m.get('workloads', [cell])}
    assert set(res['metrics']) == names
    assert res['device']['platform'] == 'cpu'
    assert list(res['checks'])[0] == 'max_logit_gap'


@pytest.mark.parametrize('cell', ['mt3.clips-open', 'mr_mt3.clips-batch'])
def test_traced_run_counts(cell):
    res = run(cell, traced=True)
    assert res['correct'], res['checks']
    # device metrics need the card; the counters are read on the CPU too
    pad = [k for k in res['metrics'] if k.startswith('pad_share')]
    assert pad and 0 <= res['metrics'][pad[0]]['value'] < 100
    assert 'breakdown' in res


@pytest.mark.parametrize('cell', ['mt3.clips-open', 'mr_mt3.clips-batch'])
def test_control_is_not_correct(cell):
    res = run(cell, control=True)
    r = res['readings']
    assert r['max_logit_gap'] <= LIMIT
    assert r['control_max_logit_gap'] > LIMIT


@pytest.fixture
def altered_token(monkeypatch):
    """The window kernel's plain version with one token of every window
    changed where it is produced (every row, the window's sixth step)."""
    from mr_mt3_tpu_torch.ops import fused_decode
    real = fused_decode.fused_decode_window

    def window(cfg, *a, **kw):
        toks, fin, cache = real(cfg, *a, **kw)
        toks = toks.clone()
        toks[:, 5] = (toks[:, 5] + 700) % (cfg.vocab_size - 2) + 2
        return toks, fin, cache
    monkeypatch.setattr(fused_decode, 'fused_decode_window', window)


@pytest.mark.parametrize('cell', ['mt3.clips-open', 'mr_mt3.clips-batch'])
def test_altered_token_is_not_correct(cell, altered_token):
    assert not run(cell)['correct']


def test_memory_not_carried_is_not_correct(monkeypatch):
    """The segment-memory chain left out: every segment decodes from the
    first segment's memory seed."""
    from mr_mt3_tpu_torch.infer import InferenceHandler
    real = InferenceHandler.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.segmem_chain = False
    monkeypatch.setattr(InferenceHandler, '__init__', init)
    assert not run('mr_mt3.songs')['correct']


def test_no_jax_loaded():
    """A run loads neither JAX nor the JAX package (top-level names
    compared whole), in a process of its own."""
    code = (
        'import sys, torch; torch.set_num_threads(2)\n'
        f'sys.path.insert(0, {ROOT!r})\n'
        'from perfbench.tests import test_perfbench_runs as t\n'
        'res = t.run("mt3.clips-open")\n'
        'from perfbench import core\n'
        'print(json.dumps([res["correct"], core.forbidden_modules(),'
        ' "mr_mt3_tpu_torch" in sys.modules]))\n')
    out = subprocess.run([sys.executable, '-c', 'import json\n' + code],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, bad, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and bad == [] and port
