"""The port stands alone: no JAX and nothing of mr_mt3_tpu in the package
or in chip_smoke.py, nothing built at import time, and no entry point that
runs on the CPU unless the caller asks for it."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / 'mr_mt3_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'mr_mt3_tpu',
             'tests', 'serve', 'bench', 'train', 'test')


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module


def _port_sources():
    # _build/ holds build outputs (gitignored), not the port's sources
    return sorted(p for p in PORT.rglob('*.py')
                  if '_build' not in p.relative_to(PORT).parts) \
        + [REPO / 'chip_smoke.py']


@pytest.mark.parametrize('path', _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_jax_package_imports(path):
    bad = [(line, name) for line, name in _imported_modules(path)
           if name.split('.')[0] in FORBIDDEN]
    assert not bad, f'{path.relative_to(REPO)} imports {bad}'


def test_importing_the_port_builds_nothing():
    """Every module imports on a machine without nvcc or a card, and no
    kernel library is loaded by importing."""
    code = ('import importlib, pkgutil, sys; import mr_mt3_tpu_torch as p\n'
            'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
            '    importlib.import_module(m.name)\n'
            'from mr_mt3_tpu_torch.ops import cuda_build, fused_decode\n'
            'from mr_mt3_tpu_torch.ops import train_attention\n'
            'assert not cuda_build._libs\n'
            'assert not any(fused_decode.LAUNCHES.values())\n'
            'assert not any(train_attention.LAUNCHES.values())\n'
            'assert not any(n.split(".")[0] in ("jax", "mr_mt3_tpu")\n'
            '               for n in sys.modules), "jax imported"\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_handler_raises_without_a_card(no_card):
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    model = MT3(MT3Config(d_model=32, d_kv=8, d_ff=48, num_heads=4,
                          num_encoder_layers=1, num_decoder_layers=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceHandler(model=model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceHandler(model=model, device='cuda')
    assert InferenceHandler(model=model, device='cpu').device.type == 'cpu'


def test_build_handler_raises_without_a_card(no_card):
    from mr_mt3_tpu_torch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build_handler([])


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory with nothing else of the repo (and,
    here, no card) exits non-zero and prints no result line."""
    (tmp_path / 'chip_smoke.py').write_bytes(
        (REPO / 'chip_smoke.py').read_bytes())
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
