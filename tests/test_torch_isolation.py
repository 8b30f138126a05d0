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


# modules the training slice added, with their own copies of the JAX
# package's host-only layers; the parametrization below reads the tree, and
# test_sources_cover_the_training_modules holds it to include them
TRAINING_MODULES = ('train/__init__.py', 'train/__main__.py',
                    'train/losses.py', 'train/optim.py', 'train/trainer.py',
                    'data/__init__.py', 'data/transforms.py',
                    'data/disk_cache.py', 'data/slakh.py', 'data/commu.py',
                    'data/loader.py', 'midi/reader.py', 'midi/sustain.py',
                    'codec/slakh.py')


# the int8 decode tiers' kernel modules
INT8_TIER_MODULES = ('ops/int8_matmul.py', 'ops/int8_attention.py')

# the evaluation slice's modules and the log-mel kernel's
EVAL_MODULES = ('eval/__init__.py', 'eval/__main__.py', 'eval/evaluate.py',
                'eval/transcription.py', 'infer/scores.py',
                'ops/mel_kernel.py')


# the step and grouped-window kernels' modules
STEP_MODULES = ('ops/fused_decode.py', 'ops/group_axis_kernel.py')


# the native host layer (the FLAC codec, the tokenizer core, their g++
# loader) and the Slakh preparation and leakage scripts
NATIVE_AND_SCRIPT_MODULES = (
    'native/__init__.py', 'native/_loader.py', 'native/flac.py',
    'native/tokenizer.py', 'scripts/__init__.py',
    'scripts/generate_inst_names.py', 'scripts/merge_slakh_midi.py',
    'scripts/resample_slakh.py', 'scripts/instrument_leakage.py')


# the data-parallel axis (meshes of per-card replicas, process groups) and
# the model axis (tensor-parallel shards and their collectives)
PARALLEL_MODULES = ('parallel/__init__.py', 'parallel/mesh.py',
                    'parallel/tensor.py')


# weights from the JAX side (Orbax, T5X) and the last host modules
WEIGHTS_AND_HOST_MODULES = (
    'utils/orbax_read.py', 'scripts/convert_weight.py',
    'models/adversarial.py', 'utils/profiling.py',
    'scripts/convert_nsynth_json_to_midi.py', 'scripts/parse_nsynth_valid.py',
    'scripts/evaluate_nsynth_json.py', 'scripts/commu_const.py',
    'scripts/create_commu_test_split.py', 'scripts/render_commu.py')

# optional packages the port imports only inside the one function that
# needs them, so it imports without them: (package, (module, function))
LAZY_IMPORTS = {
    'tensorstore': {('utils/orbax_read.py', 'read_orbax')},
    'pandas': {('scripts/create_commu_test_split.py', 'main'),
               ('scripts/render_commu.py', 'render_split')},
}


def _covered():
    return {p.relative_to(PORT).as_posix() for p in _port_sources()
            if PORT in p.parents}


def test_sources_cover_the_training_modules():
    assert set(TRAINING_MODULES) <= _covered()


def test_sources_cover_the_int8_tier_modules():
    assert set(INT8_TIER_MODULES) <= _covered()


def test_sources_cover_the_eval_modules():
    assert set(EVAL_MODULES) <= _covered()


def test_sources_cover_the_step_and_grouped_modules():
    assert set(STEP_MODULES) <= _covered()


def test_sources_cover_the_native_and_script_modules():
    assert set(NATIVE_AND_SCRIPT_MODULES) <= _covered()


def test_sources_cover_the_parallel_modules():
    assert set(PARALLEL_MODULES) <= _covered()


def test_sources_cover_the_weights_and_host_modules():
    assert set(WEIGHTS_AND_HOST_MODULES) <= _covered()


def test_optional_packages_are_imported_only_where_needed():
    """tensorstore and pandas are imported by no module at its top level,
    only inside the functions LAZY_IMPORTS names."""
    found = {name: set() for name in LAZY_IMPORTS}
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        rel = (path.relative_to(PORT).as_posix() if PORT in path.parents
               else path.name)
        owners = {}
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in ast.walk(fn):
                    owners.setdefault(id(node), fn.name)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                top = name.split('.')[0]
                if top in found:
                    found[top].add((rel, owners.get(id(node))))
    assert found == LAZY_IMPORTS


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
            'from mr_mt3_tpu_torch.ops import int8_attention, int8_matmul\n'
            'from mr_mt3_tpu_torch.ops import mel_kernel, group_axis_kernel\n'
            'assert not cuda_build._libs\n'
            'for mod in (fused_decode, train_attention, int8_attention,\n'
            '            int8_matmul, mel_kernel, group_axis_kernel):\n'
            '    assert not any(mod.LAUNCHES.values())\n'
            'assert not any(fused_decode.STEP_LAUNCHES.values())\n'
            'assert not any(n.split(".")[0] in ("jax", "mr_mt3_tpu")\n'
            '               for n in sys.modules), "jax imported"\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_importing_native_builds_nothing():
    """Importing the native package and the modules that use it runs no
    compiler and loads no library."""
    code = ('import subprocess, numpy, scipy.signal, torch, yaml\n'
            'def refuse(*a, **k):\n'
            '    raise AssertionError(f"ran {a} at import")\n'
            'subprocess.run = subprocess.Popen = refuse\n'
            'import mr_mt3_tpu_torch.native as n\n'
            'import mr_mt3_tpu_torch.data.transforms, mr_mt3_tpu_torch.serve\n'
            'import mr_mt3_tpu_torch.scripts.resample_slakh\n'
            'assert n.flac.LIBRARY._lib is None\n'
            'assert n.tokenizer.LIBRARY._lib is None\n'
            'assert n.tokenizer.CALLS == 0\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_loader_compiles_only_port_sources_into_build(monkeypatch):
    """Every g++ command the loader gives reads sources of
    mr_mt3_tpu_torch/native/ and writes into mr_mt3_tpu_torch/_build/."""
    from mr_mt3_tpu_torch.native import _loader, flac, tokenizer
    assert _loader.NATIVE_DIR == PORT / 'native'
    assert _loader.BUILD_DIR == PORT / '_build'
    for lib in (flac.LIBRARY, tokenizer.LIBRARY):
        assert lib.path().parent == PORT / '_build'
        assert (PORT / 'native' / lib.source).is_file()
    ran = []

    def recording(cmd, **kw):
        ran.append(cmd)
        Path(cmd[cmd.index('-o') + 1]).write_bytes(b'')
        return subprocess.CompletedProcess(cmd, 0, '', '')
    monkeypatch.setattr(_loader.subprocess, 'run', recording)
    out = _loader.compile_cxx('isolation_check', ['flac_fuzz.cc', 'flac.cc'],
                              ('-fsyntax-only',), suffix='.probe')
    try:
        assert out.parent == PORT / '_build' and out.exists()
    finally:
        out.unlink()
    (cmd,) = ran
    target = Path(cmd[cmd.index('-o') + 1])
    sources = [Path(a) for a in cmd if a.endswith('.cc')]
    assert target.parent == PORT / '_build'
    assert sources == [PORT / 'native' / 'flac_fuzz.cc',
                       PORT / 'native' / 'flac.cc']
    with pytest.raises(ValueError, match='not a source'):
        _loader.command([REPO / 'mr_mt3_tpu' / 'native' / 'flac.cc'],
                        _loader.CXX_FLAGS, out)
    with pytest.raises(ValueError, match='not in'):
        _loader.command([PORT / 'native' / 'flac.cc'], _loader.CXX_FLAGS,
                        REPO / 'mr_mt3_tpu' / 'native' / 'libmt3flac.so')


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


def test_a_mesh_of_cards_raises_without_a_card(no_card):
    """A mesh of cuda devices, made or given, raises as the handler does;
    so do the entry points asked for several cards."""
    from mr_mt3_tpu_torch import parallel, serve
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.Mesh(('cuda:0', 'cuda:0'))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.local_mesh()
    model = MT3(MT3Config(d_model=32, d_kv=8, d_ff=48, num_heads=4,
                          num_encoder_layers=1, num_decoder_layers=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceHandler(model=model,
                         mesh=parallel.make_mesh(devices=['cuda'] * 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build_handler(['devices=2'])
    assert parallel.Mesh(('cpu', 'cpu')).n_data == 2


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


def test_eval_cli_raises_without_a_card(no_card, tmp_path):
    from mr_mt3_tpu_torch.eval.__main__ import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([f'path={tmp_path}/weights', 'eval.exp_tag_name=out',
              f'eval.audio_dir={tmp_path}/*.wav'])


def test_train_cli_raises_without_a_card(no_card):
    from mr_mt3_tpu_torch import train
    for extra in ([], ['devices=2'], ['multihost=true'],
                  ['model_devices=2']):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(['--config-name=config_slakh_segmem',
                        'model=MT3NetSegMemV2WithPrev', 'dataset=SlakhPrev',
                        'eval.audio_dir=null', *extra])
