"""Build a CUDA source of csrc/ at first use and load it with ctypes.

Each source is compiled on its own, with nvcc, into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The hash covers the source, the headers of csrc/ (*.cuh) and the flags, so
an edited source or header is rebuilt.
_build/ is listed in .gitignore. Nothing is built when a module is
imported: only a launch on a CUDA tensor calls load().
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(found):
        raise RuntimeError('nvcc not found: the CUDA kernels are built on '
                           'the machine with the card')
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f'{name}.cu').read_bytes()
    src += b''.join(h.read_bytes() for h in sorted(CSRC_DIR.glob('*.cuh')))
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}-{digest[:12]}.so'


def build(name: str, verbose: bool = False) -> Tuple[Path, str]:
    """Compile csrc/<name>.cu unless its library exists. Returns (path,
    compiler output); verbose adds -Xptxas -v (registers, spills)."""
    out = library_path(name)
    if out.exists():
        return out, ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [nvcc_path(), *NVCC_FLAGS, *(('-Xptxas', '-v') if verbose else ()),
           '-o', str(tmp), str(CSRC_DIR / f'{name}.cu')]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name}.cu:\n{proc.stderr}')
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _libs:
            path, _ = build(name)
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def check_operand(name: str, t, dtype, shape, device,
                  align: int = 1) -> None:
    """Raise ValueError unless tensor t is what a kernel of csrc/ reads:
    on `device`, of `dtype` (or one of a tuple of dtypes), of `shape`,
    contiguous, its data on an `align`-byte boundary."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype not in dtypes:
        raise ValueError(f'{name} has dtype {t.dtype}, expected '
                         f'{" or ".join(str(d) for d in dtypes)}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                         f'expected {tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    if t.data_ptr() % align:
        raise ValueError(f'{name} must be {align}-byte aligned')
