"""Build a CUDA source of csrc/ at first use and load it with ctypes.

Each source is compiled on its own, with nvcc, into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

A library with PARTS is compiled as several translation units, one nvcc
each, in parallel, and linked into the one library: the decoder
megakernels' instantiations split so that no single compile sets the
build's time. The hash covers the sources, the headers of csrc/ (*.cuh)
and the flags, so an edited source or header is rebuilt.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

# the sources compiled apart from csrc/<name>.cu and linked into its library
PARTS = {'fused_decode_step': ('fused_decode_step_tiles',),
         'fused_decode_window': ('fused_decode_window_grouped',)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(found):
        raise RuntimeError('nvcc not found: the CUDA kernels are built on '
                           'the machine with the card')
    return found


def sources(name: str, csrc: Path = CSRC_DIR) -> List[Path]:
    """<csrc>/<name>.cu and those of its PARTS that csrc holds (another
    design's sources may have none)."""
    parts = [csrc / f'{n}.cu' for n in PARTS.get(name, ())]
    return [csrc / f'{name}.cu', *(p for p in parts if p.exists())]


def library_path(name: str, flags: Sequence[str] = ()) -> Path:
    src = b''.join(p.read_bytes() for p in sources(name))
    src += b''.join(h.read_bytes() for h in sorted(CSRC_DIR.glob('*.cuh')))
    digest = hashlib.sha256(
        src + ' '.join((*NVCC_FLAGS, *flags)).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}-{digest[:12]}.so'


def _nvcc(cmd: List[str], what: str) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {what}:\n{proc.stderr}')
    return proc.stdout + proc.stderr


def build(name: str, verbose: bool = False, flags: Sequence[str] = (),
          out: Path = None, csrc: Path = CSRC_DIR) -> Tuple[Path, str]:
    """Compile csrc/<name>.cu (and its PARTS) unless its library exists.
    Returns (path, compiler output); verbose adds -Xptxas -v (registers,
    spills), flags more nvcc flags, out another library path (then always
    rebuilt), csrc another directory of sources with their headers."""
    if out is not None and Path(out).exists():
        Path(out).unlink()
    out = Path(out) if out is not None else library_path(name, flags)
    if out.exists():
        return out, ''
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    extra = [*(('-Xptxas', '-v') if verbose else ()), *flags]
    srcs = sources(name, Path(csrc))
    if len(srcs) == 1:
        log = _nvcc([nvcc_path(), *NVCC_FLAGS, *extra, '-o', str(tmp),
                     str(srcs[0])], srcs[0].name)
        os.replace(tmp, out)
        return out, log
    compile_flags = [f for f in NVCC_FLAGS if f != '-shared']
    objs = [out.with_suffix(f'.{i}.{os.getpid()}.o')
            for i in range(len(srcs))]
    with ThreadPoolExecutor(len(srcs)) as pool:
        logs = list(pool.map(
            lambda so: _nvcc([nvcc_path(), *compile_flags, *extra, '-c',
                              '-o', str(so[1]), str(so[0])], so[0].name),
            zip(srcs, objs)))
    logs.append(_nvcc([nvcc_path(), *NVCC_FLAGS, '-o', str(tmp),
                       *map(str, objs)], f'linking {name}'))
    for o in objs:
        o.unlink()
    os.replace(tmp, out)
    return out, ''.join(logs)


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
