"""Build a C++ source of native/ with g++ at first use and load it with
ctypes (the port's counterpart of mr_mt3_tpu/native/_loader.py, modelled on
ops/cuda_build.py rather than on the JAX package's make):

    g++ -O2 -std=c++17 -fPIC -Wall -shared -o _build/lib<name>-<hash>.so \
        native/<name>.cc

The hash covers the sources and the flags, so an edited source is rebuilt.
The compiler writes a temporary file that os.replace moves into place, so
processes building at once (test workers, a run on the card) never load
half a library. _build/ is listed in .gitignore. Nothing is built when a
module is imported. A failed build raises RuntimeError with the compiler's
stderr; the error is kept and raised again by later loads of that library,
so a missing compiler is not asked again for every song.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
NATIVE_DIR = PACKAGE_DIR / 'native'
BUILD_DIR = PACKAGE_DIR / '_build'
# the JAX package's Makefile: CXXFLAGS and -shared
CXX_FLAGS = ('-O2', '-std=c++17', '-fPIC', '-Wall', '-shared')
# its flac_fuzz target: an ASan+UBSan executable
FUZZ_FLAGS = ('-O1', '-g', '-std=c++17', '-fsanitize=address,undefined',
              '-fno-sanitize-recover=all')


def cxx_path() -> str:
    found = shutil.which('g++') or shutil.which('c++')
    if found is None:
        raise RuntimeError('no C++ compiler (g++ or c++) on PATH: the '
                           'native libraries are built at first use')
    return found


def output_path(stem: str, sources: Sequence[Path], flags: Sequence[str],
                suffix: str = '.so') -> Path:
    """_build/<stem>-<hash of the sources and flags><suffix>."""
    digest = hashlib.sha256(
        b''.join(Path(s).read_bytes() for s in sources)
        + ' '.join(flags).encode()).hexdigest()
    return BUILD_DIR / f'{stem}-{digest[:12]}{suffix}'


def command(sources: Sequence[Path], flags: Sequence[str],
            out: Path) -> List[str]:
    """The compiler's command line; every source must be a file of
    native/ and the output a file of _build/."""
    for src in sources:
        if Path(src).resolve().parent != NATIVE_DIR:
            raise ValueError(f'{src} is not a source of {NATIVE_DIR}')
    if Path(out).resolve().parent != BUILD_DIR:
        raise ValueError(f'{out} is not in {BUILD_DIR}')
    return [cxx_path(), *flags, '-o', str(out), *map(str, sources)]


def compile_cxx(stem: str, sources: Sequence[str], flags: Sequence[str],
                suffix: str = '.so') -> Path:
    """Compile native/<sources> into _build/ unless that output exists.
    Returns its path."""
    paths = [NATIVE_DIR / s for s in sources]
    out = output_path(stem, paths, flags, suffix)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f'{out.name}.{os.getpid()}.{threading.get_ident()}.tmp')
    proc = subprocess.run(command(paths, flags, tmp), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'{cxx_path()} failed for '
                           f'{", ".join(sources)}:\n{proc.stderr}')
    os.replace(tmp, out)
    return out


class LazyNativeLib:
    """Builds and loads native/<source> as a shared library on first use.

    configure: called once with the loaded CDLL to set restypes. A build
    or load failure raises RuntimeError, here and at every later load.
    After the first load, built says whether it compiled the library (or
    found it in _build/) and load_seconds what it took, the build included.
    """

    def __init__(self, source: str,
                 configure: Optional[Callable[[ctypes.CDLL], None]] = None):
        self.source = source
        self.stem = 'lib' + Path(source).stem
        self._configure = configure
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._error: Optional[str] = None
        self.built: Optional[bool] = None
        self.load_seconds: Optional[float] = None

    def path(self) -> Path:
        return output_path(self.stem, [NATIVE_DIR / self.source], CXX_FLAGS)

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            if self._error is not None:
                raise RuntimeError(self._error)
            t0 = time.monotonic()
            built = not self.path().exists()
            try:
                path = compile_cxx(self.stem, [self.source], CXX_FLAGS)
                lib = ctypes.CDLL(str(path))
            except (RuntimeError, OSError) as e:
                self._error = f'native library {self.source}: {e}'
                raise RuntimeError(self._error) from e
            self.built, self.load_seconds = built, time.monotonic() - t0
            if self._configure is not None:
                self._configure(lib)
            self._lib = lib
            return lib

    def available(self) -> bool:
        try:
            self.load()
        except RuntimeError:
            return False
        return True
