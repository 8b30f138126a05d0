"""ctypes wrapper for the native FLAC codec (copy of
mr_mt3_tpu/native/flac.py; the C++ is native/flac.cc, built by g++ at first
use, see native/_loader.py).

The decoder parses untrusted input (the server's request bodies): a
malformed stream raises ValueError. A codec that cannot be built raises
RuntimeError with the compiler's message.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np

from mr_mt3_tpu_torch.native import _loader


class _FlacAudio(ctypes.Structure):
    _fields_ = [
        ('samples', ctypes.POINTER(ctypes.c_int32)),
        ('n_samples', ctypes.c_int64),
        ('sample_rate', ctypes.c_int32),
        ('channels', ctypes.c_int32),
        ('bits', ctypes.c_int32),
    ]


class _FlacBytes(ctypes.Structure):
    _fields_ = [
        ('data', ctypes.POINTER(ctypes.c_uint8)),
        ('size', ctypes.c_int64),
    ]


def _configure(lib: ctypes.CDLL) -> None:
    lib.mt3_flac_decode.restype = ctypes.c_int
    lib.mt3_flac_encode.restype = ctypes.c_int


LIBRARY = _loader.LazyNativeLib('flac.cc', _configure)


def flac_available() -> bool:
    return LIBRARY.available()


def decode_flac_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """FLAC bytes -> (float32 interleaved (n, channels), sample_rate)."""
    lib = LIBRARY.load()
    buf = np.frombuffer(data, dtype=np.uint8)
    audio = _FlacAudio()
    rc = lib.mt3_flac_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(buf)), ctypes.byref(audio))
    if rc != 0:
        raise ValueError('invalid or unsupported FLAC stream')
    try:
        flat = np.ctypeslib.as_array(audio.samples,
                                     shape=(audio.n_samples,)).copy()
    finally:
        lib.mt3_flac_free(ctypes.byref(audio))
    scale = float(1 << (audio.bits - 1))
    out = (flat.astype(np.float32) / scale).reshape(-1, audio.channels)
    return out, int(audio.sample_rate)


def read_flac(path) -> Tuple[np.ndarray, int]:
    """Read a FLAC file -> (float32 mono samples, sample_rate)."""
    with open(path, 'rb') as f:
        data = f.read()
    samples, sr = decode_flac_bytes(data)
    return samples.mean(axis=1), sr


def encode_flac_bytes(samples: np.ndarray, sample_rate: int,
                      bits: int = 16, force_mode: int = -1,
                      mid_side: bool = False) -> bytes:
    """int samples (n,) or (n, channels) -> FLAC bytes.

    force_mode: -1 auto (fixed order<=2), 0-4 fixed order, 100+o LPC order o.
    """
    lib = LIBRARY.load()
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    n, channels = samples.shape
    flat = np.ascontiguousarray(samples.reshape(-1), dtype=np.int32)
    out = _FlacBytes()
    rc = lib.mt3_flac_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n), ctypes.c_int32(channels),
        ctypes.c_int32(sample_rate), ctypes.c_int32(bits),
        ctypes.c_int32(force_mode), ctypes.c_int32(1 if mid_side else 0),
        ctypes.byref(out))
    if rc != 0:
        raise ValueError('flac encode failed')
    try:
        data = bytes(np.ctypeslib.as_array(out.data, shape=(out.size,)))
    finally:
        lib.mt3_flac_bytes_free(ctypes.byref(out))
    return data


def build_flac_fuzz() -> Path:
    """The ASan+UBSan fuzz executable of the decoder (native/flac_fuzz.cc
    with flac.cc; the JAX Makefile's flac_fuzz target), built into _build/
    at first use. Run it as `<path> <iterations>`: it prints 'fuzz ok' and
    exits 0 unless a sanitizer reports."""
    return _loader.compile_cxx('flac_fuzz', ['flac_fuzz.cc', 'flac.cc'],
                               _loader.FUZZ_FLAGS, suffix='')

