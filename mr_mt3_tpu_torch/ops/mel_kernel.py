"""Fused log-mel spectrogram on the card (port of
mr_mt3_tpu/ops/mel_pallas.py).

logmel launches the hand-written CUDA kernel csrc/logmel.cu, which
replaces the TPU kernel mel_pallas.py::logmel_pallas: framing (hop 128
inside the 2048 window, pad_end), the Hann window, a real FFT of each
frame in shared memory in f32, the magnitude, the mel projection over each
filter's nonzero bins and safe_log (eps 1e-5), in one launch, the (frames,
1025) spectrum never written to device memory. Its tables
(_fft_constants: twiddles and window computed in float64 and stored as
f32, the filterbank's nonzero ranges) are uploaded once per device. It
takes CUDA tensors only and raises for any other: its plain version is
audio/frontend.py::compute_logmel (torch FFT), which
infer/handler.py::_compute_mel runs on the CPU. The two differ by the FFTs'
rounding: ~1e-4 in log space where the log-mel is above -4, more in the
noise-floor bins.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mr_mt3_tpu_torch.audio.frontend import (
    SpectrogramConfig,
    _hann_periodic,
    mel_filterbank,
)
from mr_mt3_tpu_torch.ops.cuda_build import check_operand

_K_TILE = 128
EPS = 1e-5

KERNEL = 'logmel'
# launches of the CUDA kernel; only the kernel path adds to them
LAUNCHES = {KERNEL: 0}


@functools.lru_cache(maxsize=4)
def _dft_constants(config: SpectrogramConfig):
    """(cos, -sin, fbank) padded so the bin axis is a multiple of _K_TILE
    (a copy of mel_pallas.py::_dft_constants): numpy in float64, then
    float32."""
    n = config.fft_size
    bins = n // 2 + 1
    padded = ((bins + _K_TILE - 1) // _K_TILE) * _K_TILE
    k = np.arange(bins)
    t = np.arange(n)
    angle = 2.0 * np.pi * np.outer(t, k) / n
    window = _hann_periodic(n).astype(np.float64)
    cos_m = np.cos(angle) * window[:, None]
    sin_m = -np.sin(angle) * window[:, None]
    cos_m = np.pad(cos_m, [(0, 0), (0, padded - bins)]).astype(np.float32)
    sin_m = np.pad(sin_m, [(0, 0), (0, padded - bins)]).astype(np.float32)
    fbank = mel_filterbank(
        num_mel_bins=config.num_mel_bins,
        num_spectrogram_bins=bins,
        sample_rate=config.sample_rate,
        lo_hz=config.mel_lo_hz,
        hi_hz=config.mel_hi_hz,
        style=config.filterbank_style)
    fbank = np.pad(fbank, [(0, padded - bins), (0, 0)]).astype(np.float32)
    return cos_m, sin_m, fbank


@functools.lru_cache(maxsize=4)
def _fft_constants(config: SpectrogramConfig):
    """The kernel's tables: twiddles (fft/2 + 1, 2) (cos, -sin)(2 pi k /
    fft) and the periodic Hann window (fft,), computed in float64 and
    stored as f32; and each mel filter's range of nonzero bins, from the
    first to the last nonzero of its column of _dft_constants' filterbank:
    (lo, len, offset) int32 (mel,) each, and the ranges' weights f32, one
    filter after another."""
    n = config.fft_size
    k = np.arange(n // 2 + 1, dtype=np.float64)
    angle = 2.0 * np.pi * k / n
    twiddle = np.stack([np.cos(angle), -np.sin(angle)], -1).astype(
        np.float32)
    window = _hann_periodic(n)
    fbank = _dft_constants(config)[2]
    lo, length, weights = [], [], []
    for col in fbank.T:
        nz = np.flatnonzero(col)
        first = int(nz[0]) if len(nz) else 0
        count = int(nz[-1]) - first + 1 if len(nz) else 0
        lo.append(first)
        length.append(count)
        weights.append(col[first:first + count])
    offset = np.concatenate([[0], np.cumsum(length)[:-1]])
    weights = np.concatenate(weights + [np.zeros(1, np.float32)])
    return (twiddle, window, np.asarray(lo, np.int32),
            np.asarray(length, np.int32), offset.astype(np.int32),
            weights.astype(np.float32))


@functools.lru_cache(maxsize=8)
def _device_constants(config: SpectrogramConfig, device: torch.device):
    return tuple(torch.from_numpy(np.ascontiguousarray(c)).to(device)
                 for c in _fft_constants(config))


def _library():
    from mr_mt3_tpu_torch.ops import cuda_build
    lib = cuda_build.load(KERNEL)
    if lib.logmel_launch.argtypes is None:
        lib.logmel_launch.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        lib.logmel_launch.restype = ctypes.c_int
        lib.logmel_error_string.argtypes = [ctypes.c_int]
        lib.logmel_error_string.restype = ctypes.c_char_p
    return lib


def logmel(samples: torch.Tensor,
           config: SpectrogramConfig = SpectrogramConfig()) -> torch.Tensor:
    """samples (B, n) f32 on the card -> log-mel (B, ceil(n / hop),
    num_mel_bins) f32, on the current stream. Same contract as
    mel_pallas.py::logmel_pallas: hop-aligned segment audio, pad_end
    framing. The kernel takes hop 128, fft_size 2048 and at most 512 mel
    bins: its launcher refuses others."""
    if samples.dim() != 2:
        raise ValueError('logmel expects (batch, samples)')
    if samples.dtype != torch.float32:
        raise ValueError(f'logmel takes float32 samples, not '
                         f'{samples.dtype}')
    if not samples.is_cuda:
        raise ValueError(f'logmel runs on a CUDA tensor, not on '
                         f'{samples.device}: compute_logmel is its plain '
                         f'version')
    dev = samples.device
    b, n = samples.shape
    check_operand('samples', samples, torch.float32, (b, n), dev)
    lib = _library()
    tables = _device_constants(config, dev)
    hop, fft, mel = config.hop_width, config.fft_size, config.num_mel_bins
    frames = -(-n // hop)
    out = torch.empty((b, frames, mel), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.logmel_launch(samples.data_ptr(),
                               *(t.data_ptr() for t in tables),
                               out.data_ptr(), b, n, hop, fft, frames, mel,
                               EPS, stream)
    if rc != 0:
        raise RuntimeError(f'{KERNEL} launch failed for hop {hop}, fft_size '
                           f'{fft}, {mel} mel bins: '
                           + lib.logmel_error_string(rc).decode())
    LAUNCHES[KERNEL] += 1
    return out
