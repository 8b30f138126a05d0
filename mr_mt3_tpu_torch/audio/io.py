"""WAV reading, writing and resampling without librosa/soundfile (copy of
read_wav_bytes, read_wav, write_wav, read_audio and resample from
mr_mt3_tpu/audio/io.py).

The reference loads audio with librosa (reference: test.py:37,
dataset/dataset_2_random.py:379); arbitrary-rate input is resampled with a
polyphase filter. FLAC is not yet ported: read_audio raises for it.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np
from scipy import signal as _signal


def read_wav(path) -> Tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file -> (float32 samples in [-1, 1], sample
    rate); see read_wav_bytes."""
    with open(path, 'rb') as f:
        data = f.read()
    return read_wav_bytes(data, name=str(path))


def write_wav(path, samples: np.ndarray, sample_rate: int,
              subtype: str = 'PCM_16') -> None:
    """Write mono float samples as PCM_16 / PCM_24 / FLOAT wav."""
    samples = np.asarray(samples, dtype=np.float64)
    if subtype == 'PCM_16':
        payload = (np.clip(samples, -1, 1 - 2**-15) * 32768.0).astype(
            '<i2').tobytes()
        bits, fmt_tag = 16, 1
    elif subtype == 'PCM_24':
        ints = (np.clip(samples, -1, 1 - 2**-23) * 8388608.0).astype(np.int32)
        b = np.zeros((len(ints), 3), dtype=np.uint8)
        b[:, 0] = ints & 0xFF
        b[:, 1] = (ints >> 8) & 0xFF
        b[:, 2] = (ints >> 16) & 0xFF
        payload = b.tobytes()
        bits, fmt_tag = 24, 1
    elif subtype == 'FLOAT':
        payload = samples.astype('<f4').tobytes()
        bits, fmt_tag = 32, 3
    else:
        raise ValueError(f'unsupported subtype: {subtype}')
    byte_rate = sample_rate * bits // 8
    header = (b'RIFF' + struct.pack('<I', 36 + len(payload)) + b'WAVE' +
              b'fmt ' + struct.pack('<IHHIIHH', 16, fmt_tag, 1, sample_rate,
                                    byte_rate, bits // 8, bits) +
              b'data' + struct.pack('<I', len(payload)))
    with open(path, 'wb') as f:
        f.write(header + payload)


def read_audio(path) -> Tuple[np.ndarray, int]:
    """Read a wav -> (float32 mono samples, sample_rate). FLAC (the JAX
    package's native decoder) is not yet ported and raises."""
    if str(path).lower().endswith('.flac'):
        raise NotImplementedError(f'{path}: FLAC input is not yet ported')
    return read_wav(path)


def read_wav_bytes(data: bytes, name: str = '<bytes>'
                   ) -> Tuple[np.ndarray, int]:
    """RIFF/WAVE bytes -> (float32 samples in [-1, 1], sample rate).

    Supports PCM 8/16/24/32-bit and IEEE float32/64, incl.
    WAVE_FORMAT_EXTENSIBLE. Multi-channel audio is averaged to mono
    (librosa.load(mono=True) behavior)."""
    if data[:4] != b'RIFF' or data[8:12] != b'WAVE':
        raise ValueError(f'not a RIFF/WAVE file: {name}')
    pos = 12
    fmt = None
    fmt_body = b''
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        chunk_size = struct.unpack('<I', data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + chunk_size]
        if chunk_id == b'fmt ':
            fmt = struct.unpack('<HHIIHH', body[:16])
            fmt_body = body
        elif chunk_id == b'data':
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or raw is None:
        raise ValueError(f'missing fmt/data chunk: {name}')
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:
        # WAVE_FORMAT_EXTENSIBLE: the real format code is the first two
        # bytes of the SubFormat GUID (1 = int PCM, 3 = IEEE float) —
        # many DAWs/ffmpeg write float WAVs this way, and assuming PCM
        # would reinterpret the float bits as int32 (silent garbage)
        if len(fmt_body) >= 26:
            audio_format = struct.unpack('<H', fmt_body[24:26])[0]
        else:
            audio_format = 1  # truncated extension: the pipeline's own
            # 24-bit files carry no SubFormat and are integer PCM

    if audio_format == 3:  # IEEE float
        if bits not in (32, 64):
            # a float header with PCM-ish bit depths would silently
            # reinterpret the payload as float64 garbage — reject like
            # the unsupported-PCM-depth case below
            raise ValueError(f'unsupported float bit depth: {bits}')
        dtype = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    elif audio_format == 1 or audio_format == 0xFFFE:
        if bits == 16:
            x = np.frombuffer(raw, dtype='<i2').astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype='<i4').astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            as32 = (b[:, 0].astype(np.int32) |
                    (b[:, 1].astype(np.int32) << 8) |
                    (b[:, 2].astype(np.int32) << 16))
            as32 = np.where(as32 & 0x800000, as32 - (1 << 24), as32)
            x = as32.astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                 - 128.0) / 128.0
        else:
            raise ValueError(f'unsupported PCM bit depth: {bits}')
    else:
        raise ValueError(f'unsupported WAV format tag: {audio_format}')

    if channels > 1:
        x = x[:len(x) - len(x) % channels].reshape(-1, channels).mean(axis=1)
    return x, sample_rate


def resample(samples: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (librosa.resample equivalent for this pipeline)."""
    if orig_sr == target_sr:
        return np.asarray(samples, dtype=np.float32)
    from math import gcd
    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    return _signal.resample_poly(samples, up, down).astype(np.float32)
