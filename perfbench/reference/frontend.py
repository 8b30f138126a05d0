"""The audio frontend as plain PyTorch: 16 kHz audio cut into segments of
256 frames of 128 samples, each segment's log-mel spectrogram (a 2048-point
periodic Hann window, hop 128, no centring, zero padding at the end, the
magnitude of a real FFT, 512 triangular mel filters from 20 to 7600 Hz on
the HTK scale with triangles in Hz, the log with non-positive values
clamped to 1e-5), clamped to [-12, 5] and scaled to [0, 1], the frames past
the audio's end zeroed."""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 16000
HOP = 128
FFT = 2048
MEL_BINS = 512
FRAMES = 256
LO_HZ, HI_HZ = 20.0, 7600.0
MIN_LOG, MAX_LOG = -12.0, 5.0


def num_segments(num_samples: int) -> int:
    """Segments of a clip: the frontend pads to the next hop boundary (a
    whole hop where the length is a multiple of it)."""
    frames = (num_samples + HOP - num_samples % HOP) // HOP
    return math.ceil(frames / FRAMES)


def segments(audio: np.ndarray):
    """16 kHz audio -> (segment samples (N, FRAMES * HOP) float32, the
    valid frames of each segment)."""
    audio = np.pad(audio, (0, HOP - len(audio) % HOP))
    frames = len(audio) // HOP
    n = math.ceil(frames / FRAMES)
    out = np.zeros((n, FRAMES * HOP), np.float32)
    valid = []
    for i in range(n):
        f0, f1 = i * FRAMES, min((i + 1) * FRAMES, frames)
        out[i, :(f1 - f0) * HOP] = audio[f0 * HOP:f1 * HOP]
        valid.append(f1 - f0)
    return out, valid


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def filterbank() -> np.ndarray:
    """(FFT // 2 + 1, MEL_BINS) float32 triangles in Hz."""
    lin = np.linspace(0.0, SAMPLE_RATE / 2.0, FFT // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(LO_HZ), _hz_to_mel(HI_HZ),
                                   MEL_BINS + 2))
    diff = np.diff(edges)
    slopes = edges[None, :] - lin[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def logmel(seg: torch.Tensor, valid) -> torch.Tensor:
    """Segment samples (N, FRAMES * HOP) -> normalized log-mel (N, FRAMES,
    MEL_BINS) float32 on seg's device, frames >= valid[i] zeroed."""
    dev = seg.device
    n = seg.shape[-1]
    frames = -(-n // HOP)
    x = torch.nn.functional.pad(seg.float(), (0, FFT + HOP * (frames - 1)
                                              - n))
    window = torch.from_numpy(
        (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(FFT) / FFT))
        .astype(np.float32)).to(dev)
    mag = torch.fft.rfft(x.unfold(-1, FFT, HOP) * window, n=FFT,
                         dim=-1).abs()
    mel = mag @ torch.from_numpy(filterbank()).to(dev)
    mel = torch.log(torch.where(mel <= 0.0, torch.full_like(mel, 1e-5), mel))
    mel = (mel.clamp(MIN_LOG, MAX_LOG) - MIN_LOG) / (MAX_LOG - MIN_LOG)
    keep = torch.arange(frames, device=dev)[None, :] < torch.as_tensor(
        valid, device=dev)[:, None]
    return torch.where(keep[..., None], mel, torch.zeros_like(mel))
