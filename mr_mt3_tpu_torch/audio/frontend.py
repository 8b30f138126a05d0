"""Log-mel spectrogram frontend in PyTorch (port of
mr_mt3_tpu/audio/frontend.py).

STFT: 2048-point periodic hann window, hop 128, no centring, zero pad-end,
magnitude (power 1.0). The FFT is torch.fft.rfft, as the JAX package leaves
its FFT to the compiler. The mel projection runs in fp32 at full precision
(the JAX einsum uses Precision.HIGHEST); callers on the card keep TF32 off
for matmuls, which is PyTorch's default. Two filterbank styles:

  * 'torch': torchaudio melscale_fbanks semantics (triangles in Hz);
  * 'tf': tf.signal.linear_to_mel_weight_matrix semantics (triangles in
    mel space, DC bin zeroed), for the official MT3 checkpoint.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

DEFAULT_SAMPLE_RATE = 16000
DEFAULT_HOP_WIDTH = 128
DEFAULT_NUM_MEL_BINS = 512
FFT_SIZE = 2048
MEL_LO_HZ = 20.0
MEL_HI_HZ = 7600.0

# log-mel normalization range (reference: dataset/dataset_2_random.py:19-20)
MIN_LOG_MEL = -12.0
MAX_LOG_MEL = 5.0


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig:
    """Spectrogram parameters (reference: contrib/spectrograms.py:44-65)."""
    sample_rate: int = DEFAULT_SAMPLE_RATE
    hop_width: int = DEFAULT_HOP_WIDTH
    num_mel_bins: int = DEFAULT_NUM_MEL_BINS
    fft_size: int = FFT_SIZE
    mel_lo_hz: float = MEL_LO_HZ
    mel_hi_hz: float = MEL_HI_HZ
    filterbank_style: str = 'torch'

    @property
    def frames_per_second(self) -> float:
        return self.sample_rate / self.hop_width


def _hz_to_mel(freq):
    """HTK mel scale, used by both torchaudio (htk) and tf.signal."""
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(num_mel_bins: int, num_spectrogram_bins: int,
                   sample_rate: float, lo_hz: float, hi_hz: float,
                   style: str = 'torch') -> np.ndarray:
    """Triangular mel filterbank, shape (num_spectrogram_bins, num_mel_bins)."""
    nyquist = sample_rate / 2.0
    linear_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)
    mel_edges = np.linspace(_hz_to_mel(lo_hz), _hz_to_mel(hi_hz),
                            num_mel_bins + 2)
    if style == 'torch':
        f_pts = _mel_to_hz(mel_edges)
        f_diff = np.diff(f_pts)
        slopes = f_pts[np.newaxis, :] - linear_freqs[:, np.newaxis]
        down = -slopes[:, :-2] / f_diff[:-1]
        up = slopes[:, 2:] / f_diff[1:]
        fb = np.maximum(0.0, np.minimum(down, up))
    elif style == 'tf':
        spec_mel = _hz_to_mel(linear_freqs[1:])[:, np.newaxis]
        lower = mel_edges[np.newaxis, :-2]
        center = mel_edges[np.newaxis, 1:-1]
        upper = mel_edges[np.newaxis, 2:]
        up_slope = (spec_mel - lower) / (center - lower)
        down_slope = (upper - spec_mel) / (upper - center)
        fb = np.maximum(0.0, np.minimum(up_slope, down_slope))
        fb = np.pad(fb, [[1, 0], [0, 0]])
    else:
        raise ValueError(f'unknown filterbank style: {style}')
    return fb.astype(np.float32)


def _hann_periodic(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(
        np.float32)


def num_stft_frames(num_samples: int, hop_width: int) -> int:
    """pad_end framing: one frame per hop while any input sample remains."""
    return -(-num_samples // hop_width)


@functools.lru_cache(maxsize=8)
def _frontend_constants(config: SpectrogramConfig):
    window = _hann_periodic(config.fft_size)
    fbank = mel_filterbank(
        num_mel_bins=config.num_mel_bins,
        num_spectrogram_bins=config.fft_size // 2 + 1,
        sample_rate=config.sample_rate,
        lo_hz=config.mel_lo_hz,
        hi_hz=config.mel_hi_hz,
        style=config.filterbank_style)
    return window, fbank


def stft_magnitude(samples: torch.Tensor, window: torch.Tensor,
                   hop_width: int, fft_size: int) -> torch.Tensor:
    """|STFT| with no centring and zero pad-end. samples (..., n) ->
    (..., n_frames, fft_size // 2 + 1)."""
    n = samples.shape[-1]
    n_frames = num_stft_frames(n, hop_width)
    pad = fft_size + hop_width * (n_frames - 1) - n
    x = torch.nn.functional.pad(samples, (0, pad))
    frames = x.unfold(-1, fft_size, hop_width) * window
    return torch.fft.rfft(frames, n=fft_size, dim=-1).abs()


def safe_log(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """log with non-positive inputs clamped to eps
    (reference: contrib/spectrograms.py:100-103)."""
    return torch.log(torch.where(x <= 0.0, torch.full_like(x, eps), x))


def compute_logmel(samples, config: SpectrogramConfig = SpectrogramConfig()
                   ) -> torch.Tensor:
    """samples (..., n) -> log-mel (..., n_frames, num_mel_bins) fp32, on
    the device of `samples`."""
    window, fbank = _frontend_constants(config)
    samples = torch.as_tensor(samples).float()
    dev = samples.device
    squeeze = samples.ndim == 1
    if squeeze:
        samples = samples[None]
    mag = stft_magnitude(samples, torch.from_numpy(window).to(dev),
                         config.hop_width, config.fft_size)
    mel = mag @ torch.from_numpy(fbank).to(dev)
    out = safe_log(mel)
    return out[0] if squeeze else out


def normalize_logmel(logmel: torch.Tensor) -> torch.Tensor:
    """Clamp to [MIN_LOG_MEL, MAX_LOG_MEL] and rescale to [0, 1]."""
    clipped = torch.clamp(logmel, MIN_LOG_MEL, MAX_LOG_MEL)
    return (clipped - MIN_LOG_MEL) / (MAX_LOG_MEL - MIN_LOG_MEL)
