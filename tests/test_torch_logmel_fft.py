"""The log-mel kernel's order of operations (csrc/logmel.cu) emulated in
plain PyTorch on the CPU, in f32, and held against chip_smoke's float64
DFT (logmel_f64) and against compute_logmel within LOGMEL_BOUNDS, the
bounds the kernel meets on the card:

- each frame's 2048 windowed samples packed as 1024 complex values
  x[2n] + i x[2n + 1] at bit-reversed indices, 10 radix-2 decimation-in-
  time stages with the twiddles of ops/mel_kernel.py::_fft_constants
  (float64 tables stored as f32; the 1024-point stages read every second
  entry), then the real-input post-pass giving |X[k]| and |X[1024 - k]|
  from Z[k] and Z[1024 - k];
- the mel projection over each filter's contiguous range of nonzero bins,
  bins in ascending order, then safe_log.

The emulation lives here, not in the package: compute_logmel is the
function, this is the kernel's order. chip_smoke's control, the products
without the Hann window, must still break LOGMEL_BOUNDS, and the ranges
must cover every nonzero of both filterbank styles."""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from mr_mt3_tpu_torch.audio import SpectrogramConfig, compute_logmel
from mr_mt3_tpu_torch.ops import mel_kernel

HALF = 1024          # points of the kernel's complex FFT
STAGES = 10


def _bit_reversed(n_bits):
    idx = torch.arange(1 << n_bits)
    rev = torch.zeros_like(idx)
    for bit in range(n_bits):
        rev |= ((idx >> bit) & 1) << (n_bits - 1 - bit)
    return rev


def _complex_mul(wr, wi, vr, vi):
    """The kernel's butterfly product in f32: (w.x v.x - w.y v.y,
    w.x v.y + w.y v.x)."""
    return wr * vr - wi * vi, wr * vi + wi * vr


def _spectrum_mag(ar, ai, br, bi, wr, wi):
    """|X[k]| from A = Z[k], Bc = conj(Z[1024 - k]) (br, bi) and W^k:
    E = (A + Bc) / 2, O = -i (A - Bc) / 2, X = E + W^k O
    (csrc/logmel.cu::spectrum_mag)."""
    er, ei = 0.5 * (ar + br), 0.5 * (ai + bi)
    orr, oi = 0.5 * (ai - bi), -0.5 * (ar - br)
    re = er + (wr * orr - wi * oi)
    im = ei + (wr * oi + wi * orr)
    return torch.sqrt(re * re + im * im)


def emulated_logmel(samples, config, hann=True):
    """(B, n) f32 -> (B, frames, mel) f32 in the kernel's order."""
    tw, window, lo, length, offset, weights = (
        torch.from_numpy(np.asarray(t)) for t in
        mel_kernel._fft_constants(config))
    if not hann:
        window = torch.ones_like(window)
    hop, fft = config.hop_width, config.fft_size
    frames = -(-samples.shape[-1] // hop)
    pad = fft + hop * (frames - 1) - samples.shape[-1]
    x = torch.nn.functional.pad(samples.float(), (0, pad)).unfold(-1, fft,
                                                                  hop)
    x = x * window
    rev = _bit_reversed(STAGES)
    zr = torch.empty(x.shape[:-1] + (HALF,))
    zi = torch.empty_like(zr)
    zr[..., rev], zi[..., rev] = x[..., 0::2], x[..., 1::2]
    for s in range(STAGES):
        h = 1 << s
        j = torch.arange(h)
        wr, wi = tw[j << (STAGES - s), 0], tw[j << (STAGES - s), 1]
        shape = zr.shape[:-1] + (HALF // (2 * h), 2, h)
        zr, zi = zr.reshape(shape), zi.reshape(shape)
        ur, ui, vr, vi = zr[..., 0, :], zi[..., 0, :], zr[..., 1, :], \
            zi[..., 1, :]
        tr, ti = _complex_mul(wr, wi, vr, vi)
        zr = torch.stack([ur + tr, ur - tr], -2).reshape(shape[:-3] + (HALF,))
        zi = torch.stack([ui + ti, ui - ti], -2).reshape(shape[:-3] + (HALF,))
    k = torch.arange(HALF // 2 + 1)
    km = (HALF - k) % HALF
    mag = torch.empty(zr.shape[:-1] + (HALF + 1,))
    mag[..., k] = _spectrum_mag(zr[..., k], zi[..., k], zr[..., km],
                                -zi[..., km], tw[k, 0], tw[k, 1])
    mag[..., HALF - k] = _spectrum_mag(zr[..., km], zi[..., km], zr[..., k],
                                       -zi[..., k], tw[HALF - k, 0],
                                       tw[HALF - k, 1])
    mel = torch.zeros(mag.shape[:-1] + (len(lo),))
    for i in range(int(length.max())):
        live = i < length
        bins = torch.where(live, lo + i, 0).long()
        w = torch.where(live, weights[torch.where(live, offset + i, 0)
                                      .long()], 0.0)
        mel = mel + mag[..., bins] * w
    return torch.log(torch.where(mel <= 0, torch.full_like(mel, 1e-5), mel))


def _readings(samples, config, hann=True):
    mine = emulated_logmel(samples, config, hann)
    return {ref: chip_smoke.logmel_readings(torch, mine, want)
            for ref, want in (
                ('vs_plain', compute_logmel(samples, config)),
                ('vs_f64', chip_smoke.logmel_f64(torch, samples, config)))}


@pytest.mark.parametrize('kind,n', [('tone', 32768), ('noise', 32768),
                                    ('tone', 16000)])
@pytest.mark.parametrize('style', ['torch', 'tf'])
def test_fft_order_within_logmel_bounds(style, kind, n):
    """Two segments (the ragged 16000 pads its last frames with zeros):
    within LOGMEL_BOUNDS of compute_logmel (an f32 FFT in another order:
    2e-3 in log space, 2e-2 in mel space) and of the float64 DFT on the
    same f32 constants (7e-4 and 6e-4: the emulation's only error is its
    f32 rounding, ~log2(1024) roundings a value)."""
    cfg = SpectrogramConfig(filterbank_style=style)
    x = torch.from_numpy(chip_smoke.logmel_inputs(kind, 2, n))
    readings = _readings(x, cfg)
    print(style, kind, n, readings)
    for ref, r in readings.items():
        assert r['energy_share'] > 0.1, ref
        assert chip_smoke.logmel_violations(chip_smoke.LOGMEL_BOUNDS[ref],
                                            r) == [], ref


@pytest.mark.parametrize('kind', ['tone', 'noise'])
def test_the_hannless_control_is_still_caught(kind):
    """The same order without the Hann window breaks LOGMEL_BOUNDS
    against both references, as chip_smoke's control does."""
    cfg = SpectrogramConfig()
    x = torch.from_numpy(chip_smoke.logmel_inputs(kind, 2))
    for ref, r in _readings(x, cfg, hann=False).items():
        assert chip_smoke.logmel_violations(chip_smoke.LOGMEL_BOUNDS[ref],
                                            r), ref


@pytest.mark.parametrize('style', ['torch', 'tf'])
def test_ranges_cover_every_nonzero(style):
    """Each filter's range holds every nonzero of its column, lies in the
    1025 bins, and the packed weights rebuild the dense filterbank exactly;
    the kernel reads 1934-ish weights, not 1025 x 512."""
    cfg = SpectrogramConfig(filterbank_style=style)
    fbank = mel_kernel._dft_constants(cfg)[2]
    _, _, lo, length, offset, weights = mel_kernel._fft_constants(cfg)
    bins = cfg.fft_size // 2 + 1
    dense = np.zeros_like(fbank)
    for m in range(fbank.shape[1]):
        nz = np.flatnonzero(fbank[:, m])
        if len(nz):
            assert lo[m] == nz[0] and lo[m] + length[m] - 1 == nz[-1]
        assert 0 <= lo[m] and lo[m] + length[m] <= bins
        dense[lo[m]:lo[m] + length[m], m] = \
            weights[offset[m]:offset[m] + length[m]]
    assert np.array_equal(dense, fbank)
    assert length.sum() < 2 * bins
    assert lo.dtype == length.dtype == offset.dtype == np.int32


def test_tables_are_float64_rounded_to_f32():
    """Twiddles and window come from float64 on the host (no __sinf): the
    twiddles equal the rounded float64 values bit for bit, and the
    1024-point transform's twiddles are the even entries."""
    cfg = SpectrogramConfig()
    tw, window = mel_kernel._fft_constants(cfg)[:2]
    k = np.arange(cfg.fft_size // 2 + 1)
    angle = 2 * np.pi * k / cfg.fft_size
    assert tw.dtype == np.float32 and tw.shape == (1025, 2)
    assert np.array_equal(tw[:, 0], np.cos(angle).astype(np.float32))
    assert np.array_equal(tw[:, 1], (-np.sin(angle)).astype(np.float32))
    assert np.array_equal(window, mel_kernel._hann_periodic(cfg.fft_size))
    assert tw[HALF, 0] == -1.0


def test_zeros_give_the_log_floor():
    x = torch.zeros((1, 4096))
    out = emulated_logmel(x, SpectrogramConfig())
    assert out.shape == (1, 32, 512)
    torch.testing.assert_close(out, torch.full_like(out, math.log(1e-5)))
