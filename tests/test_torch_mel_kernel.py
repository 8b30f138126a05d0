"""The log-mel kernel's module (mr_mt3_tpu_torch/ops/mel_kernel.py) on the
CPU, where the CUDA kernel cannot run: its DFT constants equal the JAX
kernel's bit for bit; the JAX kernel (logmel_pallas, interpreted) meets the
port's compute_logmel, the kernel's plain version, at
tests/test_mel_pallas.py's bounds, the contract the card's kernel is held
to; chip_smoke.py's float64 DFT by products agrees with compute_logmel and
its Hann-less control does not; logmel takes only f32 CUDA tensors; and the
handler on the CPU keeps compute_logmel and never builds or launches the
kernel. The card's kernel itself: test_torch_fused_decode_gpu.py."""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from mr_mt3_tpu.audio import SpectrogramConfig as JaxSpectrogramConfig
from mr_mt3_tpu.ops import mel_pallas
from mr_mt3_tpu_torch.audio import SpectrogramConfig, compute_logmel
from mr_mt3_tpu_torch.infer import InferenceHandler
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.ops import cuda_build, mel_kernel
from tests.parity_common import parity_corpus


def _tone(n, sr=16000):
    """tests/test_mel_pallas.py::_tone."""
    t = np.arange(n) / sr
    x = (np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 1200 * t + 1))
    return (x / 1.5).astype(np.float32)


def _assert_within_mel_pallas_bounds(mine, oracle):
    """tests/test_mel_pallas.py's bounds: 2e-3 in log space where the
    oracle's log-mel is above -4, 0.02 in mel space everywhere."""
    assert mine.shape == oracle.shape
    mask = oracle > -4
    assert mask.sum() > 1000
    assert np.abs(mine[mask] - oracle[mask]).max() < 2e-3
    assert np.abs(np.exp(mine) - np.exp(oracle)).max() < 0.02


@pytest.mark.parametrize('style', ['torch', 'tf'])
def test_dft_constants_equal_jax(style):
    mine = mel_kernel._dft_constants(SpectrogramConfig(filterbank_style=style))
    theirs = mel_pallas._dft_constants(
        JaxSpectrogramConfig(filterbank_style=style))
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype == np.float32
        assert a.shape == b.shape
        assert np.array_equal(a, b)
    assert mine[0].shape == (2048, 1152) and mine[2].shape == (1152, 512)


@pytest.mark.parametrize('n', [32768, 16000])
def test_logmel_pallas_meets_compute_logmel(n):
    x = np.stack([_tone(n), _tone(n) * 0.3])
    cfg = SpectrogramConfig()
    oracle = compute_logmel(torch.from_numpy(x), cfg).numpy()
    mine = np.asarray(mel_pallas.logmel_pallas(x, JaxSpectrogramConfig(),
                                               interpret=True))
    _assert_within_mel_pallas_bounds(mine, oracle)


def test_logmel_pallas_tf_style_meets_compute_logmel():
    x = _tone(32768)[None]
    oracle = compute_logmel(torch.from_numpy(x),
                            SpectrogramConfig(filterbank_style='tf')).numpy()
    mine = np.asarray(mel_pallas.logmel_pallas(
        x, JaxSpectrogramConfig(filterbank_style='tf'), interpret=True))
    mask = oracle > -4
    assert np.abs(mine[mask] - oracle[mask]).max() < 2e-3


def test_zero_audio_log_floor():
    x = np.zeros((1, 4096), np.float32)
    for out in (np.asarray(mel_pallas.logmel_pallas(x, interpret=True)),
                compute_logmel(torch.from_numpy(x)).numpy(),
                chip_smoke.logmel_f64(torch, torch.from_numpy(x),
                                      SpectrogramConfig()).numpy()):
        assert out.shape == (1, 32, 512)
        np.testing.assert_allclose(out, math.log(1e-5), atol=1e-4)


@pytest.mark.parametrize('style', ['torch', 'tf'])
def test_f64_dft_agrees_with_compute_logmel(style):
    """chip_smoke's float64 DFT by products on the kernel's constants, on
    the parity corpus's first song (3 segments): within 2e-4 in mel space
    and 1e-3 in log space where log-mel > -4 of the FFT frontend."""
    cfg = SpectrogramConfig(filterbank_style=style)
    x = torch.from_numpy(parity_corpus()[0][0][:3 * 32768].reshape(3, -1))
    readings = chip_smoke.logmel_readings(
        torch, compute_logmel(x, cfg), chip_smoke.logmel_f64(torch, x, cfg))
    print(style, readings)
    assert readings['energy_share'] > 0.5
    assert readings['mel_err'] < 2e-4
    assert readings['log_err'] < 1e-3


@pytest.mark.parametrize('kind', ['tone', 'noise'])
def test_the_control_breaks_the_bounds(kind):
    """The Hann-less products break LOGMEL_BOUNDS against both references,
    while compute_logmel itself passes the f64 bounds."""
    cfg = SpectrogramConfig()
    x = torch.from_numpy(chip_smoke.logmel_inputs(kind, 2))
    plain = compute_logmel(x, cfg)
    f64 = chip_smoke.logmel_f64(torch, x, cfg)
    ctrl = chip_smoke.logmel_f64(torch, x, cfg, hann=False)
    for ref, want in (('vs_plain', plain), ('vs_f64', f64)):
        caught = chip_smoke.logmel_violations(
            chip_smoke.LOGMEL_BOUNDS[ref],
            chip_smoke.logmel_readings(torch, ctrl, want))
        assert caught, ref
    assert chip_smoke.logmel_violations(
        chip_smoke.LOGMEL_BOUNDS['vs_f64'],
        chip_smoke.logmel_readings(torch, plain, f64)) == []


@pytest.mark.parametrize('batch', [8, 64])
def test_bound_counts_an_fft_and_the_sparse_mel_products(batch):
    """The function's bound, not the kernel's algorithm's: B segments of
    32768 samples, 256 frames each, at 2048 + 2.5 x 2048 x 11 + 4 x 1025
    + 2 x (the filterbank's nonzeros) + 512 f32 operations a frame at 67
    TFLOP/s, above the bytes (audio, nonzeros, output) at 3.35 TB/s; the
    kernel's own FFT (a 1024-point complex radix-2 transform, its post-
    pass, the mel products over the nonzero ranges) within 1.3x of it."""
    cfg = SpectrogramConfig()
    nnz = int(np.count_nonzero(mel_kernel._dft_constants(cfg)[2]))
    assert 1025 < nnz < 2 * 1025       # triangles: each bin in at most 2
    ms, by = chip_smoke.logmel_bound_ms(batch, 32768, cfg)
    flops = batch * 256 * (2048 + 2.5 * 2048 * 11 + 4 * 1025 + 2 * nnz
                           + 512)
    assert by == 'operations'
    assert ms == pytest.approx(flops / 67e12 * 1e3)
    assert 4 * batch * (32768 + 256 * 512) / 3.35e12 * 1e3 < ms
    span = int(mel_kernel._fft_constants(cfg)[3].sum())
    assert span == nnz                 # the ranges hold no zeros
    fft = batch * 256 * (2048 + 5 * 1024 * 10 + 16 * 1025 + 2 * span + 512)
    assert chip_smoke.logmel_fft_bound_ms(batch, 32768, cfg) == \
        pytest.approx(fft / 67e12 * 1e3)
    assert 1 < fft / flops < 1.3


class TestLogmelTakesOnlyCudaF32:
    def test_raises_on_a_cpu_tensor(self):
        with pytest.raises(ValueError, match='CUDA tensor'):
            mel_kernel.logmel(torch.zeros(2, 32768))

    @pytest.mark.parametrize('dtype', [torch.float64, torch.bfloat16])
    def test_raises_on_a_wrong_dtype(self, dtype):
        with pytest.raises(ValueError, match='float32'):
            mel_kernel.logmel(torch.zeros(2, 32768, dtype=dtype))

    def test_raises_on_1d_input(self):
        with pytest.raises(ValueError, match='batch, samples'):
            mel_kernel.logmel(torch.zeros(32768))

    def test_nothing_was_built_or_launched(self):
        assert 'logmel' not in cuda_build._libs
        assert mel_kernel.LAUNCHES == {'logmel': 0}


def test_handler_on_the_cpu_keeps_compute_logmel(monkeypatch):
    """The CPU handler's log-mel is compute_logmel, normalized and with the
    frames past `valid` zeroed; the kernel is never built or launched."""
    def no_kernel(*args, **kwargs):
        raise AssertionError('the CPU handler called the CUDA kernel')
    monkeypatch.setattr('mr_mt3_tpu_torch.infer.handler.logmel', no_kernel)
    cfg = MT3Config(d_model=32, d_kv=8, d_ff=48, num_heads=4,
                    num_encoder_layers=1, num_decoder_layers=1)
    handler = InferenceHandler(model=MT3(cfg), device='cpu')
    audio = parity_corpus()[0][0][:50000]
    segments, _, valid = handler._audio_to_segments(audio)
    mel = handler._compute_mel(segments, valid)
    want = compute_logmel(torch.from_numpy(segments))
    want = (torch.clamp(want, -12.0, 5.0) + 12.0) / 17.0
    assert valid == [256, 135]
    assert torch.equal(mel[0], want[0])
    assert torch.equal(mel[1, :135], want[1, :135])
    assert not mel[1, 135:].any()
    assert mel_kernel.LAUNCHES['logmel'] == 0
    assert 'logmel' not in cuda_build._libs
