"""PyTorch log-mel frontend (mr_mt3_tpu_torch.audio.frontend) against the
JAX frontend on the same audio, in both filterbank styles."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mr_mt3_tpu.audio import frontend as jax_fe
from mr_mt3_tpu_torch.audio import frontend as torch_fe
from tests.parity_common import parity_corpus

# broadband audio: the JAX package's frontend tolerance
# (tests/test_audio_frontend.py:81), everywhere
ATOL = 1e-4
# tonal corpus audio: two fp32 FFTs (XLA's and PyTorch's) disagree at the
# FFT noise floor of the loud tones' spectra, up to ~4e-4 in log-mel even
# in bins with energy. The JAX package holds its frontend to a torch.stft
# pipeline with the same bounds used here (tests/test_audio_frontend.py:
# 146-150): 1e-3 in log space where log-mel > -4, 0.01 in mel space.
TONAL_ATOL, TONAL_MEL_ATOL, ENERGY_FLOOR = 1e-3, 1e-2, -4.0


@pytest.mark.parametrize('style', ['torch', 'tf'])
def test_logmel_matches_jax_random_audio(style):
    audio = (np.random.default_rng(0).normal(size=(2, 20000))
             * 0.1).astype(np.float32)
    want = np.asarray(jax_fe.compute_logmel(
        jnp.asarray(audio), jax_fe.SpectrogramConfig(filterbank_style=style)))
    got = torch_fe.compute_logmel(
        audio, torch_fe.SpectrogramConfig(filterbank_style=style))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        torch_fe.normalize_logmel(got).numpy(),
        np.asarray(jax_fe.normalize_logmel(jnp.asarray(want))),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize('style', ['torch', 'tf'])
def test_logmel_matches_jax_corpus_segments(style):
    audio = parity_corpus()[0][0][:2 * 256 * 128].reshape(2, -1)
    want = np.asarray(jax_fe.compute_logmel(
        jnp.asarray(audio), jax_fe.SpectrogramConfig(filterbank_style=style)))
    got = torch_fe.compute_logmel(
        audio, torch_fe.SpectrogramConfig(filterbank_style=style)).numpy()
    assert got.shape == want.shape == (2, 256, 512)
    energy = want > ENERGY_FLOOR
    assert energy.mean() > 0.5
    assert np.abs(got - want)[energy].max() < TONAL_ATOL
    assert np.abs(np.exp(got) - np.exp(want)).max() < TONAL_MEL_ATOL
    np.testing.assert_allclose(
        torch_fe.normalize_logmel(torch.from_numpy(got)).numpy(),
        np.asarray(jax_fe.normalize_logmel(jnp.asarray(want))),
        atol=TONAL_ATOL, rtol=0)


@pytest.mark.parametrize('style', ['torch', 'tf'])
def test_filterbank_and_window_are_the_jax_constants(style):
    np.testing.assert_array_equal(
        torch_fe.mel_filterbank(512, 1025, 16000, 20.0, 7600.0, style),
        jax_fe.mel_filterbank(512, 1025, 16000, 20.0, 7600.0, style))
    np.testing.assert_array_equal(torch_fe._hann_periodic(2048),
                                  jax_fe._hann_periodic(2048))


def test_unbatched_input_and_frame_count():
    """A 1-D signal gives (frames, bins) with pad_end framing."""
    x = np.random.default_rng(1).normal(size=1000).astype(np.float32)
    out = torch_fe.compute_logmel(x)
    assert tuple(out.shape) == (torch_fe.num_stft_frames(1000, 128), 512)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_fe.compute_logmel(jnp.asarray(x))),
        atol=ATOL, rtol=0)


def test_safe_log_floor():
    x = torch.tensor([0.0, -1.0, 1.0])
    np.testing.assert_allclose(torch_fe.safe_log(x).numpy(),
                               [np.log(1e-5), np.log(1e-5), 0.0], rtol=1e-6)
