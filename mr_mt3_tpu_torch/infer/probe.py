"""Deterministic probe audio (copy of mr_mt3_tpu/infer/probe.py:17).

The quantize probe ladder of the JAX package is not yet ported; serving
uses this signal to prewarm the decode path."""

from __future__ import annotations

import numpy as np


def probe_audio(num_segments: int = 2, sample_rate: int = 16000
                ) -> np.ndarray:
    """A chord + percussion-ish bursts, so logits are exercised on
    music-like (not silent) input. Sized 64 samples short of an exact hop
    multiple: the frontend pads a full extra hop when the length divides
    the hop (reference pad_end framing), so an exact multiple would gain an
    all-padding segment."""
    n = num_segments * 256 * 128 - 64
    t = np.arange(n, dtype=np.float32) / sample_rate
    audio = (0.2 * np.sin(2 * np.pi * 261.63 * t)      # C4
             + 0.2 * np.sin(2 * np.pi * 329.63 * t)    # E4
             + 0.15 * np.sin(2 * np.pi * 392.0 * t))   # G4
    burst = (np.arange(n) % (sample_rate // 2)) < 800  # 2 Hz clicks
    audio = audio + 0.3 * burst * np.sin(2 * np.pi * 1200 * t)
    return audio.astype(np.float32)
