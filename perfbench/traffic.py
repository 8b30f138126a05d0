"""The one traffic generator: a mix is a JSON file of parameters under
perfbench/traffic/, read here. The multiset of clip lengths, and of the
gaps between arrivals, is fixed by the mix; the seed makes the audio.
Lengths go in the van der Corput order of the sorted multiset
(consecutive clips spread over the whole range, so any stretch of the
schedule holds a like mix). An open loop sends its whole schedule inside
the window, so there the seed rotates the order (lengths and gaps, the
gaps in a fixed shuffle); a closed loop's window covers only the start of
its pool, so there the order is fixed and every seed's window does the
same work.

Kinds:
  * 'open_http': independent users POST WAV clips to the program's
    server. `rate_per_s` x the run's seconds requests, due at Poisson
    gaps (the exponential distribution's quantiles);
  * 'closed_calls': one caller, back to back, `songs_per_call` clips a
    transcribe_many call, drawn in turn from a pool of `pool` clips
    (cycling).
Lengths: `seconds_range` [lo, hi], spread evenly over the count, each
moved off the frontend's segment boundary (a length that is a multiple of
a segment would gain a one-frame segment of padding).
"""

from __future__ import annotations

import io
import json
import math
import os
import wave

import numpy as np
import torch

from perfbench.reference import frontend

HERE = os.path.dirname(os.path.abspath(__file__))
SEGMENT_SAMPLES = frontend.FRAMES * frontend.HOP


def load(name: str) -> dict:
    with open(os.path.join(HERE, 'traffic', f'{name}.json')) as f:
        return json.load(f)


def _spread(n: int) -> np.ndarray:
    """0..n-1 in van der Corput order (bit-reversed, skipping >= n)."""
    bits = max(1, (n - 1).bit_length())
    rev = [int(format(i, f'0{bits}b')[::-1], 2) for i in range(1 << bits)]
    return np.array([r for r in rev if r < n])


def _rotated(order: np.ndarray, seed: int) -> np.ndarray:
    return np.roll(order, -(int(seed) % len(order)))


def clip_samples(mix: dict, n: int) -> np.ndarray:
    """The fixed multiset of n clip lengths in samples, ascending."""
    lo, hi = mix['seconds_range']
    secs = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    out = np.round(secs * frontend.SAMPLE_RATE).astype(np.int64)
    # keep clear of the boundary: [k * segment, k * segment + hop)
    on_edge = (out % SEGMENT_SAMPLES) < frontend.HOP
    out[on_edge] -= frontend.HOP
    return out


def schedule(mix: dict, seed: int, seconds: float):
    """(lengths in samples, due times in seconds from the window's start
    or None) in the order the run sends them."""
    if mix['kind'] == 'open_http':
        n = max(1, int(round(mix['rate_per_s'] * seconds)))
        gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / mix['rate_per_s']
        gaps = gaps[_rotated(np.random.default_rng(0).permutation(n), seed)]
        due = np.cumsum(gaps)          # every gap used: the span is fixed
        return clip_samples(mix, n)[_rotated(_spread(n), seed)], due
    if mix['kind'] == 'closed_calls':
        n = int(mix['pool'])
        return clip_samples(mix, n)[_spread(n)], None
    raise ValueError(f'unknown traffic kind {mix["kind"]!r}')


@torch.no_grad()
def synthesize(lengths, seed: int, device) -> list:
    """Music-like clips, one per length: a chord of three tones a bar
    (bars of 1.5-2.5 s, pitches 48-76, a decay within the bar) and a
    percussive burst every 0.25-0.6 s. Made on `device` from a generator
    seeded with `seed`; returned as float32 numpy arrays that survive a
    16-bit WAV round trip unchanged (multiples of 2^-15)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 1)
    sr = frontend.SAMPLE_RATE
    out = []
    for n in lengths:
        n = int(n)
        r = torch.rand(4, generator=gen, device=device)
        bar = 1.5 + r[0].item()
        period = 0.25 + 0.35 * r[1].item()
        burst_hz = 800.0 + 1200.0 * r[2].item()
        bars = int(math.ceil(n / sr / bar)) + 1
        pitch = torch.randint(48, 77, (bars, 3), generator=gen,
                              device=device).float()
        freq = 440.0 * 2.0 ** ((pitch - 69.0) / 12.0)
        t = torch.arange(n, device=device, dtype=torch.float64) / sr
        idx = (t / bar).long()
        in_bar = (t - idx * bar).float()
        tf = t.float()
        tone = torch.sin(2 * math.pi * (freq[idx] * (t % 1.0)[:, None]
                                        .float())).sum(-1)
        x = 0.18 * tone * torch.exp(-1.5 * in_bar)
        hit = ((t % period) < 0.03).float()
        x = x + 0.3 * hit * torch.sin(2 * math.pi * burst_hz * tf)
        x = x / x.abs().max().clamp(min=1e-6) * 0.8
        q = torch.round(x * 32767.0).clamp(-32768, 32767)
        # + 0.0 turns -0.0 into 0.0, as the 16-bit WAV reads it back
        out.append((q / 32768.0 + 0.0).cpu().numpy().astype(np.float32))
    return out


def wav_bytes(audio: np.ndarray) -> bytes:
    """16-bit mono 16 kHz WAV of float32 samples that are multiples of
    2^-15 (exact)."""
    buf = io.BytesIO()
    with wave.open(buf, 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(frontend.SAMPLE_RATE)
        w.writeframes(np.round(audio * 32768.0).astype('<i2').tobytes())
    return buf.getvalue()
