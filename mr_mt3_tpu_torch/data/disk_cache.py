"""Persistent on-disk tokenization cache (copy of
mr_mt3_tpu/data/disk_cache.py).

The cold first epoch of a real-Slakh-scale run spends ~40 min parsing
MIDI and running the RLE hot loop (PERF.md loader section), and the
reference re-pays that every epoch AND every process start
(reference: dataset/dataset_2_random.py:109-172 re-tokenizes per epoch).
The in-memory song cache (data/slakh.py) already beats the per-epoch
cost; this module makes the win durable across process restarts.

Design:
  * content-keyed: the key hashes the MIDI stem bytes + instrument
    mapping + every tokenization-relevant config field. Re-rendered
    audio of the same length reuses the entry (tokens depend on the
    MIDI and the frame grid, not on samples); touching a MIDI file or
    changing the codec invalidates it by construction. No mtimes.
  * stores only the DERIVED arrays (event stream + per-frame indices),
    never audio — a 5-minute song is ~19 MB of samples but only ~100 KB
    of tokens, and the wav read is cheap next to the RLE loop.
  * per-frame indices depend on the audio frame count, so each entry
    records the num_frames it was computed for; a mismatch (audio file
    changed length) is treated as a miss and re-tokenized.
  * PitchBendError songs store a skip marker so warm restarts don't
    re-parse their MIDI just to skip them again.
  * writes are atomic (tempfile + os.replace) so concurrent loader
    threads/processes sharing a cache dir never read torn files, and
    IO errors degrade to a warning + cache-off rather than failing the
    epoch (read-only dataset mounts are common).
"""

from __future__ import annotations

import hashlib
import os
import sys
import tempfile
from typing import Dict, Optional

import numpy as np

# bump when the SongFeatures-derived array layout changes; old entries
# become misses instead of deserialization errors
_FORMAT_VERSION = 1

_ARRAY_KEYS = ('events', 'event_start_indices', 'event_end_indices',
               'state_events', 'state_event_indices')


def hash_parts(*parts) -> str:
    """Stable hex digest of byte/str/int parts (order-sensitive)."""
    h = hashlib.blake2b(digest_size=20)
    h.update(str(_FORMAT_VERSION).encode())
    for p in parts:
        if isinstance(p, str):
            p = p.encode()
        elif not isinstance(p, (bytes, bytearray)):
            p = repr(p).encode()
        # length-prefix so ('ab','c') != ('a','bc')
        h.update(len(p).to_bytes(8, 'little'))
        h.update(p)
    return h.hexdigest()


def hash_file(path: str) -> bytes:
    h = hashlib.blake2b(digest_size=20)
    with open(path, 'rb') as f:
        for block in iter(lambda: f.read(1 << 20), b''):
            h.update(block)
    return h.digest()


class TokenizationCache:
    """Directory of <key>.npz entries, one per (song, config)."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        self._disabled = False
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError as e:
            self._warn_off(f'cannot create {cache_dir}: {e}')

    def _warn_off(self, why: str) -> None:
        if not self._disabled:
            print(f'WARNING: tokenization cache disabled ({why})',
                  file=sys.stderr)
        self._disabled = True

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f'{key}.npz')

    def get(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        """None on miss; {'skipped': True} for a skip marker; otherwise
        the stored arrays plus 'num_frames' (int)."""
        if self._disabled:
            return None
        path = self._path(key)
        try:
            with np.load(path) as z:
                if bool(z['skipped']):
                    return {'skipped': True}
                out = {k: z[k] for k in _ARRAY_KEYS}
                out['num_frames'] = int(z['num_frames'])
                out['skipped'] = False
                return out
        except FileNotFoundError:
            return None
        except Exception as e:  # noqa: BLE001 — torn/old entry = miss
            print(f'WARNING: dropping unreadable cache entry {path} '
                  f'({e!r})', file=sys.stderr)
            try:
                os.unlink(path)
            except OSError:
                pass
            return None

    def put(self, key: str, arrays: Optional[Dict[str, np.ndarray]],
            num_frames: int = 0) -> None:
        """arrays=None stores a skip marker (PitchBendError song)."""
        if self._disabled:
            return
        path = self._path(key)
        payload = {'skipped': np.bool_(arrays is None),
                   'num_frames': np.int64(num_frames)}
        if arrays is not None:
            for k in _ARRAY_KEYS:
                payload[k] = np.ascontiguousarray(arrays[k])
        try:
            fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix='.tmp')
            try:
                with os.fdopen(fd, 'wb') as f:
                    np.savez(f, **payload)
                os.replace(tmp, path)
            except BaseException:
                os.unlink(tmp)
                raise
        except OSError as e:
            self._warn_off(f'cannot write {path}: {e}')


def resolve_cache_dir(cache_dir: Optional[str],
                      root_dir: str) -> Optional[str]:
    """Resolve the dataset ctor's cache_dir parameter.

    None  -> MR_MT3_TOKEN_CACHE env var if set, else off.
    'auto'-> <root_dir>/.token_cache (alongside the data).
    other -> used as-is.
    """
    if cache_dir is None:
        cache_dir = os.environ.get('MR_MT3_TOKEN_CACHE') or None
    if cache_dir == 'auto':
        cache_dir = os.path.join(root_dir, '.token_cache')
    return cache_dir
