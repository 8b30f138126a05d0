"""The port's native tokenizer core (mr_mt3_tpu_torch/native/tokenizer.py
and its copy of tokenizer.cc) against the port's Python RLE path and the
JAX package's native core (or, where that library is not built, the JAX
package's Python path): the five arrays equal."""

import warnings

import numpy as np
import pytest

from mr_mt3_tpu.codec import VocabularyConfig as JaxVocabularyConfig
from mr_mt3_tpu.codec import build_codec as jax_build_codec
from mr_mt3_tpu.codec import note_sequences as jax_nsq
from mr_mt3_tpu.data import transforms as jax_transforms
from mr_mt3_tpu_torch.codec import VocabularyConfig, build_codec
from mr_mt3_tpu_torch.codec import note_sequences as nsq
from mr_mt3_tpu_torch.codec import rle
from mr_mt3_tpu_torch.data import transforms
from mr_mt3_tpu_torch.native import tokenizer

try:
    from mr_mt3_tpu.native.tokenizer import native_available
    HAVE_JAX_NATIVE = native_available()
except Exception:  # noqa: BLE001 - the JAX library is optional here
    HAVE_JAX_NATIVE = False

NAMES = ('events', 'starts', 'ends', 'state_events', 'state_idx')


def _notes(rng, n_notes, duration):
    """Seeded note tuples (start, end, pitch, velocity, program, drum)."""
    notes = []
    for _ in range(n_notes):
        start = float(rng.uniform(0, duration - 0.2))
        notes.append((start, start + float(rng.uniform(0.05, 2.0)),
                      int(rng.integers(21, 108)), int(rng.integers(1, 128)),
                      int(rng.choice([0, 8, 24, 32, 40, 56])),
                      bool(rng.random() < 0.25)))
    return notes


def _song(module, notes, duration):
    ns = module.NoteSequence()
    for start, end, pitch, velocity, program, drum in notes:
        ns.add_note(start_time=start, end_time=end, pitch=pitch,
                    velocity=velocity, program=program, is_drum=drum)
    ns.total_time = duration
    return ns


def _events(module, notes, duration, onsets_only=False, trim=True):
    ns = _song(module, notes, duration)
    module.assign_instruments(ns)
    if trim:
        ns = module.trim_overlapping_notes(ns)
    if onsets_only:
        return module.note_sequence_to_onsets(ns)
    return module.note_sequence_to_onsets_and_offsets_and_programs(ns)


def _python(times, values, codec, frame_times, include_ties=True):
    return rle.encode_and_index_events(
        state=nsq.NoteEncodingState() if include_ties else None,
        event_times=times, event_values=values,
        encode_event_fn=nsq.note_event_data_to_events, codec=codec,
        frame_times=frame_times,
        encoding_state_to_events_fn=(
            nsq.note_encoding_state_to_events if include_ties else None))


def _jax(notes, duration, frame_times, num_velocity_bins=1,
         onsets_only=False, trim=True):
    codec = jax_build_codec(
        JaxVocabularyConfig(num_velocity_bins=num_velocity_bins))
    times, values = _events(jax_nsq, notes, duration, onsets_only, trim)
    return jax_transforms.encode_note_events(
        times, values, codec, frame_times, include_ties=not onsets_only,
        use_native=HAVE_JAX_NATIVE)


def _check(notes, duration, n_frames, num_velocity_bins=1,
           onsets_only=False, trim=True):
    codec = build_codec(VocabularyConfig(num_velocity_bins=num_velocity_bins))
    frame_times = np.arange(n_frames) * 0.008
    times, values = _events(nsq, notes, duration, onsets_only, trim)
    before = tokenizer.CALLS
    native = transforms.encode_note_events(
        times, values, codec, frame_times, include_ties=not onsets_only)
    assert tokenizer.CALLS == before + 1
    python = _python(times, values, codec, frame_times,
                     include_ties=not onsets_only)
    jax = _jax(notes, duration, frame_times, num_velocity_bins,
               onsets_only, trim)
    for name, a, b, c in zip(NAMES, native, python, jax):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f'{name}: native vs Python')
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c),
                                      err_msg=f'{name}: port vs JAX')
    return native


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_seeded_songs_equal_python_and_jax(seed):
    rng = np.random.default_rng(seed)
    events = _check(_notes(rng, 120, 20.0), 20.0, int(20.0 * 125))[0]
    assert len(events) > 120


def test_empty_song():
    _check([], 1.0, 10)


def test_onsets_only():
    rng = np.random.default_rng(3)
    _check(_notes(rng, 30, 5.0), 5.0, int(5.0 * 125), onsets_only=True,
           trim=False)


def test_multi_velocity_bins():
    rng = np.random.default_rng(4)
    _check(_notes(rng, 50, 8.0), 8.0, int(8.0 * 125), num_velocity_bins=127,
           trim=False)


def test_tokenize_song_takes_the_native_path():
    rng = np.random.default_rng(5)
    ns = _song(nsq, _notes(rng, 40, 6.0), 6.0)
    audio = np.zeros(16000 * 6, np.float32)
    codec = build_codec(VocabularyConfig(num_velocity_bins=1))
    before = tokenizer.CALLS
    song = transforms.tokenize_song(ns, audio, codec)
    assert tokenizer.CALLS == before + 1
    assert transforms.NATIVE_FALLBACK is None
    assert song.num_frames == len(song.event_start_indices) == 750


def test_a_built_librarys_error_propagates():
    """The core refuses a song of no frames (rc -1): its RuntimeError
    reaches the caller, where the JAX package swallows it and retries on
    its Python path."""
    codec = build_codec(VocabularyConfig(num_velocity_bins=1))
    assert tokenizer.native_available()
    before = tokenizer.CALLS
    with pytest.raises(RuntimeError, match='mt3_encode_song failed: -1'):
        transforms.encode_note_events([], [], codec, np.zeros(0))
    assert tokenizer.CALLS == before
    assert transforms.NATIVE_FALLBACK is None


def test_unbuildable_library_falls_back_and_warns_once(monkeypatch):
    """Where the library cannot be built, the Python path is taken, with
    the compiler's message warned once and kept in NATIVE_FALLBACK."""
    codec = build_codec(VocabularyConfig(num_velocity_bins=1))

    def no_build():
        raise RuntimeError('native library tokenizer.cc: g++ failed: boom')
    monkeypatch.setattr(tokenizer.LIBRARY, 'load', no_build)
    monkeypatch.setattr(transforms, 'NATIVE_FALLBACK', None)
    rng = np.random.default_rng(6)
    times, values = _events(nsq, _notes(rng, 20, 4.0), 4.0)
    frame_times = np.arange(500) * 0.008
    before = tokenizer.CALLS
    with pytest.warns(RuntimeWarning, match='boom'):
        got = transforms.encode_note_events(times, values, codec, frame_times)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        transforms.encode_note_events(times, values, codec, frame_times)
    assert tokenizer.CALLS == before
    assert 'boom' in transforms.NATIVE_FALLBACK
    for a, b in zip(got, _python(times, values, codec, frame_times)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
