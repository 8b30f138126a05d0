"""ctypes wrapper for the native tokenizer core (copy of
mr_mt3_tpu/native/tokenizer.py; the C++ is native/tokenizer.cc, built by g++
at first use, see native/_loader.py).

encode_and_index_events_native has the contract of
codec/rle.py::encode_and_index_events for the standard note-with-ties
pipeline. data/transforms.py::encode_note_events prefers it, and takes the
Python path only where the library cannot be built. CALLS counts the
songs this core encoded, as ops/fast_decode.STEPS counts decode steps.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from mr_mt3_tpu_torch.codec.events import Codec
from mr_mt3_tpu_torch.native import _loader

# songs encoded by the native core (a count for checks; tests zero it)
CALLS = 0


class _TokenizerResult(ctypes.Structure):
    _fields_ = [
        ('events', ctypes.POINTER(ctypes.c_int32)),
        ('n_events', ctypes.c_int64),
        ('event_start_indices', ctypes.POINTER(ctypes.c_int32)),
        ('event_end_indices', ctypes.POINTER(ctypes.c_int32)),
        ('state_events', ctypes.POINTER(ctypes.c_int32)),
        ('n_state_events', ctypes.c_int64),
        ('state_event_indices', ctypes.POINTER(ctypes.c_int32)),
    ]


def _configure(lib: ctypes.CDLL) -> None:
    lib.mt3_encode_song.restype = ctypes.c_int
    lib.mt3_free_result.restype = None


LIBRARY = _loader.LazyNativeLib('tokenizer.cc', _configure)


def native_available() -> bool:
    return LIBRARY.available()


def encode_and_index_events_native(
    event_times: Sequence[float],
    pitches: np.ndarray,
    velocity_bins: np.ndarray,   # -1 = onsets-only value
    programs: np.ndarray,        # -1 = no program
    is_drums: np.ndarray,
    codec: Codec,
    frame_times: np.ndarray,
    include_ties: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Native counterpart of rle.encode_and_index_events for note events.
    Raises RuntimeError if the library cannot be built or the core fails
    (it refuses a song of no frames)."""
    global CALLS
    lib = LIBRARY.load()

    times = np.ascontiguousarray(event_times, dtype=np.float64)
    pitches = np.ascontiguousarray(pitches, dtype=np.int32)
    velocity_bins = np.ascontiguousarray(velocity_bins, dtype=np.int32)
    programs = np.ascontiguousarray(programs, dtype=np.int32)
    is_drums = np.ascontiguousarray(is_drums, dtype=np.uint8)
    frame_times = np.ascontiguousarray(frame_times, dtype=np.float64)

    result = _TokenizerResult()
    shift_one = 1  # shift block starts at 0; shift(1) == 1
    pitch_base = codec.event_type_range('pitch')[0]
    velocity_base = codec.event_type_range('velocity')[0]
    tie_id = codec.event_type_range('tie')[0]
    program_base = codec.event_type_range('program')[0]
    drum_base = codec.event_type_range('drum')[0]

    rc = lib.mt3_encode_song(
        times.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pitches.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        velocity_bins.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        programs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        is_drums.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(times)),
        frame_times.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(frame_times)),
        ctypes.c_double(codec.steps_per_second),
        ctypes.c_int32(shift_one),
        ctypes.c_int32(pitch_base),
        ctypes.c_int32(velocity_base),
        ctypes.c_int32(tie_id),
        ctypes.c_int32(program_base),
        ctypes.c_int32(drum_base),
        ctypes.c_uint8(1 if include_ties else 0),
        ctypes.byref(result))
    if rc != 0:
        raise RuntimeError(f'mt3_encode_song failed: {rc}')
    try:
        n_frames = len(frame_times)
        events = np.ctypeslib.as_array(
            result.events, shape=(result.n_events,)).copy()
        starts = np.ctypeslib.as_array(
            result.event_start_indices, shape=(n_frames,)).copy()
        ends = np.ctypeslib.as_array(
            result.event_end_indices, shape=(n_frames,)).copy()
        state_events = np.ctypeslib.as_array(
            result.state_events, shape=(result.n_state_events,)).copy()
        state_idx = np.ctypeslib.as_array(
            result.state_event_indices, shape=(n_frames,)).copy()
    finally:
        lib.mt3_free_result(ctypes.byref(result))
    CALLS += 1
    return events, starts, ends, state_events, state_idx
