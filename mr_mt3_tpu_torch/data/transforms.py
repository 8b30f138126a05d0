"""Pure per-song / per-segment transforms shared by the dataset pipelines
(copy of mr_mt3_tpu/data/transforms.py; the tokenizer prefers the native
core, native/tokenizer.cc).

These are standalone-function rebuilds of the reference's dataset methods
(reference: dataset/dataset_2_random.py:81-344 and the segmem-prev overrides
in dataset/dataset_2_random_segmem_prev.py:50-157). One deliberate design
change: the spectrogram is NOT computed here — datasets emit raw audio
segments plus a valid-frame count, and the log-mel runs inside the train
step on the device (train/trainer.py::batch_to_mel); the reference burns
dataloader CPU on torchaudio DSP instead (reference call stack SURVEY
§3.1).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional

import numpy as np

from mr_mt3_tpu_torch.audio.frontend import SpectrogramConfig
from mr_mt3_tpu_torch.codec import rle
from mr_mt3_tpu_torch.codec import note_sequences as nsq
from mr_mt3_tpu_torch.codec import vocabulary as vocab_lib
from mr_mt3_tpu_torch.codec.events import Codec
from mr_mt3_tpu_torch.native import tokenizer


@dataclasses.dataclass
class SongFeatures:
    """Whole-song tokenization output, indexable by audio frame."""
    audio: np.ndarray                 # (num_frames * hop,) float32
    frame_times: np.ndarray           # (num_frames,)
    events: np.ndarray                # unit-shift token stream
    event_start_indices: np.ndarray   # (num_frames,)
    event_end_indices: np.ndarray     # (num_frames,)
    state_events: np.ndarray
    state_event_indices: np.ndarray   # (num_frames,)

    @property
    def num_frames(self) -> int:
        return len(self.frame_times)


def tokenize_song(
    ns: nsq.NoteSequence,
    audio: np.ndarray,
    codec: Codec,
    spectrogram_config: SpectrogramConfig = SpectrogramConfig(),
    is_train: bool = True,
    include_ties: bool = True,
    onsets_only: bool = False,
) -> SongFeatures:
    """Merge-and-RLE an entire song (reference: dataset_2_random.py:109-172).

    `ns` must already hold all stems with programs/is_drum assigned.
    """
    hop = spectrogram_config.hop_width
    audio = np.asarray(audio, dtype=np.float32)
    if len(audio) % hop != 0:
        audio = np.pad(audio, (0, hop - len(audio) % hop))
    num_frames = len(audio) // hop
    frame_times = np.arange(num_frames) / spectrogram_config.frames_per_second

    nsq.assign_instruments(ns)
    nsq.validate_note_sequence(ns)
    if is_train:
        ns = nsq.trim_overlapping_notes(ns)

    if onsets_only:
        times, values = nsq.note_sequence_to_onsets(ns)
    else:
        times, values = nsq.note_sequence_to_onsets_and_offsets_and_programs(
            ns)

    (events, event_start_indices, event_end_indices, state_events,
     state_event_indices) = encode_note_events(
        times, values, codec, frame_times, include_ties=include_ties)

    return SongFeatures(
        audio=audio,
        frame_times=frame_times,
        events=events,
        event_start_indices=event_start_indices,
        event_end_indices=event_end_indices,
        state_events=state_events,
        state_event_indices=state_event_indices)


# the compiler's message where the native tokenizer could not be built and
# the Python path was taken instead (warned once); None while it never was
NATIVE_FALLBACK: Optional[str] = None


def encode_note_events(times, values, codec: Codec, frame_times,
                       include_ties: bool = True):
    """RLE-encode note events, preferring the native C++ tokenizer core.

    The native path (native/tokenizer.cc) is held equal to the Python
    loop; the Python path is the reference and the fallback where the
    library cannot be built (warned once, NATIVE_FALLBACK). Unlike the JAX
    package, which falls back on any exception, an error inside a built
    library's call propagates.
    """
    global NATIVE_FALLBACK
    try:
        tokenizer.LIBRARY.load()
    except RuntimeError as e:
        if NATIVE_FALLBACK is None:
            NATIVE_FALLBACK = str(e)
            warnings.warn(f'native tokenizer unavailable, taking the '
                          f'Python path: {e}', RuntimeWarning)
    else:
        nbins = vocab_lib.num_velocity_bins_from_codec(codec)
        n = len(values)
        pitches = np.fromiter((v.pitch for v in values), np.int32, n)
        vbins = np.fromiter(
            (-1 if v.velocity is None else
             vocab_lib.velocity_to_bin(v.velocity, nbins)
             for v in values), np.int32, n)
        programs = np.fromiter(
            (-1 if v.program is None else v.program
             for v in values), np.int32, n)
        drums = np.fromiter(
            (1 if v.is_drum else 0 for v in values), np.uint8, n)
        return tokenizer.encode_and_index_events_native(
            times, pitches, vbins, programs, drums, codec,
            frame_times, include_ties=include_ties)
    return rle.encode_and_index_events(
        state=nsq.NoteEncodingState() if include_ties else None,
        event_times=times,
        event_values=values,
        encode_event_fn=nsq.note_event_data_to_events,
        codec=codec,
        frame_times=frame_times,
        encoding_state_to_events_fn=(
            nsq.note_encoding_state_to_events if include_ties else None))


@dataclasses.dataclass
class FrameWindow:
    """A contiguous frame range [start, start + length) into a song."""
    start: int
    length: int


def split_frames(num_frames: int, length: int) -> List[FrameWindow]:
    """Non-overlapping windows of `length` frames; a final partial window is
    dropped *unless* it is the only one (reference: _split_frame,
    dataset_2_random.py:308-327 — note `continue` on the tail)."""
    windows = [FrameWindow(start, length)
               for start in range(0, num_frames, length)
               if start + length < num_frames]
    if not windows:
        return [FrameWindow(0, num_frames)]
    return windows


def random_chunk(window: FrameWindow, mel_length: int,
                 rng: Optional[np.random.Generator],
                 deterministic_start: int = 0) -> FrameWindow:
    """Pick a random mel_length sub-window (reference: _random_chunk)."""
    slack = window.length - mel_length
    if slack < 1:
        return window
    if rng is None:
        start = deterministic_start
    else:
        start = int(rng.integers(0, slack + 1))
    return FrameWindow(window.start + start, mel_length)


def extract_segment_tokens(song: SongFeatures, window: FrameWindow,
                           codec: Codec,
                           tie_token: Optional[int]) -> np.ndarray:
    """Token span for a frame window, with its tie-state prefix.

    (reference: _extract_target_sequence_with_indices,
    dataset_2_random.py:174-196)
    """
    f0 = window.start
    f1 = min(window.start + window.length, song.num_frames)
    start_idx = song.event_start_indices[f0]
    end_idx = song.event_end_indices[f1 - 1]
    tokens = song.events[start_idx:end_idx]
    if tie_token is not None:
        s0 = song.state_event_indices[f0]
        s1 = s0 + 1
        while song.state_events[s1 - 1] != tie_token:
            s1 += 1
        tokens = np.concatenate([song.state_events[s0:s1], tokens])
    return tokens


def segment_audio(song: SongFeatures, window: FrameWindow, mel_length: int,
                  hop: int) -> tuple:
    """(audio padded to mel_length*hop, valid frame count, start time)."""
    f0 = window.start
    f1 = min(window.start + window.length, song.num_frames)
    n = f1 - f0
    out = np.zeros(mel_length * hop, dtype=np.float32)
    out[:n * hop] = song.audio[f0 * hop:f1 * hop]
    return out, n, song.frame_times[f0]


def finalize_targets(tokens: np.ndarray, codec: Codec, event_length: int,
                     num_special_tokens: int = 3,
                     eos_id: int = 1) -> np.ndarray:
    """Crop/offset/EOS/pad to the model target format.

    Matches _pad_length (reference: dataset_2_random.py:292-306): +special
    offset, truncate to event_length, append EOS, pad with -100.
    """
    t = np.asarray(tokens[:event_length], dtype=np.int64) + num_special_tokens
    if len(t) < event_length:
        pad = np.full(event_length - len(t) - 1, -100, dtype=np.int64)
        t = np.concatenate([t, [eos_id], pad])
    return t


def augment_token_order(tokens: np.ndarray, codec: Codec,
                        rng: np.random.Generator) -> np.ndarray:
    """Random note-order augmentation + redundancy removal
    (reference: dataset_2_random.py:409-414)."""
    t = rle.randomize_token_order(tokens, codec, rng)
    return rle.remove_redundant_state_changes(t, codec)


# The no-previous-segment memory seed, in DECODED space (reference:
# dataset_2_random_segmem_prev.py:94). Deliberately bug-compatible: the
# reference's `1` here is (presumably) meant as EOS, but it passes
# through the same +3 special-token offset as real tokens
# (dataset_2_random_segmem_prev.py:106-107) and becomes model-space 4 —
# a one-step shift event — before _pad_length appends the actual EOS.
# Trained segmem models therefore expect [tie, shift-1, EOS] as the
# empty memory; "fixing" it would change the training distribution.
EMPTY_PREV_TOKENS = np.array([1131, 1])
