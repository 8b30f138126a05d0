"""Vocabulary config, codec construction, and model-token mapping.

Behavior-compatible with the reference (reference: contrib/vocabularies.py).
The model vocabulary prepends 3 special tokens (PAD=0, EOS=1, UNK=2) to the
codec's event ids and reserves 100 extra ids; embedding count is rounded up
to a multiple of 128 for TPU efficiency (1536 for the standard config).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from mr_mt3_tpu_torch.codec.events import Codec, EventRange

DECODED_EOS_ID = -1
DECODED_INVALID_ID = -2

DEFAULT_STEPS_PER_SECOND = 100
DEFAULT_MAX_SHIFT_SECONDS = 10
DEFAULT_NUM_VELOCITY_BINS = 127

# MIDI constants (the reference pulls these from note_seq).
MIN_MIDI_PITCH = 0
MAX_MIDI_PITCH = 127
MIN_MIDI_PROGRAM = 0
MAX_MIDI_PROGRAM = 127
MAX_MIDI_VELOCITY = 127

# t5.data.DEFAULT_EXTRA_IDS in the reference.
DEFAULT_EXTRA_IDS = 100


@dataclasses.dataclass
class VocabularyConfig:
    """Vocabulary configuration (reference: contrib/vocabularies.py:37-53)."""
    steps_per_second: int = DEFAULT_STEPS_PER_SECOND
    max_shift_seconds: int = DEFAULT_MAX_SHIFT_SECONDS
    num_velocity_bins: int = DEFAULT_NUM_VELOCITY_BINS

    @property
    def abbrev_str(self) -> str:
        s = ''
        if self.steps_per_second != DEFAULT_STEPS_PER_SECOND:
            s += 'ss%d' % self.steps_per_second
        if self.max_shift_seconds != DEFAULT_MAX_SHIFT_SECONDS:
            s += 'ms%d' % self.max_shift_seconds
        if self.num_velocity_bins != DEFAULT_NUM_VELOCITY_BINS:
            s += 'vb%d' % self.num_velocity_bins
        return s


def build_codec(vocab_config: VocabularyConfig) -> Codec:
    """Standard MT3 event layout (reference: contrib/vocabularies.py:118-139)."""
    event_ranges = [
        EventRange('pitch', MIN_MIDI_PITCH, MAX_MIDI_PITCH),
        # velocity bin 0 is note-off
        EventRange('velocity', 0, vocab_config.num_velocity_bins),
        # marks the end of the segment-initial "already sounding" declaration
        EventRange('tie', 0, 0),
        EventRange('program', MIN_MIDI_PROGRAM, MAX_MIDI_PROGRAM),
        EventRange('drum', MIN_MIDI_PITCH, MAX_MIDI_PITCH),
    ]
    return Codec(
        max_shift_steps=(vocab_config.steps_per_second *
                         vocab_config.max_shift_seconds),
        steps_per_second=vocab_config.steps_per_second,
        event_ranges=event_ranges)


def num_velocity_bins_from_codec(codec: Codec) -> int:
    lo, hi = codec.event_type_range('velocity')
    return hi - lo


def velocity_to_bin(velocity: int, num_velocity_bins: int) -> int:
    if velocity == 0:
        return 0
    return math.ceil(num_velocity_bins * velocity / MAX_MIDI_VELOCITY)


def bin_to_velocity(velocity_bin: int, num_velocity_bins: int) -> int:
    if velocity_bin == 0:
        return 0
    return int(MAX_MIDI_VELOCITY * velocity_bin / num_velocity_bins)


class TokenVocabulary:
    """Model-token <-> codec-token mapping with special-token handling.

    Equivalent to the reference's GenericTokenVocabulary
    (reference: contrib/vocabularies.py:147-281) without the seqio base class.
    Special tokens: PAD=0, EOS=1, UNK=2; codec ids are offset by 3.
    """

    def __init__(self, regular_ids: int, extra_ids: int = 0):
        self._num_special_tokens = 3
        self._num_regular_tokens = regular_ids
        self.extra_ids = extra_ids

    @property
    def eos_id(self) -> int:
        return 1

    @property
    def pad_id(self) -> int:
        return 0

    @property
    def unk_id(self) -> int:
        return 2

    @property
    def _base_vocab_size(self) -> int:
        return self._num_special_tokens + self._num_regular_tokens

    @property
    def vocab_size(self) -> int:
        return self._base_vocab_size + self.extra_ids

    def num_special_tokens(self) -> int:
        return self._num_special_tokens

    def encode(self, token_ids: Sequence[int]) -> list:
        """Codec ids -> model ids (shift up past the special tokens)."""
        out = []
        for token_id in token_ids:
            if not 0 <= token_id < self._num_regular_tokens:
                raise ValueError(
                    f'token_id {token_id} does not fall within valid range of '
                    f'[0, {self._num_regular_tokens})')
            out.append(int(token_id) + self._num_special_tokens)
        return out

    def decode(self, ids: Sequence[int]) -> list:
        """Model ids -> codec ids; EOS -> -1, PAD/UNK/extra -> -2."""
        out = []
        for i in ids:
            i = int(i)
            if i == self.eos_id:
                out.append(DECODED_EOS_ID)
            elif i < self._num_special_tokens or i >= self._base_vocab_size:
                out.append(DECODED_INVALID_ID)
            else:
                out.append(i - self._num_special_tokens)
        return out

    def encode_array(self, token_ids: np.ndarray) -> np.ndarray:
        """Vectorized encode (no range check)."""
        return np.asarray(token_ids) + self._num_special_tokens

    def decode_array(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized decode: EOS -> -1, other specials / OOV -> -2."""
        ids = np.asarray(ids)
        out = ids - self._num_special_tokens
        invalid = ((ids < self._num_special_tokens) |
                   (ids >= self._base_vocab_size))
        out = np.where(invalid, DECODED_INVALID_ID, out)
        return np.where(ids == self.eos_id, DECODED_EOS_ID, out)

    def __eq__(self, other) -> bool:
        return (self.extra_ids == other.extra_ids and
                self._num_regular_tokens == other._num_regular_tokens)


def vocabulary_from_codec(codec: Codec) -> TokenVocabulary:
    return TokenVocabulary(codec.num_classes, extra_ids=DEFAULT_EXTRA_IDS)


def num_embeddings(vocabulary: TokenVocabulary) -> int:
    """Vocabulary size padded to a multiple of 128 for TPU lane alignment."""
    return 128 * math.ceil(vocabulary.vocab_size / 128)


# ---- program granularity (used by eval and token post-processing) ----

def drop_programs(tokens: np.ndarray, codec: Codec) -> np.ndarray:
    """Remove program-change tokens (reference: contrib/vocabularies.py:76-79)."""
    min_program_id, max_program_id = codec.event_type_range('program')
    tokens = np.asarray(tokens)
    return tokens[(tokens < min_program_id) | (tokens > max_program_id)]


def programs_to_midi_classes(tokens: np.ndarray, codec: Codec) -> np.ndarray:
    """Map each program token to the first program of its MIDI class."""
    min_program_id, max_program_id = codec.event_type_range('program')
    tokens = np.asarray(tokens)
    is_program = (tokens >= min_program_id) & (tokens <= max_program_id)
    return np.where(is_program,
                    min_program_id + 8 * ((tokens - min_program_id) // 8),
                    tokens)


@dataclasses.dataclass
class ProgramGranularity:
    tokens_map_fn: object
    program_map_fn: object


PROGRAM_GRANULARITIES = {
    'flat': ProgramGranularity(
        tokens_map_fn=drop_programs,
        program_map_fn=lambda program: 0),
    'midi_class': ProgramGranularity(
        tokens_map_fn=programs_to_midi_classes,
        program_map_fn=lambda program: 8 * (program // 8)),
    'full': ProgramGranularity(
        tokens_map_fn=lambda tokens, codec: tokens,
        program_map_fn=lambda program: program),
}
