"""Typed musical events <-> contiguous integer token ids.

Behavior matches the reference codec (reference: contrib/event_codec.py:21-112):
'shift' is always the first block starting at id 0; every other event type
occupies a contiguous block of ids in declaration order. Unlike the reference,
range offsets are precomputed so encode/decode are O(1) dict lookups, and
vectorized numpy paths are provided for whole token arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class EventRange:
    type: str
    min_value: int
    max_value: int

    @property
    def size(self) -> int:
        return self.max_value - self.min_value + 1


@dataclasses.dataclass(frozen=True)
class Event:
    type: str
    value: int


class Codec:
    """Maps typed events to ids in a fixed vocabulary layout.

    Args:
      max_shift_steps: shift values span [0, max_shift_steps].
      steps_per_second: duration of one shift step is 1/steps_per_second.
      event_ranges: non-shift event types, in vocabulary order.
    """

    def __init__(self, max_shift_steps: int, steps_per_second: float,
                 event_ranges: List[EventRange]):
        self.steps_per_second = steps_per_second
        shift_range = EventRange('shift', 0, max_shift_steps)
        self._ranges: List[EventRange] = [shift_range] + list(event_ranges)
        names = [r.type for r in self._ranges]
        if len(names) != len(set(names)):
            raise ValueError(f'duplicate event types: {names}')

        # Precompute id offsets per type.
        self._offsets: Dict[str, Tuple[int, EventRange]] = {}
        offset = 0
        for r in self._ranges:
            self._offsets[r.type] = (offset, r)
            offset += r.size
        self._num_classes = offset
        self._max_shift_steps = max_shift_steps

    @property
    def num_classes(self) -> int:
        return self._num_classes

    @property
    def max_shift_steps(self) -> int:
        return self._max_shift_steps

    def is_shift_event_index(self, index: int) -> bool:
        return 0 <= index <= self._max_shift_steps

    def encode_event(self, event: Event) -> int:
        try:
            offset, r = self._offsets[event.type]
        except KeyError:
            raise ValueError(f'Unknown event type: {event.type}')
        if not r.min_value <= event.value <= r.max_value:
            raise ValueError(
                f'Event value {event.value} is not within valid range '
                f'[{r.min_value}, {r.max_value}] for type {event.type}')
        return offset + event.value - r.min_value

    def event_type_range(self, event_type: str) -> Tuple[int, int]:
        """[min_id, max_id] (inclusive) for an event type."""
        try:
            offset, r = self._offsets[event_type]
        except KeyError:
            raise ValueError(f'Unknown event type: {event_type}')
        return offset, offset + r.size - 1

    def decode_event_index(self, index: int) -> Event:
        index = int(index)
        offset = 0
        for r in self._ranges:
            if offset <= index < offset + r.size:
                return Event(type=r.type, value=r.min_value + index - offset)
            offset += r.size
        raise ValueError(f'Unknown event index: {index}')

    # ---- vectorized helpers (new; not present in the reference) ----

    def event_type_of(self, tokens: np.ndarray) -> np.ndarray:
        """Return an int array giving the range index of each token.

        Range index 0 is 'shift'; -1 marks out-of-vocabulary tokens.
        """
        tokens = np.asarray(tokens)
        out = np.full(tokens.shape, -1, dtype=np.int32)
        offset = 0
        for i, r in enumerate(self._ranges):
            mask = (tokens >= offset) & (tokens < offset + r.size)
            out[mask] = i
            offset += r.size
        return out

    @property
    def range_types(self) -> List[str]:
        return [r.type for r in self._ranges]


def token_name(token_idx: int) -> str:
    """Human-readable token name for the standard MT3 vocabulary layout.

    Debug aid matching the reference's table
    (reference: contrib/run_length_encoding.py:61-78).
    """
    t = int(token_idx)
    if 1001 <= t <= 1128:
        return f'pitch_{t - 1001}'
    if 1129 <= t <= 1130:
        return f'velocity_{t - 1129}'
    if t == 1131:
        return 'tie'
    if 1132 <= t <= 1259:
        return f'program_{t - 1132}'
    if 1260 <= t <= 1387:
        return f'drum_{t - 1260}'
    if 0 <= t < 1000:
        # deliberately < 1000, not <= : shift ids actually span 0-1000
        # inclusive (steps_per_second * max_shift_seconds = 1000), but
        # the reference's table has the same off-by-one
        # (run_length_encoding.py:73 `token_idx < 1000`), so shift_1000
        # reports as invalid_1000 there too — kept bug-compatible
        return f'shift_{t}'
    return f'invalid_{t}'


def token_from_name(name: str) -> int:
    """Inverse of token_name (reference: dataset/dataset_2_random.py:479-493)."""
    if 'pitch' in name:
        return int(name.split('_')[1]) + 1001
    if 'velocity' in name:
        return int(name.split('_')[1]) + 1129
    if 'tie' in name:
        return 1131
    if 'program' in name:
        return int(name.split('_')[1]) + 1132
    if 'drum' in name:
        return int(name.split('_')[1]) + 1260
    if 'shift' in name:
        return int(name.split('_')[1])
    raise ValueError(f'cannot parse token name: {name}')
