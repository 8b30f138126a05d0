"""Run-length encoding of timed events + token-stream transforms.

Host-side hot path of the tokenizer. Behavior-compatible with the reference
(reference: contrib/run_length_encoding.py:81-248 for encode/decode;
dataset/dataset_2_random.py:198-279,425-458 for the segment-level token
transforms, which the reference implements as dataset methods but are pure
functions of (tokens, codec) and live here instead).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from mr_mt3_tpu_torch.codec.events import Codec, Event


@dataclasses.dataclass
class EventEncodingSpec:
    """Bundle of callbacks defining one event-stream encoding.

    Mirrors the reference spec (reference: contrib/run_length_encoding.py:39-58).
    """
    init_encoding_state_fn: Callable[[], Any]
    encode_event_fn: Callable[[Any, Any, Codec], Sequence[Event]]
    encoding_state_to_events_fn: Optional[Callable[[Any], Sequence[Event]]]
    init_decoding_state_fn: Callable[[], Any]
    begin_decoding_segment_fn: Callable[[Any], None]
    decode_event_fn: Callable[[Any, float, Event, Codec], None]
    flush_decoding_state_fn: Callable[[Any], Any]


def encode_and_index_events(
    state: Any,
    event_times: Sequence[float],
    event_values: Sequence[Any],
    encode_event_fn: Callable[[Any, Any, Codec], Sequence[Event]],
    codec: Codec,
    frame_times: Sequence[float],
    encoding_state_to_events_fn: Optional[
        Callable[[Any], Sequence[Event]]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Encode timed events into unit-shift token streams indexed by frame.

    Emits one shift(1) token per time step (to be run-length collapsed later by
    run_length_encode_shifts) and records, for every audio frame, the event
    index where that frame's token span starts/ends plus the index into the
    "state event" stream describing already-active notes at that frame.

    Returns (events, event_start_indices, event_end_indices, state_events,
    state_event_indices), matching the reference semantics exactly
    (reference: contrib/run_length_encoding.py:81-189).
    """
    indices = np.argsort(event_times, kind='stable')
    event_steps = [round(event_times[i] * codec.steps_per_second)
                   for i in indices]
    event_values = [event_values[i] for i in indices]

    shift_token = codec.encode_event(Event(type='shift', value=1))
    frame_times = np.asarray(frame_times, dtype=np.float64)
    num_frames = len(frame_times)
    sps = codec.steps_per_second

    events: List[int] = []
    state_events: List[int] = []
    event_start_indices: List[int] = []
    state_event_indices: List[int] = []

    cur_step = 0
    cur_event_idx = 0
    cur_state_event_idx = 0

    def fill_frames_to_cur_step():
        nonlocal cur_event_idx, cur_state_event_idx
        cur_time = cur_step / sps
        while (len(event_start_indices) < num_frames and
               frame_times[len(event_start_indices)] < cur_time):
            event_start_indices.append(cur_event_idx)
            state_event_indices.append(cur_state_event_idx)

    for event_step, event_value in zip(event_steps, event_values):
        while event_step > cur_step:
            events.append(shift_token)
            cur_step += 1
            fill_frames_to_cur_step()
            cur_event_idx = len(events)
            cur_state_event_idx = len(state_events)
        if encoding_state_to_events_fn:
            # Snapshot the encoding state *before* applying this event, so a
            # segment starting here sees the set of notes active at its onset.
            for e in encoding_state_to_events_fn(state):
                state_events.append(codec.encode_event(e))
        for e in encode_event_fn(state, event_value, codec):
            events.append(codec.encode_event(e))

    # Trailing shifts to cover every frame. Non-strict inequality: a step that
    # lands exactly on a frame start still needs one more shift to cover it.
    while cur_step / sps <= frame_times[-1]:
        events.append(shift_token)
        cur_step += 1
        fill_frames_to_cur_step()
        cur_event_idx = len(events)

    event_end_indices = event_start_indices[1:] + [len(events)]

    return (np.array(events), np.array(event_start_indices),
            np.array(event_end_indices), np.array(state_events),
            np.array(state_event_indices))


def decode_events(
    state: Any,
    tokens: np.ndarray,
    start_time: float,
    max_time: Optional[float],
    codec: Codec,
    decode_event_fn: Callable[[Any, float, Event, Codec], None],
) -> Tuple[int, int]:
    """Replay a token stream through a decoding state machine.

    Tolerant of invalid tokens (counted, skipped) and drops events at or past
    max_time (reference: contrib/run_length_encoding.py:192-248). Shift tokens
    carry *absolute* step counts within the segment (see
    run_length_encode_shifts), hence cur_steps accumulation then reset.
    """
    invalid_events = 0
    dropped_events = 0
    cur_steps = 0
    cur_time = start_time
    for token_idx, token in enumerate(tokens):
        try:
            event = codec.decode_event_index(token)
        except ValueError:
            invalid_events += 1
            continue
        if event.type == 'shift':
            cur_steps += event.value
            cur_time = start_time + cur_steps / codec.steps_per_second
            if max_time and cur_time > max_time:
                dropped_events = len(tokens) - token_idx
                break
        else:
            cur_steps = 0
            try:
                decode_event_fn(state, cur_time, event, codec)
            except ValueError:
                invalid_events += 1
                continue
    return invalid_events, dropped_events


# ---- segment-level token transforms (dataset/augmentation side) ----

def run_length_encode_shifts(
    tokens: np.ndarray,
    codec: Codec,
    state_change_event_types: Sequence[str] = ('velocity', 'program'),
    drop_redundant_state_changes: bool = True,
) -> np.ndarray:
    """Collapse unit shifts into absolute-step shift tokens.

    Within a segment, runs of shift(1) tokens are replaced by tokens encoding
    the *absolute* step offset from segment start (chunked by max_shift_steps),
    and trailing shifts after the last event are dropped. Optionally removes
    state-change events (velocity/program) that repeat the current state —
    matching the reference's `_run_length_encode_shifts`
    (reference: dataset/dataset_2_random.py:198-248), where the redundancy
    filter is skipped when token-order randomization handles it later.
    """
    ranges = [codec.event_type_range(t) for t in state_change_event_types]
    current_state = np.zeros(len(ranges), dtype=np.int64)

    shift_steps = 0
    total_shift_steps = 0
    out: List[int] = []

    for token in np.asarray(tokens):
        token = int(token)
        if codec.is_shift_event_index(token):
            shift_steps += 1
            total_shift_steps += 1
            continue

        if drop_redundant_state_changes:
            is_redundant = False
            for i, (lo, hi) in enumerate(ranges):
                if lo <= token <= hi:
                    if current_state[i] == token:
                        is_redundant = True
                    current_state[i] = token
            if is_redundant:
                continue

        if shift_steps > 0:
            # Emit the absolute step count since segment start.
            shift_steps = total_shift_steps
            while shift_steps > 0:
                emit = min(codec.max_shift_steps, shift_steps)
                out.append(emit)
                shift_steps -= emit
        out.append(token)

    return np.array(out, dtype=np.int64)


def remove_redundant_state_changes(
    tokens: np.ndarray,
    codec: Codec,
    state_change_event_types: Sequence[str] = ('velocity', 'program'),
) -> np.ndarray:
    """Drop state-change tokens equal to the running state.

    (reference: dataset/dataset_2_random.py:250-279 `_remove_redundant_tokens`)
    """
    ranges = [codec.event_type_range(t) for t in state_change_event_types]
    current_state = np.zeros(len(ranges), dtype=np.int64)
    out: List[int] = []
    for token in np.asarray(tokens):
        token = int(token)
        is_redundant = False
        for i, (lo, hi) in enumerate(ranges):
            if lo <= token <= hi:
                if current_state[i] == token:
                    is_redundant = True
                current_state[i] = token
        if not is_redundant:
            out.append(token)
    return np.array(out, dtype=np.int64)


def randomize_token_order(
    tokens: np.ndarray,
    codec: Codec,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Shuffle note groups within each shift step (training augmentation).

    Between consecutive shift tokens, tokens form groups of
    [program, velocity, pitch] (3) or [velocity, pitch-or-drum] (2); groups are
    permuted uniformly. Tokens before the first shift and from the last shift
    onward are untouched (reference: dataset/dataset_2_random.py:425-458,
    which round-trips through token *names*; this operates on ids directly).
    """
    if rng is None:
        rng = np.random.default_rng()
    tokens = np.asarray(tokens)
    prog_lo, prog_hi = codec.event_type_range('program')
    vel_lo, vel_hi = codec.event_type_range('velocity')

    shift_idx = [i for i, t in enumerate(tokens)
                 if codec.is_shift_event_index(int(t))]
    if not shift_idx:
        return tokens.copy()

    out: List[int] = list(tokens[:shift_idx[0]])
    for j in range(len(shift_idx) - 1):
        out.append(int(tokens[shift_idx[j]]))
        seg = tokens[shift_idx[j] + 1:shift_idx[j + 1]]
        groups: List[List[int]] = []
        ptr = 0
        while ptr < len(seg):
            t = int(seg[ptr])
            if prog_lo <= t <= prog_hi:
                groups.append([int(x) for x in seg[ptr:ptr + 3]])
                ptr += 3
            elif vel_lo <= t <= vel_hi:
                groups.append([int(x) for x in seg[ptr:ptr + 2]])
                ptr += 2
            else:
                # Mirrors the reference: a group not led by program/velocity is
                # silently dropped (cannot occur in well-formed streams).
                ptr += 1
        order = np.arange(len(groups))
        rng.shuffle(order)
        for idx in order:
            out.extend(groups[idx])
    out.extend(int(x) for x in tokens[shift_idx[-1]:])
    return np.array(out, dtype=np.int64)
