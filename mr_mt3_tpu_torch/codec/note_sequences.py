"""Note sequences: the symbolic music container + event-codec state machines.

The reference uses the protobuf-backed note_seq.NoteSequence; this framework
has no note_seq dependency, so `NoteSequence`/`Note` here are plain
dataclasses with the same fields the pipeline touches. All helper semantics
match the reference (reference: contrib/note_sequences.py).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Set, Tuple

from mr_mt3_tpu_torch.codec import vocabulary as vocab_lib
from mr_mt3_tpu_torch.codec.events import Codec, Event
from mr_mt3_tpu_torch.codec.rle import EventEncodingSpec

DEFAULT_VELOCITY = 100
DEFAULT_NOTE_DURATION = 0.01
# Quantization can produce zero-length notes; enforce a minimum duration.
MIN_NOTE_DURATION = 0.01

DEFAULT_TICKS_PER_QUARTER = 220


@dataclasses.dataclass
class Note:
    pitch: int
    velocity: int
    start_time: float
    end_time: float
    program: int = 0
    is_drum: bool = False
    instrument: int = 0


@dataclasses.dataclass
class ControlChange:
    time: float
    control_number: int
    control_value: int
    instrument: int = 0
    program: int = 0
    is_drum: bool = False


@dataclasses.dataclass
class PitchBend:
    time: float
    bend: int
    instrument: int = 0
    program: int = 0
    is_drum: bool = False


@dataclasses.dataclass
class NoteSequence:
    """Minimal stand-in for note_seq.NoteSequence."""
    notes: List[Note] = dataclasses.field(default_factory=list)
    total_time: float = 0.0
    ticks_per_quarter: int = DEFAULT_TICKS_PER_QUARTER
    id: str = ''
    control_changes: List[ControlChange] = dataclasses.field(
        default_factory=list)
    pitch_bends: List[PitchBend] = dataclasses.field(default_factory=list)

    def copy(self) -> 'NoteSequence':
        return NoteSequence(
            notes=[dataclasses.replace(n) for n in self.notes],
            total_time=self.total_time,
            ticks_per_quarter=self.ticks_per_quarter,
            id=self.id,
            control_changes=[dataclasses.replace(c)
                             for c in self.control_changes],
            pitch_bends=[dataclasses.replace(p) for p in self.pitch_bends])

    def add_note(self, **kwargs) -> Note:
        note = Note(**kwargs)
        self.notes.append(note)
        return note


@dataclasses.dataclass
class NoteEventData:
    pitch: int
    velocity: Optional[int] = None
    program: Optional[int] = None
    is_drum: Optional[bool] = None
    instrument: Optional[int] = None


@dataclasses.dataclass
class TrackSpec:
    name: str
    program: int = 0
    is_drum: bool = False


def extract_track(ns: NoteSequence, program: int, is_drum: bool) -> NoteSequence:
    track = NoteSequence(ticks_per_quarter=DEFAULT_TICKS_PER_QUARTER)
    track.notes = [note for note in ns.notes
                   if note.program == program and note.is_drum == is_drum]
    track.total_time = (max(note.end_time for note in track.notes)
                        if track.notes else 0.0)
    return track


def trim_overlapping_notes(ns: NoteSequence) -> NoteSequence:
    """Trim overlapping same-channel notes, dropping zero-length results.

    (reference: contrib/note_sequences.py:48-65)
    """
    ns_trimmed = ns.copy()
    channels = set((n.pitch, n.program, n.is_drum) for n in ns_trimmed.notes)
    for pitch, program, is_drum in channels:
        notes = [n for n in ns_trimmed.notes if n.pitch == pitch
                 and n.program == program and n.is_drum == is_drum]
        sorted_notes = sorted(notes, key=lambda n: n.start_time)
        for i in range(1, len(sorted_notes)):
            if sorted_notes[i - 1].end_time > sorted_notes[i].start_time:
                sorted_notes[i - 1].end_time = sorted_notes[i].start_time
    ns_trimmed.notes = [n for n in ns_trimmed.notes
                        if n.start_time < n.end_time]
    return ns_trimmed


def assign_instruments(ns: NoteSequence) -> None:
    """Assign instrument numbers in program-first-seen order; drums get 9.

    (reference: contrib/note_sequences.py:68-80)
    """
    program_instruments: Dict[int, int] = {}
    for note in ns.notes:
        if note.program not in program_instruments and not note.is_drum:
            num_instruments = len(program_instruments)
            note.instrument = (num_instruments if num_instruments < 9
                               else num_instruments + 1)
            program_instruments[note.program] = note.instrument
        elif note.is_drum:
            note.instrument = 9
        else:
            note.instrument = program_instruments[note.program]


def validate_note_sequence(ns: NoteSequence) -> None:
    for note in ns.notes:
        if note.start_time >= note.end_time:
            raise ValueError('note has start time >= end time: %f >= %f' %
                             (note.start_time, note.end_time))
        if note.velocity == 0:
            raise ValueError('note has zero velocity')


def note_arrays_to_note_sequence(
    onset_times: Sequence[float],
    pitches: Sequence[int],
    offset_times: Optional[Sequence[float]] = None,
    velocities: Optional[Sequence[int]] = None,
    programs: Optional[Sequence[int]] = None,
    is_drums: Optional[Sequence[bool]] = None,
) -> NoteSequence:
    """Build a NoteSequence from parallel arrays (reference: :93-125)."""
    ns = NoteSequence(ticks_per_quarter=DEFAULT_TICKS_PER_QUARTER)
    for onset, offset, pitch, velocity, program, is_drum in itertools.zip_longest(
            onset_times, [] if offset_times is None else offset_times,
            pitches, [] if velocities is None else velocities,
            [] if programs is None else programs,
            [] if is_drums is None else is_drums):
        if offset is None:
            offset = onset + DEFAULT_NOTE_DURATION
        ns.add_note(
            start_time=onset, end_time=offset, pitch=pitch,
            velocity=DEFAULT_VELOCITY if velocity is None else velocity,
            program=0 if program is None else program,
            is_drum=False if is_drum is None else is_drum)
        ns.total_time = max(ns.total_time, offset)
    assign_instruments(ns)
    return ns


# ---- NoteSequence -> timed event values ----

def note_sequence_to_onsets(
    ns: NoteSequence,
) -> Tuple[List[float], List[NoteEventData]]:
    # Sort by pitch as a tiebreaker for the later stable time sort.
    notes = sorted(ns.notes, key=lambda n: n.pitch)
    return ([n.start_time for n in notes],
            [NoteEventData(pitch=n.pitch) for n in notes])


def note_sequence_to_onsets_and_offsets(
    ns: NoteSequence,
) -> Tuple[List[float], List[NoteEventData]]:
    """Offsets (velocity 0) listed before onsets as a stable-sort tiebreaker."""
    notes = sorted(ns.notes, key=lambda n: n.pitch)
    times = ([n.end_time for n in notes] + [n.start_time for n in notes])
    values = ([NoteEventData(pitch=n.pitch, velocity=0) for n in notes] +
              [NoteEventData(pitch=n.pitch, velocity=n.velocity)
               for n in notes])
    return times, values


def note_sequence_to_onsets_and_offsets_and_programs(
    ns: NoteSequence,
) -> Tuple[List[float], List[NoteEventData]]:
    """Like the above, plus programs; drums have no offsets.

    (reference: contrib/note_sequences.py:173-200)
    """
    notes = sorted(ns.notes, key=lambda n: (n.is_drum, n.program, n.pitch))
    times = ([n.end_time for n in notes if not n.is_drum] +
             [n.start_time for n in notes])
    values = ([NoteEventData(pitch=n.pitch, velocity=0,
                             program=n.program, is_drum=False)
               for n in notes if not n.is_drum] +
              [NoteEventData(pitch=n.pitch, velocity=n.velocity,
                             program=n.program, is_drum=n.is_drum)
               for n in notes])
    return times, values


# ---- encoding state (tracks active pitches for tie sections) ----

@dataclasses.dataclass
class NoteEncodingState:
    # (pitch, program) -> velocity bin for active notes
    active_pitches: Dict[Tuple[int, int], int] = dataclasses.field(
        default_factory=dict)


def note_event_data_to_events(
    state: Optional[NoteEncodingState],
    value: NoteEventData,
    codec: Codec,
) -> Sequence[Event]:
    """NoteEventData -> events (reference: contrib/note_sequences.py:211-242)."""
    if value.velocity is None:
        # onsets only
        return [Event('pitch', value.pitch)]
    num_velocity_bins = vocab_lib.num_velocity_bins_from_codec(codec)
    velocity_bin = vocab_lib.velocity_to_bin(value.velocity, num_velocity_bins)
    if value.program is None:
        if state is not None:
            state.active_pitches[(value.pitch, 0)] = velocity_bin
        return [Event('velocity', velocity_bin), Event('pitch', value.pitch)]
    if value.is_drum:
        # drums use a separate vocabulary and carry no offsets
        return [Event('velocity', velocity_bin), Event('drum', value.pitch)]
    if state is not None:
        state.active_pitches[(value.pitch, value.program)] = velocity_bin
    return [Event('program', value.program),
            Event('velocity', velocity_bin),
            Event('pitch', value.pitch)]


def note_encoding_state_to_events(
    state: NoteEncodingState,
) -> Sequence[Event]:
    """Declare active notes (program+pitch pairs) then a tie event.

    Ordered by (program, pitch) — the reference sorts keys by reversed tuple
    (reference: contrib/note_sequences.py:245-256).
    """
    events = []
    for pitch, program in sorted(state.active_pitches.keys(),
                                 key=lambda k: k[::-1]):
        if state.active_pitches[(pitch, program)]:
            events += [Event('program', program), Event('pitch', pitch)]
    events.append(Event('tie', 0))
    return events


# ---- decoding state machine ----

@dataclasses.dataclass
class NoteDecodingState:
    current_time: float = 0.0
    current_velocity: int = DEFAULT_VELOCITY
    current_program: int = 0
    # (pitch, program) -> (onset time, onset velocity)
    active_pitches: Dict[Tuple[int, int], Tuple[float, int]] = (
        dataclasses.field(default_factory=dict))
    tied_pitches: Set[Tuple[int, int]] = dataclasses.field(default_factory=set)
    is_tie_section: bool = False
    note_sequence: NoteSequence = dataclasses.field(
        default_factory=lambda: NoteSequence(
            ticks_per_quarter=DEFAULT_TICKS_PER_QUARTER))


def decode_note_onset_event(
    state: NoteDecodingState,
    time: float,
    event: Event,
    codec: Codec,
) -> None:
    """Onset-only decoding (reference: contrib/note_sequences.py:281-295)."""
    if event.type == 'pitch':
        state.note_sequence.add_note(
            start_time=time, end_time=time + DEFAULT_NOTE_DURATION,
            pitch=event.value, velocity=DEFAULT_VELOCITY)
        state.note_sequence.total_time = max(
            state.note_sequence.total_time, time + DEFAULT_NOTE_DURATION)
    else:
        raise ValueError('unexpected event type: %s' % event.type)


def _add_note_to_sequence(
    ns: NoteSequence,
    start_time: float, end_time: float, pitch: int, velocity: int,
    program: int = 0, is_drum: bool = False,
) -> None:
    end_time = max(end_time, start_time + MIN_NOTE_DURATION)
    ns.add_note(
        start_time=start_time, end_time=end_time,
        pitch=int(pitch), velocity=int(velocity), program=int(program),
        is_drum=is_drum)
    ns.total_time = max(ns.total_time, end_time)


def decode_note_event(
    state: NoteDecodingState,
    time: float,
    event: Event,
    codec: Codec,
) -> None:
    """Full decoding state machine (reference: contrib/note_sequences.py:310-385).

    Deliberately tolerant: semantic violations raise ValueError which the
    caller (decode_events) counts as invalid and skips.
    """
    if time < state.current_time:
        raise ValueError('event time < current time, %f < %f' % (
            time, state.current_time))
    state.current_time = time
    if event.type == 'pitch':
        pitch = event.value
        key = (pitch, state.current_program)
        if state.is_tie_section:
            if key not in state.active_pitches:
                raise ValueError('inactive pitch/program in tie section: %d/%d'
                                 % key)
            if key in state.tied_pitches:
                raise ValueError('pitch/program is already tied: %d/%d' % key)
            state.tied_pitches.add(key)
        elif state.current_velocity == 0:
            # note offset
            if key not in state.active_pitches:
                raise ValueError('note-off for inactive pitch/program: %d/%d'
                                 % key)
            onset_time, onset_velocity = state.active_pitches.pop(key)
            _add_note_to_sequence(
                state.note_sequence, start_time=onset_time, end_time=time,
                pitch=pitch, velocity=onset_velocity,
                program=state.current_program)
        else:
            # note onset; if already active, close the old note first
            if key in state.active_pitches:
                onset_time, onset_velocity = state.active_pitches.pop(key)
                _add_note_to_sequence(
                    state.note_sequence, start_time=onset_time, end_time=time,
                    pitch=pitch, velocity=onset_velocity,
                    program=state.current_program)
            state.active_pitches[key] = (time, state.current_velocity)
    elif event.type == 'drum':
        if state.current_velocity == 0:
            raise ValueError('velocity cannot be zero for drum event')
        _add_note_to_sequence(
            state.note_sequence, start_time=time,
            end_time=time + DEFAULT_NOTE_DURATION,
            pitch=event.value, velocity=state.current_velocity, is_drum=True)
    elif event.type == 'velocity':
        num_velocity_bins = vocab_lib.num_velocity_bins_from_codec(codec)
        state.current_velocity = vocab_lib.bin_to_velocity(
            event.value, num_velocity_bins)
    elif event.type == 'program':
        state.current_program = event.value
    elif event.type == 'tie':
        if not state.is_tie_section:
            raise ValueError('tie section end event when not in tie section')
        # close active notes that weren't declared tied
        for key in list(state.active_pitches.keys()):
            if key not in state.tied_pitches:
                onset_time, onset_velocity = state.active_pitches.pop(key)
                _add_note_to_sequence(
                    state.note_sequence,
                    start_time=onset_time, end_time=state.current_time,
                    pitch=key[0], velocity=onset_velocity, program=key[1])
        state.is_tie_section = False
    else:
        raise ValueError('unexpected event type: %s' % event.type)


def begin_tied_pitches_section(state: NoteDecodingState) -> None:
    state.tied_pitches = set()
    state.is_tie_section = True


def flush_note_decoding_state(state: NoteDecodingState) -> NoteSequence:
    """Close all active notes and finalize (reference: :394-407)."""
    for onset_time, _ in state.active_pitches.values():
        state.current_time = max(
            state.current_time, onset_time + MIN_NOTE_DURATION)
    for key in list(state.active_pitches.keys()):
        onset_time, onset_velocity = state.active_pitches.pop(key)
        _add_note_to_sequence(
            state.note_sequence, start_time=onset_time,
            end_time=state.current_time,
            pitch=key[0], velocity=onset_velocity, program=key[1])
    assign_instruments(state.note_sequence)
    return state.note_sequence


# ---- encoding spec bundles ----

NoteOnsetEncodingSpec = EventEncodingSpec(
    init_encoding_state_fn=lambda: None,
    encode_event_fn=note_event_data_to_events,
    encoding_state_to_events_fn=None,
    init_decoding_state_fn=NoteDecodingState,
    begin_decoding_segment_fn=lambda state: None,
    decode_event_fn=decode_note_onset_event,
    flush_decoding_state_fn=lambda state: state.note_sequence)


NoteEncodingSpec = EventEncodingSpec(
    init_encoding_state_fn=lambda: None,
    encode_event_fn=note_event_data_to_events,
    encoding_state_to_events_fn=None,
    init_decoding_state_fn=NoteDecodingState,
    begin_decoding_segment_fn=lambda state: None,
    decode_event_fn=decode_note_event,
    flush_decoding_state_fn=flush_note_decoding_state)


# The spec used throughout training and inference: onsets + offsets with a
# tie section declaring already-sounding notes at each segment start.
NoteEncodingWithTiesSpec = EventEncodingSpec(
    init_encoding_state_fn=NoteEncodingState,
    encode_event_fn=note_event_data_to_events,
    encoding_state_to_events_fn=note_encoding_state_to_events,
    init_decoding_state_fn=NoteDecodingState,
    begin_decoding_segment_fn=begin_tied_pitches_section,
    decode_event_fn=decode_note_event,
    flush_decoding_state_fn=flush_note_decoding_state)
