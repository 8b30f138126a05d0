"""Sustain-pedal (CC 64) note extension (copy of
mr_mt3_tpu/midi/sustain.py).

Behavior-compatible rebuild of note_seq.apply_sustain_control_changes, which
the reference applies to every Slakh stem before tokenizing
(reference: contrib/preprocessor.py:99-111). While the pedal is held for an
instrument, note-offs are deferred until pedal release (or a re-onset of the
same pitch).
"""

from __future__ import annotations

import collections

from mr_mt3_tpu_torch.codec.note_sequences import NoteSequence

_SUSTAIN_ON = 0
_SUSTAIN_OFF = 1
_NOTE_ON = 2
_NOTE_OFF = 3


def apply_sustain_control_changes(
    note_sequence: NoteSequence,
    sustain_control_number: int = 64,
) -> NoteSequence:
    """Return a copy with sustain-extended note durations.

    Event ordering matches note_seq: sorted by (time, event type) with the
    type constants ordered SUSTAIN_ON < SUSTAIN_OFF < NOTE_ON < NOTE_OFF,
    so ties at equal times resolve identically — in particular a pedal
    release and re-press at the same timestamp leaves the pedal OFF
    (the ON is processed first) regardless of their order in the CC list.
    """
    sequence = note_sequence.copy()

    events = []
    events.extend([
        (cc.time, _SUSTAIN_ON if cc.control_value >= 64 else _SUSTAIN_OFF, cc)
        for cc in sequence.control_changes
        if cc.control_number == sustain_control_number])
    events.extend([(note.start_time, _NOTE_ON, note)
                   for note in sequence.notes])
    events.extend([(note.end_time, _NOTE_OFF, note)
                   for note in sequence.notes])
    events.sort(key=lambda e: (e[0], e[1]))  # type constants break ties

    active_notes = collections.defaultdict(list)  # instrument -> notes
    sus_active = collections.defaultdict(lambda: False)

    time = 0.0
    for time, event_type, event in events:
        if event_type == _SUSTAIN_ON:
            sus_active[event.instrument] = True
        elif event_type == _SUSTAIN_OFF:
            sus_active[event.instrument] = False
            # Pedal released: notes whose written end already passed were
            # being extended — close them now.
            still_active = []
            for note in active_notes[event.instrument]:
                if note.end_time < time:
                    note.end_time = time
                    if time > sequence.total_time:
                        sequence.total_time = time
                else:
                    still_active.append(note)
            active_notes[event.instrument] = still_active
        elif event_type == _NOTE_ON:
            if sus_active[event.instrument]:
                # Re-onset of a sustained pitch truncates the earlier note.
                still_active = []
                for note in active_notes[event.instrument]:
                    if note.pitch == event.pitch:
                        note.end_time = time
                        if note.start_time == note.end_time:
                            # Zero-length after truncation: drop it entirely.
                            sequence.notes.remove(note)
                    else:
                        still_active.append(note)
                active_notes[event.instrument] = still_active
            active_notes[event.instrument].append(event)
        elif event_type == _NOTE_OFF:
            if sus_active[event.instrument]:
                pass  # held by pedal; stays active
            else:
                if event in active_notes[event.instrument]:
                    active_notes[event.instrument].remove(event)
        else:
            raise AssertionError('invalid event type: %s' % event_type)

    # Anything still active at the final event time ends there.
    for instrument_notes in active_notes.values():
        for note in instrument_notes:
            note.end_time = time
            sequence.total_time = time

    return sequence
