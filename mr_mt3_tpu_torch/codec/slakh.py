"""Slakh instrument-class mapping and track merging (copy of
mr_mt3_tpu/codec/slakh.py).

(reference: contrib/preprocessor.py:47-111)
"""

from __future__ import annotations

from typing import Tuple

from mr_mt3_tpu_torch.codec.note_sequences import NoteSequence
from mr_mt3_tpu_torch.midi.sustain import apply_sustain_control_changes

SLAKH_CLASS_PROGRAMS = {
    'Acoustic Piano': 0,
    'Electric Piano': 4,
    'Chromatic Percussion': 8,
    'Organ': 16,
    'Acoustic Guitar': 24,
    'Clean Electric Guitar': 26,
    'Distorted Electric Guitar': 29,
    'Acoustic Bass': 32,
    'Electric Bass': 33,
    'Violin': 40,
    'Viola': 41,
    'Cello': 42,
    'Contrabass': 43,
    'Orchestral Harp': 46,
    'Timpani': 47,
    'String Ensemble': 48,
    'Synth Strings': 50,
    'Choir and Voice': 52,
    'Orchestral Hit': 55,
    'Trumpet': 56,
    'Trombone': 57,
    'Tuba': 58,
    'French Horn': 60,
    'Brass Section': 61,
    'Soprano/Alto Sax': 64,
    'Tenor Sax': 66,
    'Baritone Sax': 67,
    'Oboe': 68,
    'English Horn': 69,
    'Bassoon': 70,
    'Clarinet': 71,
    'Pipe': 73,
    'Synth Lead': 80,
    'Synth Pad': 88,
}

GUITARSET_PROGRAM = 24

URMP_INSTRUMENT_PROGRAMS = {
    'vn': 40, 'va': 41, 'vc': 42, 'db': 43, 'tpt': 56, 'tbn': 57,
    'tba': 58, 'hn': 60, 'sax': 64, 'ob': 68, 'bn': 70, 'cl': 71, 'fl': 73,
}


class PitchBendError(Exception):
    pass


def guitarset_instrument_to_program(instrument: str) -> int:
    if instrument == 'Clean Guitar':
        return GUITARSET_PROGRAM
    raise ValueError('Unknown GuitarSet instrument: %s' % instrument)


def slakh_class_to_program_and_is_drum(slakh_class: str) -> Tuple[int, bool]:
    """Map a Slakh class name to (program, is_drum)."""
    if slakh_class == 'Drums':
        return 0, True
    if slakh_class not in SLAKH_CLASS_PROGRAMS:
        raise ValueError('unknown Slakh class: %s' % slakh_class)
    return SLAKH_CLASS_PROGRAMS[slakh_class], False


def add_track_to_notesequence(
    ns: NoteSequence,
    track: NoteSequence,
    program: int,
    is_drum: bool,
    ignore_pitch_bends: bool,
) -> None:
    """Merge a per-stem track into the song NoteSequence.

    Applies sustain-pedal control changes first, then stamps program/is_drum
    onto every note (reference: contrib/preprocessor.py:99-111).
    """
    if getattr(track, 'pitch_bends', None) and not ignore_pitch_bends:
        raise PitchBendError
    track_sus = apply_sustain_control_changes(track)
    for note in track_sus.notes:
        note.program = program
        note.is_drum = is_drum
        ns.notes.append(note)
        ns.total_time = max(ns.total_time, note.end_time)
