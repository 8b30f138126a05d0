"""Rebuild per-song ground-truth MIDI (all_src_v2.mid) from stems (copy of
mr_mt3_tpu/scripts/merge_slakh_midi.py).

Equivalent of the reference's midi_script.py: merging the per-stem MIDIs
fixes errors in the shipped all_src.mid (reference: midi_script.py,
NOTES.txt:63). Note times are preserved in seconds (the stems' tempo maps
are applied on read; output is written at a fixed 120 qpm).

Usage: python -m mr_mt3_tpu_torch.scripts.merge_slakh_midi <slakh_split_dir>
"""

from __future__ import annotations

import glob
import os
import sys

from mr_mt3_tpu_torch.codec.note_sequences import NoteSequence
from mr_mt3_tpu_torch.midi import note_sequence_to_midi_file, read_midi


def merge_song_midis(song_dir: str, midi_folder: str = 'MIDI',
                     out_name: str = 'all_src_v2.mid') -> str:
    stems = sorted(glob.glob(os.path.join(song_dir, midi_folder, '*.mid')))
    ns = NoteSequence()
    inst_counter = 0
    for stem in stems:
        midi = read_midi(stem)
        for inst in midi.instruments:
            for note in inst.notes:
                ns.add_note(
                    pitch=note.pitch, velocity=note.velocity,
                    start_time=note.start, end_time=note.end,
                    program=inst.program, is_drum=inst.is_drum,
                    instrument=inst_counter)
                ns.total_time = max(ns.total_time, note.end)
            inst_counter += 1
    out_path = os.path.join(song_dir, out_name)
    note_sequence_to_midi_file(ns, out_path)
    return out_path


def main(split_dir: str) -> None:
    song_dirs = sorted(
        d for d in glob.glob(os.path.join(split_dir, '*'))
        if os.path.isdir(os.path.join(d, 'MIDI')))
    for song_dir in song_dirs:
        merge_song_midis(song_dir)
        print('merged', song_dir)


if __name__ == '__main__':
    main(sys.argv[1])
