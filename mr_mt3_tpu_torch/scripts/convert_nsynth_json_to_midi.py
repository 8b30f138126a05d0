"""NSynth examples.json -> one single-note MIDI per clip (port of
mr_mt3_tpu/scripts/convert_nsynth_json_to_midi.py; host code).

(reference: scripts/nsynth/convert_nsynth_json_to_midi.py) Onset at 0.05 s
(models behave better with a small lead-in), fixed 4 s duration, program =
first program of the instrument family's MIDI class. Vocals are skipped.

Usage: python -m mr_mt3_tpu_torch.scripts.convert_nsynth_json_to_midi <nsynth_dir>
"""

from __future__ import annotations

import json
import os
import sys

from mr_mt3_tpu_torch.codec.note_sequences import NoteSequence
from mr_mt3_tpu_torch.midi import note_sequence_to_midi_file

INSTRUMENT_MAPPING = {
    'bass': 32,
    'brass': 56,
    'flute': 72,
    'guitar': 24,
    'keyboard': 0,
    'mallet': 8,
    'organ': 16,
    'reed': 64,
    'string': 40,
    'synth_lead': 80,
}


def main(prefix_path: str) -> None:
    with open(os.path.join(prefix_path, 'examples.json')) as f:
        instruments = json.load(f)
    out_dir = os.path.join(prefix_path, 'midi')
    os.makedirs(out_dir, exist_ok=True)
    for key, dic in instruments.items():
        if 'vocal' in key:
            continue
        ns = NoteSequence()
        ns.add_note(
            pitch=dic['pitch'], velocity=dic['velocity'],
            start_time=0.05, end_time=4.05,
            program=INSTRUMENT_MAPPING[dic['instrument_family_str']],
            is_drum=False, instrument=0)
        ns.total_time = 4.05
        note_sequence_to_midi_file(ns, os.path.join(out_dir, key + '.mid'))
    print('done')


if __name__ == '__main__':
    main(sys.argv[1])
