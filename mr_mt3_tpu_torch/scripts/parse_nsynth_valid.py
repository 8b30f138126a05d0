"""Parse transcribed NSynth MIDIs into a predictions JSON (port of
mr_mt3_tpu/scripts/parse_nsynth_valid.py; host code).

(reference: scripts/eval_nsynth/parse_nsynth_valid.py) For each clip:
expected instrument family / pitch from examples.json vs the predicted
midi-class groupings and pitch sets from the transcription.

Usage: python -m mr_mt3_tpu_torch.scripts.parse_nsynth_valid \
    --examples <nsynth>/examples.json --path '<midis>/*.mid' --tag_name out
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from mr_mt3_tpu_torch.midi import read_midi

INSTRUMENT_FAMILY = {
    'bass': 4, 'brass': 7, 'flute': 9, 'guitar': 3, 'keyboard': 0,
    'mallet': 1, 'organ': 2, 'reed': 8, 'string': 5, 'synth_lead': 10,
    'vocal': 0,
}

MIDI_CLASS = [
    'piano', 'chromatic_percussion', 'organ', 'guitar', 'bass', 'strings',
    'ensemble', 'brass', 'reed', 'pipe', 'synth_lead', 'synth_pad',
    'synth_fx', 'ethnic', 'percussive', 'sound_fx',
]


def parse(examples_path: str, midi_glob: str) -> dict:
    with open(examples_path) as f:
        instruments = json.load(f)

    result = {}
    for item in sorted(glob.glob(midi_glob)):
        name = os.path.basename(item).replace('.mid', '')
        dic = instruments[name]
        family, pitch = dic['instrument_family_str'], dic['pitch']
        entry = {
            'expected_instrument': (MIDI_CLASS[INSTRUMENT_FAMILY[family]]
                                    if family != 'vocal' else 'vocal'),
            'expected_pitch': pitch,
        }
        if not os.path.exists(item):
            entry['predicted'] = {'num_instruments': 0, 'events': []}
            result[name] = entry
            continue
        midi = read_midi(item)
        entry['num_tracks'] = len(
            [i for i in midi.instruments if not i.is_drum])
        by_class = {}
        for inst in midi.instruments:
            if inst.is_drum:
                continue
            by_class.setdefault(inst.program // 8, []).extend(
                n.pitch for n in inst.notes)
        entry['predicted'] = {
            'num_instruments': len(by_class),
            'events': [{'instrument': MIDI_CLASS[cls],
                        'pitch': sorted(set(pitches))}
                       for cls, pitches in by_class.items()],
        }
        result[name] = entry
    return result


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--tag_name', type=str, required=True)
    parser.add_argument('--path', type=str, required=True)
    parser.add_argument('--examples', type=str,
                        default='/data/nsynth-valid/examples.json')
    args = parser.parse_args()
    result = parse(args.examples, args.path)
    with open(f'{args.tag_name}.json', 'w') as f:
        json.dump(result, f, indent=2)


if __name__ == '__main__':
    main()
