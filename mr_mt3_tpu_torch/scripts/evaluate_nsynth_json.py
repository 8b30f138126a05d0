"""Instrument / pitch accuracy from a parsed NSynth predictions JSON
(port of mr_mt3_tpu/scripts/evaluate_nsynth_json.py; host code).

(reference: scripts/eval_nsynth/evaluate_nsynth_json.py)

Usage: python -m mr_mt3_tpu_torch.scripts.evaluate_nsynth_json --json_path out.json
"""

from __future__ import annotations

import argparse
import json


def evaluate(results: dict) -> dict:
    correct_instrument = correct_pitch = avg_instrument = avg_tracks = 0
    for elem in results.values():
        avg_instrument += elem['predicted']['num_instruments']
        predicted = elem['predicted']['events']
        if not predicted:
            continue
        if elem['expected_instrument'] == predicted[0]['instrument']:
            correct_instrument += 1
        if elem['expected_pitch'] in predicted[0]['pitch']:
            correct_pitch += 1
        avg_tracks += elem.get('num_tracks', 0)
    n = len(results)
    return {
        'instrument_acc': correct_instrument / n,
        'pitch_acc': correct_pitch / n,
        'avg_num_tracks': avg_tracks / n,
        'avg_num_instruments': avg_instrument / n,
    }


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--json_path', type=str, required=True)
    args = parser.parse_args()
    with open(args.json_path) as f:
        results = json.load(f)
    scores = evaluate(results)
    print(f"Instrument acc: {scores['instrument_acc'] * 100:.2f}%")
    print(f"Pitch acc: {scores['pitch_acc'] * 100:.2f}%")
    print(f"Avg num tracks: {scores['avg_num_tracks']:.2f}")
    print('Avg num instruments after MIDI grouping: '
          f"{scores['avg_num_instruments']:.2f}")


if __name__ == '__main__':
    main()
