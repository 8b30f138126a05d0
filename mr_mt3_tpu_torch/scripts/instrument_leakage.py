"""Instrument-leakage analyses over transcription output dirs (copy of
mr_mt3_tpu/scripts/instrument_leakage.py).

Combines the reference's two leakage scripts
(reference: scripts/instrument_leakage/count_num_instruments.py and
count_instrument_f1.py): mean +/- std of distinct programs per
transcription, and set-based instrument-presence P/R/F1 vs ground truth.

Usage:
  python -m mr_mt3_tpu_torch.scripts.instrument_leakage \
      --ground_truth /data/slakh/test/ <out_dir1> <out_dir2> ...
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from mr_mt3_tpu_torch.midi import read_midi


def _song_midis(directory: str, ground_truth: str):
    if os.path.normpath(directory) == os.path.normpath(ground_truth):
        return sorted(glob.glob(os.path.join(directory, '*',
                                             'all_src_v2.mid')))
    return sorted(glob.glob(os.path.join(directory, '*', '*.mid')))


def count_num_instruments(directory: str, ground_truth: str) -> dict:
    counts = {}
    for midi_path in _song_midis(directory, ground_truth):
        song = midi_path.split(os.sep)[-2]
        midi = read_midi(midi_path)
        counts[song] = len(set(i.program for i in midi.instruments))
    return counts


def instrument_presence_f1(directory: str, ground_truth: str) -> dict:
    num_instruments, precs, recalls, f1s = [], [], [], []
    for midi_path in _song_midis(directory, ground_truth):
        song = midi_path.split(os.sep)[-2]
        gt_path = os.path.join(ground_truth, song, 'all_src_v2.mid')
        if not os.path.exists(gt_path):
            continue
        pred_programs = sorted(set(
            i.program for i in read_midi(midi_path).instruments))
        gt_programs = sorted(set(
            i.program for i in read_midi(gt_path).instruments))
        if not pred_programs or not gt_programs:
            continue
        matched = [p for p in pred_programs if p in gt_programs]
        precision = len(matched) / len(pred_programs)
        recall = len(matched) / len(gt_programs)
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        num_instruments.append(len(pred_programs))
        precs.append(precision)
        recalls.append(recall)
        f1s.append(f1)
    return {
        'avg_num_instruments': float(np.mean(num_instruments)),
        'std_num_instruments': float(np.std(num_instruments)),
        'precision': float(np.mean(precs)),
        'recall': float(np.mean(recalls)),
        'f1': float(np.mean(f1s)),
    }


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--ground_truth', type=str, required=True)
    parser.add_argument('dirs', nargs='+')
    args = parser.parse_args()
    for directory in args.dirs:
        counts = count_num_instruments(directory, args.ground_truth)
        if counts:
            vals = list(counts.values())
            print(f'{directory}: distinct programs per song '
                  f'{np.mean(vals):.2f} +/- {np.std(vals):.2f} '
                  f'({len(vals)} songs)')
        stats = instrument_presence_f1(directory, args.ground_truth)
        print('{}: avg_num_insts: {:.4} +/- {:.4}, prec: {:.4} '
              'rec: {:.4} f1: {:.4}'.format(
                  directory, stats['avg_num_instruments'],
                  stats['std_num_instruments'], stats['precision'],
                  stats['recall'], stats['f1']))


if __name__ == '__main__':
    main()
