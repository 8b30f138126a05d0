"""Multi-track transcription evaluation, Slakh / ComMU / NSynth (a copy of
mr_mt3_tpu/eval/evaluate.py, reading MIDI through the port's midi/reader.py).

Behavior-compatible rebuild of the reference evaluator
(reference: evaluate.py): instrument-agnostic onset P/R/F1 over all notes
(pitch values = raw MIDI numbers, exactly as the reference passes them at
evaluate.py:95-108), plus Perceiver-style multi-instrument onset F1 where
notes are grouped by (granular program, is_drum), per-group P/R computed in
Hz, precision weighted by estimated counts and recall by reference counts
(reference: evaluate.py:121-220).
"""

from __future__ import annotations

import collections
import concurrent.futures
import glob
import traceback
from typing import Dict, List, Optional

import numpy as np

from mr_mt3_tpu_torch.eval.transcription import (
    f_measure,
    midi_to_hz,
    precision_recall_f1_overlap,
    sequence_to_valued_intervals,
)
from mr_mt3_tpu_torch.midi.reader import midi_to_note_sequence, read_midi

INSTRUMENT_CLASS_NAMES = {
    -1: 'Drums', 0: 'Piano', 1: 'Chromatic Percussion', 2: 'Organ',
    3: 'Guitar', 4: 'Bass', 5: 'Strings', 6: 'Ensemble', 7: 'Brass',
    8: 'Reed', 9: 'Pipe', 10: 'Synth Lead', 11: 'Synth Pad',
    12: 'Synth Effects',
}


def get_granular_program(program_number: int, is_drum: bool,
                         granularity_type: str) -> int:
    if granularity_type == 'full':
        return program_number
    if granularity_type == 'midi_class':
        return (program_number // 8) * 8
    if granularity_type == 'flat':
        return 0 if not is_drum else 1
    raise ValueError(f'unknown granularity: {granularity_type}')


def compute_transcription_metrics(ref_mid, est_mid) -> Dict[str, float]:
    """Onset/offset + onset-only P/R/F1 over flattened notes
    (reference: evaluate.py:25-53)."""
    ns_ref = midi_to_note_sequence(read_midi(ref_mid))
    ns_est = midi_to_note_sequence(read_midi(est_mid))
    intervals_ref, pitches_ref, _ = sequence_to_valued_intervals(ns_ref)
    intervals_est, pitches_est, _ = sequence_to_valued_intervals(ns_est)

    onoff_p, onoff_r, onoff_f1, onoff_overlap = precision_recall_f1_overlap(
        intervals_ref, pitches_ref, intervals_est, pitches_est)
    on_p, on_r, on_f1, on_overlap = precision_recall_f1_overlap(
        intervals_ref, pitches_ref, intervals_est, pitches_est,
        offset_ratio=None)
    return {
        'len_ref_intervals': len(intervals_ref),
        'len_est_intervals': len(intervals_est),
        'onoff_precision': onoff_p, 'onoff_recall': onoff_r,
        'onoff_f1': onoff_f1, 'onoff_overlap': onoff_overlap,
        'on_precision': on_p, 'on_recall': on_r, 'on_f1': on_f1,
        'on_overlap': on_overlap,
    }


def _parse_pair(ref_path, est_path):
    """Parse one song's (ref, est) MIDI pair once for all granularities."""
    ref_mid = read_midi(ref_path)
    est_mid = read_midi(est_path)
    return (ref_mid, est_mid,
            midi_to_note_sequence(ref_mid), midi_to_note_sequence(est_mid))


def _agnostic_onset_scores(ref_ns, est_ns) -> Dict[str, float]:
    """Instrument-agnostic onset P/R/F1: all notes, MIDI-number
    "pitches" — identical across granularities."""
    est_intervals, est_pitches, _ = sequence_to_valued_intervals(est_ns)
    ref_intervals, ref_pitches, _ = sequence_to_valued_intervals(ref_ns)
    precision, recall, f1, _ = precision_recall_f1_overlap(
        ref_intervals, ref_pitches, est_intervals, est_pitches,
        offset_ratio=None)
    return {'Onset precision': precision, 'Onset recall': recall,
            'Onset F1': f1}


def program_aware_note_scores(ref_path, est_path,
                              granularity_type: str,
                              _parsed=None,
                              _agnostic=None) -> Dict[str, object]:
    """One song's scores at one granularity (reference: evaluate.py:56-237).

    _parsed/_agnostic: caches from evaluate_main's per-song loop, which
    calls this once per granularity — the MIDI parse and the
    granularity-independent onset matching (the expensive bipartite
    match over ALL notes) need not repeat 3x per song."""
    if _parsed is None:
        _parsed = _parse_pair(ref_path, est_path)
    ref_mid, est_mid, ref_ns, est_ns = _parsed

    res: Dict[str, object] = {}
    res.update(_agnostic if _agnostic is not None
               else _agnostic_onset_scores(ref_ns, est_ns))

    # group notes by (granular program, is_drum)
    def group(mid):
        mapping = {}
        for inst in mid.instruments:
            prog = get_granular_program(inst.program, inst.is_drum,
                                        granularity_type)
            mapping.setdefault((prog, inst.is_drum), []).extend(inst.notes)
        return mapping

    ref_map = group(ref_mid)
    est_map = group(est_mid)

    drum_p_sum = drum_p_cnt = drum_r_sum = drum_r_cnt = 0.0
    nd_p_sum = nd_p_cnt = nd_r_sum = nd_r_cnt = 0.0
    program_f1: Dict[int, float] = {}

    for key in set(ref_map) | set(est_map):
        program, is_drum = key
        ref_notes = ref_map.get(key, [])
        est_notes = est_map.get(key, [])
        r_iv = np.array([[n.start, n.end] for n in ref_notes]).reshape(-1, 2)
        r_p = midi_to_hz([n.pitch for n in ref_notes])
        e_iv = np.array([[n.start, n.end] for n in est_notes]).reshape(-1, 2)
        e_p = midi_to_hz([n.pitch for n in est_notes])
        precision, recall, f1, _ = precision_recall_f1_overlap(
            r_iv, r_p, e_iv, e_p, offset_ratio=None)

        if granularity_type == 'midi_class':
            program_f1[-1 if is_drum else program] = f1

        if is_drum:
            drum_p_sum += precision * len(e_iv)
            drum_p_cnt += len(e_iv)
            drum_r_sum += recall * len(r_iv)
            drum_r_cnt += len(r_iv)
        else:
            nd_p_sum += precision * len(e_iv)
            nd_p_cnt += len(e_iv)
            nd_r_sum += recall * len(r_iv)
            nd_r_cnt += len(r_iv)

    p_sum, p_cnt = drum_p_sum + nd_p_sum, drum_p_cnt + nd_p_cnt
    r_sum, r_cnt = drum_r_sum + nd_r_sum, drum_r_cnt + nd_r_cnt
    precision = (p_sum / p_cnt) if p_cnt else 0
    recall = (r_sum / r_cnt) if r_cnt else 0

    res.update({
        f'Onset + program precision ({granularity_type})': precision,
        f'Onset + program recall ({granularity_type})': recall,
        f'Onset + program F1 ({granularity_type})': f_measure(precision,
                                                              recall),
        'F1 by program': program_f1,
    })
    return res


def loop_transcription_eval(ref_mid, est_mid):
    """Track-matching F1 (separability metric; reference: evaluate.py:240-271)."""
    if not ref_mid.instruments or not est_mid.instruments:
        # an empty transcription (early checkpoint, silent clip) scores 0
        # instead of crashing np.max over a zero-size axis (the reference
        # would crash here; this metric is reported, not parity-compared)
        return 0.0, len(ref_mid.instruments), len(est_mid.instruments)
    score_matrix = np.zeros((len(ref_mid.instruments),
                             len(est_mid.instruments)))
    for i, ref_inst in enumerate(ref_mid.instruments):
        for j, est_inst in enumerate(est_mid.instruments):
            if ref_inst.is_drum != est_inst.is_drum:
                continue
            r_iv = np.array([[n.start, n.end]
                             for n in ref_inst.notes]).reshape(-1, 2)
            r_p = midi_to_hz([n.pitch for n in ref_inst.notes])
            e_iv = np.array([[n.start, n.end]
                             for n in est_inst.notes]).reshape(-1, 2)
            e_p = midi_to_hz([n.pitch for n in est_inst.notes])
            _, _, f1, _ = precision_recall_f1_overlap(r_iv, r_p, e_iv, e_p)
            score_matrix[i][j] = f1
    return (float(np.mean(np.max(score_matrix, axis=-1))),
            len(ref_mid.instruments), len(est_mid.instruments))


def pair_est_ref_paths(dataset_name: str, test_midi_dir: str,
                       ground_truth_midi_dir: str,
                       first_n: Optional[int] = None):
    """Path pairing rules per dataset (reference: evaluate.py:281-297)."""
    if dataset_name == 'Slakh':
        est = sorted(glob.glob(f'{test_midi_dir}/*/mix.mid'))
        ref = [p.replace(test_midi_dir, ground_truth_midi_dir)
               .replace('/mix.mid', '/all_src_v2.mid') for p in est]
    elif dataset_name in ('ComMU', 'NSynth'):
        est = sorted(glob.glob(f'{test_midi_dir}/*.mid'))
        ref = [p.replace(test_midi_dir, ground_truth_midi_dir)
               .replace('_16k.mid', '.mid') for p in est]
    else:
        raise ValueError('dataset_name must be Slakh, ComMU, or NSynth')
    if first_n:
        est, ref = est[:first_n], ref[:first_n]
    return list(zip(ref, est))


def evaluate_main(
    dataset_name: str,
    test_midi_dir: str,
    ground_truth_midi_dir: str,
    enable_instrument_eval: bool = False,
    first_n: Optional[int] = None,
    num_workers: int = 8,
) -> Dict[str, float]:
    """Evaluate a directory of transcriptions against ground truth.

    Returns mean scores over songs for all three granularities
    (reference: evaluate.py:274-368).
    """
    fnames = pair_est_ref_paths(dataset_name, test_midi_dir,
                                ground_truth_midi_dir, first_n)

    def song_scores(item):
        ref_path, est_path = item
        parsed = _parse_pair(ref_path, est_path)
        agnostic = _agnostic_onset_scores(parsed[2], parsed[3])
        results = {}
        for granularity in ['flat', 'full', 'midi_class']:
            results.update(program_aware_note_scores(
                ref_path, est_path, granularity,
                _parsed=parsed, _agnostic=agnostic))
        return results

    scores = collections.defaultdict(list)
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=num_workers) as executor:
        futures = {executor.submit(song_scores, item): item
                   for item in fnames}
        for future in concurrent.futures.as_completed(futures):
            try:
                for key, value in future.result().items():
                    scores[key].append(value)
            except Exception:
                traceback.print_exc()

    mean_scores = {k: float(np.mean(v)) for k, v in scores.items()
                   if k != 'F1 by program'}

    if enable_instrument_eval:
        per_program = collections.defaultdict(list)
        for item in scores['F1 by program']:
            for key, value in item.items():
                per_program[key].append(value)
        per_program = {k: float(np.mean(v)) for k, v in per_program.items()}
        for key, name in INSTRUMENT_CLASS_NAMES.items():
            lookup = key if key == -1 else key * 8
            if lookup in per_program:
                print('{}: {:.4}'.format(name, per_program[lookup]))

    return mean_scores
