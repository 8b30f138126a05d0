"""Note-transcription matching metrics, mir_eval-equivalent (a copy of
mr_mt3_tpu/eval/transcription.py).

Dependency-free rebuild of mir_eval.transcription.precision_recall_f1_overlap
with the exact semantics the reference's evaluator relies on
(reference: evaluate.py:35-40,102-108,168-174): 50 ms onset tolerance,
50-cent pitch tolerance computed as a log-ratio of whatever pitch values are
passed in (MIDI numbers for the instrument-agnostic scores, Hz for the
program-aware scores — the reference passes both), optional offset matching,
maximum bipartite matching for the assignment.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching


def midi_to_hz(midi_pitch) -> np.ndarray:
    """440 * 2^((m-69)/12), matching librosa.midi_to_hz."""
    return 440.0 * (2.0 ** ((np.asarray(midi_pitch, dtype=np.float64) - 69.0)
                            / 12.0))


def f_measure(precision: float, recall: float, beta: float = 1.0) -> float:
    if precision == 0 and recall == 0:
        return 0.0
    return ((1 + beta ** 2) * precision * recall /
            ((beta ** 2) * precision + recall))


def match_notes(
    ref_intervals: np.ndarray,
    ref_pitches: np.ndarray,
    est_intervals: np.ndarray,
    est_pitches: np.ndarray,
    onset_tolerance: float = 0.05,
    pitch_tolerance: float = 50.0,
    offset_ratio: Optional[float] = 0.2,
    offset_min_tolerance: float = 0.05,
    strict: bool = False,
) -> List[Tuple[int, int]]:
    """Maximum matching of reference to estimated notes.

    A (ref, est) pair is a candidate when onsets are within onset_tolerance,
    pitches within pitch_tolerance cents (log2 ratio of the provided values),
    and — when offset_ratio is not None — offsets within
    max(offset_min_tolerance, offset_ratio * ref_duration).
    """
    ref_intervals = np.asarray(ref_intervals, dtype=np.float64).reshape(-1, 2)
    est_intervals = np.asarray(est_intervals, dtype=np.float64).reshape(-1, 2)
    ref_pitches = np.asarray(ref_pitches, dtype=np.float64)
    est_pitches = np.asarray(est_pitches, dtype=np.float64)
    n_ref, n_est = len(ref_pitches), len(est_pitches)
    if n_ref == 0 or n_est == 0:
        return []

    cmp = np.less if strict else np.less_equal

    # Candidate pairs must have onsets within onset_tolerance, so instead
    # of materializing the dense (n_ref, n_est) distance matrices (9M
    # float64 entries for a dense 5-minute song), gather each ref note's
    # onset-sorted est window via searchsorted and apply the EXACT pair
    # predicates on that sparse candidate set only. Semantics identical to
    # the dense formulation; ~50x faster on large songs.
    order = np.argsort(est_intervals[:, 0], kind='stable')
    est_onsets_sorted = est_intervals[order, 0]
    ref_onsets = ref_intervals[:, 0]
    pad = onset_tolerance * 1e-9 + 1e-12  # over-fetch; exact cmp below
    lo = np.searchsorted(est_onsets_sorted, ref_onsets - onset_tolerance
                         - pad, side='left')
    hi = np.searchsorted(est_onsets_sorted, ref_onsets + onset_tolerance
                         + pad, side='right')
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return []
    rows = np.repeat(np.arange(n_ref), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total) - np.repeat(starts, counts)
    cols = order[np.repeat(lo, counts) + within]

    hit = cmp(np.abs(ref_onsets[rows] - est_intervals[cols, 0]),
              onset_tolerance)
    with np.errstate(divide='ignore', invalid='ignore'):
        pitch_dist = np.abs(1200.0 * np.log2(
            ref_pitches[rows] / est_pitches[cols]))
    hit &= cmp(pitch_dist, pitch_tolerance)
    if offset_ratio is not None:
        durations = ref_intervals[rows, 1] - ref_intervals[rows, 0]
        offset_tol = np.maximum(offset_ratio * durations,
                                offset_min_tolerance)
        hit &= cmp(np.abs(ref_intervals[rows, 1] - est_intervals[cols, 1]),
                   offset_tol)

    rows, cols = rows[hit], cols[hit]
    if rows.size == 0:
        return []

    graph = csr_matrix((np.ones(rows.size, bool), (rows, cols)),
                       shape=(n_ref, n_est))
    # est index assigned to each ref row, or -1
    est_for_ref = maximum_bipartite_matching(graph, perm_type='column')
    return [(r, int(e)) for r, e in enumerate(est_for_ref) if e >= 0]


def average_overlap_ratio(ref_intervals, est_intervals, matching) -> float:
    if not matching:
        return 0.0
    ratios = []
    for r, e in matching:
        ron, roff = ref_intervals[r]
        eon, eoff = est_intervals[e]
        denom = max(roff, eoff) - min(ron, eon)
        num = min(roff, eoff) - max(ron, eon)
        ratios.append(num / denom if denom > 0 else 0.0)
    return float(np.mean(ratios))


def precision_recall_f1_overlap(
    ref_intervals,
    ref_pitches,
    est_intervals,
    est_pitches,
    onset_tolerance: float = 0.05,
    pitch_tolerance: float = 50.0,
    offset_ratio: Optional[float] = 0.2,
    offset_min_tolerance: float = 0.05,
    strict: bool = False,
) -> Tuple[float, float, float, float]:
    """(precision, recall, f_measure, avg_overlap_ratio)."""
    ref_intervals = np.asarray(ref_intervals, dtype=np.float64).reshape(-1, 2)
    est_intervals = np.asarray(est_intervals, dtype=np.float64).reshape(-1, 2)
    ref_pitches = np.asarray(ref_pitches, dtype=np.float64)
    est_pitches = np.asarray(est_pitches, dtype=np.float64)
    if len(ref_pitches) == 0 or len(est_pitches) == 0:
        return 0.0, 0.0, 0.0, 0.0
    matching = match_notes(
        ref_intervals, ref_pitches, est_intervals, est_pitches,
        onset_tolerance=onset_tolerance, pitch_tolerance=pitch_tolerance,
        offset_ratio=offset_ratio, offset_min_tolerance=offset_min_tolerance,
        strict=strict)
    precision = len(matching) / len(est_pitches)
    recall = len(matching) / len(ref_pitches)
    return (precision, recall, f_measure(precision, recall),
            average_overlap_ratio(ref_intervals, est_intervals, matching))


def sequence_to_valued_intervals(ns) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
    """NoteSequence -> (intervals, MIDI pitches, velocities), dropping
    zero-length notes (note_seq.sequences_lib semantics)."""
    intervals, pitches, velocities = [], [], []
    for note in ns.notes:
        if note.end_time - note.start_time == 0:
            continue
        intervals.append((note.start_time, note.end_time))
        pitches.append(note.pitch)
        velocities.append(note.velocity)
    return (np.array(intervals, dtype=np.float64).reshape(-1, 2),
            np.array(pitches), np.array(velocities))
