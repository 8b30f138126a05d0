"""Combine per-segment token predictions into one NoteSequence.

(reference: contrib/metrics_utils.py:54-144)
"""

from __future__ import annotations

import collections
import functools
from typing import Any, Callable, Mapping, Sequence, Tuple

import numpy as np

from mr_mt3_tpu_torch.codec import rle
from mr_mt3_tpu_torch.codec.events import Codec


def group_predictions_by_id(
    predictions: Sequence[Mapping[str, Any]],
) -> Mapping[str, Sequence[Any]]:
    by_id = collections.defaultdict(list)
    for pred in predictions:
        by_id[pred['unique_id']].append(pred)
    return by_id


def combine_predictions_by_id(
    predictions: Sequence[Mapping[str, Any]],
    combine_predictions_fn: Callable,
) -> Mapping[str, Mapping[str, Any]]:
    by_id = group_predictions_by_id(predictions)
    return {i: combine_predictions_fn(preds) for i, preds in by_id.items()}


def decode_and_combine_predictions(
    predictions: Sequence[Mapping[str, Any]],
    init_state_fn: Callable,
    begin_segment_fn: Callable,
    decode_tokens_fn: Callable,
    flush_state_fn: Callable,
) -> Tuple[Any, int, int]:
    """Decode segment predictions in start-time order into one result.

    Each segment is decoded with max_time clamped to the next segment's start
    so overlapping frame spans never double-predict
    (reference: contrib/metrics_utils.py:54-112).
    """
    sorted_predictions = sorted(predictions, key=lambda p: p['start_time'])
    state = init_state_fn()
    total_invalid = 0
    total_dropped = 0
    for idx, pred in enumerate(sorted_predictions):
        begin_segment_fn(state)
        max_decode_time = None
        if idx < len(sorted_predictions) - 1:
            max_decode_time = sorted_predictions[idx + 1]['start_time']
        invalid, dropped = decode_tokens_fn(
            state, pred['est_tokens'], pred['start_time'], max_decode_time)
        total_invalid += invalid
        total_dropped += dropped
    return flush_state_fn(state), total_invalid, total_dropped


def event_predictions_to_ns(
    predictions: Sequence[Mapping[str, Any]],
    codec: Codec,
    encoding_spec: rle.EventEncodingSpec,
) -> Mapping[str, Any]:
    """Segment predictions -> combined NoteSequence + error counters."""
    ns, total_invalid, total_dropped = decode_and_combine_predictions(
        predictions=predictions,
        init_state_fn=encoding_spec.init_decoding_state_fn,
        begin_segment_fn=encoding_spec.begin_decoding_segment_fn,
        decode_tokens_fn=functools.partial(
            rle.decode_events,
            codec=codec,
            decode_event_fn=encoding_spec.decode_event_fn),
        flush_state_fn=encoding_spec.flush_decoding_state_fn)

    sorted_predictions = sorted(predictions, key=lambda p: p['start_time'])
    raw_inputs = np.concatenate(
        [np.asarray(p['raw_inputs']) for p in sorted_predictions], axis=0)
    start_times = [p['start_time'] for p in sorted_predictions]

    return {
        'raw_inputs': raw_inputs,
        'start_times': start_times,
        'est_ns': ns,
        'est_invalid_events': total_invalid,
        'est_dropped_events': total_dropped,
    }
