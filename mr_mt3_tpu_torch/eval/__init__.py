"""Transcription evaluation: onset matching + program-aware F1 (port of
mr_mt3_tpu/eval; host numpy and scipy code, copied). The CLI,
`python -m mr_mt3_tpu_torch.eval`, is eval/__main__.py."""

from mr_mt3_tpu_torch.eval.transcription import (
    f_measure,
    match_notes,
    midi_to_hz,
    precision_recall_f1_overlap,
)
from mr_mt3_tpu_torch.eval.evaluate import (
    compute_transcription_metrics,
    evaluate_main,
    get_granular_program,
    loop_transcription_eval,
    program_aware_note_scores,
)
