"""System test of the port: the full loop learns (port of
tests/test_system_overfit.py, on the CPU).

Train the small model of the JAX test to overfit its two tonal songs (six
fixed segments), then transcribe each song's trained span through the
port's InferenceHandler and MIDI writer and score it with
program_aware_note_scores: the mean onset F1 must pass the JAX test's bar.
This runs dataset tokenization -> the mel -> training -> KV-cache decoding
-> token postprocessing -> MIDI writing -> the metric end to end on real
signal. The songs and the training loop are chip_smoke.py's, whose
`overfit on the card` phase runs the same test on the H100."""

import numpy as np
import pytest
import torch

import chip_smoke
from mr_mt3_tpu_torch.infer import InferenceHandler


@pytest.fixture(scope='module')
def tonal_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('tonal'))
    chip_smoke.overfit_corpus(root)
    return root


@pytest.mark.slow
def test_overfit_then_transcribe(tonal_root, tmp_path):
    model, losses = chip_smoke.overfit_train(torch, tonal_root,
                                             torch.device('cpu'))
    assert losses[-1] < chip_smoke.OVERFIT_LOSS, \
        f'did not overfit: final loss {losses[-1]} after {len(losses)} steps'
    handler = InferenceHandler(model=model,
                               max_length=chip_smoke.OVERFIT_MAX_LENGTH,
                               batch_size=chip_smoke.OVERFIT_BATCH,
                               device='cpu')
    scores = chip_smoke.overfit_transcribe(handler, tonal_root,
                                           str(tmp_path / 'out'))
    mean_f1 = float(np.mean(list(scores.values())))
    print(f'{len(losses)} steps, loss {losses[-1]:.4f}; onset F1 {scores}')
    assert mean_f1 > chip_smoke.OVERFIT_F1, \
        f'transcription F1 too low: {scores}'
