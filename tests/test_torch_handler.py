"""The port's InferenceHandler (device='cpu') against the frozen parity
goldens and the JAX handler: exact and window-kernel tokens (fused_bf16,
fused, fused_int4) on the overfit parity model, and the host tail
(postprocess -> NoteSequence -> MIDI)."""

import numpy as np
import pytest
import torch

from mr_mt3_tpu.infer import InferenceHandler as JaxHandler
from mr_mt3_tpu.midi.writer import note_sequence_to_midi_bytes as jax_midi_bytes
from mr_mt3_tpu.models import MT3 as JaxMT3
from mr_mt3_tpu_torch.infer import InferenceHandler
from mr_mt3_tpu_torch.midi import note_sequence_to_midi_bytes
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.utils.checkpoint_import import state_dict_from_jax_params
from tests.parity_common import (
    MAX_LENGTH,
    VANILLA_CFG,
    load_golden,
    parity_corpus,
)


@pytest.fixture(scope='module')
def golden():
    params, meta = load_golden('parity_vanilla.npz')
    cfg = MT3Config(**{f: getattr(VANILLA_CFG, f)
                       for f in MT3Config.__dataclass_fields__})
    model = MT3(cfg)
    model.load_state_dict(state_dict_from_jax_params(params, cfg))
    return params, meta, model


def _handler(model, quantize='none', **kw):
    return InferenceHandler(model=model, max_length=MAX_LENGTH,
                            batch_size=4, quantize=quantize, device='cpu',
                            **kw)


FUSED_AND_EXACT = ['none', 'fused_bf16', 'fused', 'fused_int4']


@pytest.mark.parametrize('quantize', FUSED_AND_EXACT)
def test_tokens_equal_the_goldens(golden, quantize):
    """Both corpus songs, max_length 1024: the exact path, and the window
    in each of its tiers (its plain version on the CPU), reproduce the
    golden token streams exactly (the JAX package pins zero flips for the
    integer tiers on this model too)."""
    _, meta, model = golden
    handler = _handler(model, quantize)
    for audio, want in zip(parity_corpus()[0], meta['tokens']):
        segments, _, valid = handler._audio_to_segments(audio)
        mel = handler._compute_mel(segments, valid)
        assert mel.device.type == 'cpu'
        tokens = handler._decode_all(mel)
        assert tokens.shape == (4, MAX_LENGTH + 1)
        np.testing.assert_array_equal(tokens, want)


def test_segments_and_mel_match_jax(golden):
    params, _, model = golden
    mine = _handler(model)
    theirs = JaxHandler(model=JaxMT3(VANILLA_CFG),
                        variables={'params': params}, max_length=MAX_LENGTH)
    audio = parity_corpus()[0][1]
    seg_t, times_t, valid_t = mine._audio_to_segments(audio)
    seg_j, times_j, valid_j = theirs._audio_to_segments(audio)
    np.testing.assert_array_equal(seg_t, seg_j)
    np.testing.assert_array_equal(times_t, times_j)
    assert list(valid_t) == list(valid_j)
    mel_t = mine._compute_mel(seg_t, valid_t).numpy()
    mel_j = np.asarray(theirs._compute_mel(seg_j, valid_j))
    # the frontend's tonal bounds (test_torch_frontend.py): 1e-3 in
    # log-mel where log-mel > -4, 0.01 in mel space elsewhere (bins on the
    # fp32 FFT noise floor), through the [0, 1] normalization
    lo, hi = -12.0, 5.0
    log_t, log_j = mel_t * (hi - lo) + lo, mel_j * (hi - lo) + lo
    energy = log_j > -4
    assert energy.mean() > 0.5
    assert np.abs(log_t - log_j)[energy].max() < 1e-3
    assert np.abs(np.exp(log_t) - np.exp(log_j)).max() < 1e-2


def test_host_tail_equals_jax(golden):
    """Golden tokens -> postprocess -> NoteSequence -> MIDI bytes: the
    port's host code gives the JAX handler's bytes."""
    params, meta, model = golden
    mine = _handler(model)
    theirs = JaxHandler(model=JaxMT3(VANILLA_CFG),
                        variables={'params': params}, max_length=MAX_LENGTH)
    for song, audio in enumerate(parity_corpus()[0]):
        tokens = np.asarray(meta['tokens'][song])
        _, seg_times, _ = mine._audio_to_segments(audio)
        ct_t = mine._postprocess(tokens)
        ct_j = theirs._postprocess(tokens)
        np.testing.assert_array_equal(ct_t, ct_j)
        ns_t = mine._to_note_sequence(ct_t, seg_times)
        ns_j = theirs._to_note_sequence(ct_j, seg_times)
        assert len(ns_t.notes) > 0
        assert note_sequence_to_midi_bytes(ns_t) == jax_midi_bytes(ns_j)


def test_transcribe_many_equals_per_song(golden, tmp_path):
    """Songs coalesced into one decode batch give each song's own result;
    inference() writes the MIDI file."""
    _, _, model = golden
    handler = InferenceHandler(model=model, max_length=64, batch_size=3,
                               device='cpu')
    audios = [a[:200_000] for a in parity_corpus()[0]]
    many = handler.transcribe_many(audios)
    for audio, ns in zip(audios, many):
        one = handler.transcribe(audio)
        assert note_sequence_to_midi_bytes(one) == \
            note_sequence_to_midi_bytes(ns)
    out = tmp_path / 'song.mid'
    ns = handler.inference(audios[0], outpath=str(out))
    assert ns is not None and out.read_bytes()[:4] == b'MThd'


@pytest.mark.parametrize('quantize', ['int8', 'int8_kv'])
def test_unported_tiers_raise(golden, quantize):
    _, _, model = golden
    with pytest.raises(NotImplementedError, match='not yet ported'):
        _handler(model, quantize)


def test_unported_paths_raise(golden):
    """A mesh is not yet ported; unknown tiers and segment-memory variants
    raise. (Contiguous inference and the segmem models are ported:
    tests/test_torch_segmem.py.)"""
    _, _, model = golden
    with pytest.raises(NotImplementedError, match='not yet ported'):
        _handler(model, mesh=object())
    with pytest.raises(ValueError, match='unknown segmem_variant'):
        MT3(MT3Config(segmem_variant='encoder_prepend'))
    with pytest.raises(ValueError, match='unknown quantize'):
        _handler(model, 'int3')


@pytest.mark.parametrize('quantize', FUSED_AND_EXACT)
def test_padding_rows_start_finished(golden, quantize):
    """Rows that valid_mask marks as padding are finished from the first
    step and emit only pad; the real rows decode as without them."""
    from mr_mt3_tpu_torch.ops.decode import greedy_decode
    _, meta, model = golden
    handler = _handler(model)
    segments, _, valid = handler._audio_to_segments(parity_corpus()[0][0])
    mel = handler._compute_mel(segments, valid)[:2]
    mel = torch.cat([mel, torch.zeros_like(mel)])
    mask = torch.tensor([True, True, False, False])
    tokens = greedy_decode(model, mel, 40, quantize=quantize,
                           valid_mask=mask).numpy()
    assert tokens.shape == (4, 41)
    assert (tokens[2:, 1:] == VANILLA_CFG.pad_token_id).all()
    np.testing.assert_array_equal(tokens[:2], meta['tokens'][0][:2, :41])
