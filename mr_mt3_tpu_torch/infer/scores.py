"""Batch transcription + evaluation, "get_scores" (port of
mr_mt3_tpu/infer/scores.py).

Package home of the reference's test.get_scores (reference: test.py:15-80),
which the training loop's periodic-F1 hook also uses (reference:
tasks/mt3_base.py:27-46). One process on one device: a mesh and multihost
eval are not yet ported (ROADMAP A9) and raise.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from mr_mt3_tpu_torch.audio import read_audio, resample
from mr_mt3_tpu_torch.eval.evaluate import evaluate_main
from mr_mt3_tpu_torch.infer.handler import InferenceHandler


def load_eval_audio(path, eval_dataset: str = 'Slakh') -> np.ndarray:
    audio, sr = read_audio(path)
    if sr != 16000:
        audio = resample(audio, sr, 16000)
    if eval_dataset == 'NSynth':
        # NSynth clips get 50 ms of leading silence (reference: test.py:38-39)
        audio = np.pad(audio, (int(0.05 * 16000), 0))
    return audio


def get_scores(
    model=None,
    handler: Optional[InferenceHandler] = None,
    eval_audio_dir: Optional[List[str]] = None,
    mel_norm: bool = True,
    eval_dataset: str = 'Slakh',
    exp_tag_name: str = 'test_midis',
    ground_truth_midi_dir: Optional[str] = None,
    verbose: bool = True,
    contiguous_inference: bool = False,
    use_tf_spectral_ops: bool = False,
    batch_size: int = 8,
    max_length: int = 1024,
    songs_per_batch: int = 4,
    quantize: str = 'none',
    mesh=None,
    device=None,
) -> Dict[str, float]:
    """Transcribe every file in eval_audio_dir, then score the output dir.

    Output layout matches the reference: Slakh songs write
    {exp_tag_name}/{song}/mix.mid, ComMU/NSynth write
    {exp_tag_name}/{name}.mid (reference: test.py:46-56).

    model: an MT3 of the port with its weights loaded (the JAX function's
    model and variables in one); or pass a built handler. device: the
    handler's ('cuda' unless 'cpu' is given).

    quantize='auto': on the card the serving default
    (serve.default_quantize, the int4 window kernel) guarded by the probe
    ladder (infer/probe.resolve_auto_quantize), which falls back towards
    exact numerics on a material token flip, keeping the within-0.001-F1
    bar; on the CPU the exact path with no probe, as the JAX function
    gives 'none' off the TPU.
    """
    if mesh is not None:
        raise NotImplementedError('a decode mesh is not yet ported '
                                  '(ROADMAP A9): the port evaluates on one '
                                  'device')
    from mr_mt3_tpu_torch.utils.device import resolve_device
    device = handler.device if handler is not None \
        else resolve_device(device)
    probe_guard = False
    if quantize == 'auto':
        from mr_mt3_tpu_torch.serve import default_quantize
        quantize = default_quantize(device)
        probe_guard = quantize != 'none'
    if handler is None:
        handler = InferenceHandler(
            model=model, mel_norm=mel_norm,
            contiguous_inference=contiguous_inference,
            filterbank_style='tf' if use_tf_spectral_ops else 'torch',
            batch_size=batch_size, max_length=max_length,
            quantize=quantize, device=device)
    if probe_guard:
        from mr_mt3_tpu_torch.infer.probe import resolve_auto_quantize
        info = resolve_auto_quantize(handler, verbose=verbose)
        if verbose:
            detail = f'probe flips: {info.get("probe_flips", 0)}'
            if info.get('probe_benign_rows'):
                detail += (f', all benign at margins <= '
                           f'{info.get("material_margin")}')
            print(f'eval decode path: quantize={info["quantize"]!r} '
                  f'({detail})')

    def outpath_for(fname):
        if eval_dataset == 'Slakh':
            name = str(fname).split(os.sep)[-2]
            return os.path.join(exp_tag_name, name, 'mix.mid')
        if eval_dataset in ('ComMU', 'NSynth'):
            name = os.path.basename(str(fname))
            return os.path.join(exp_tag_name, name.replace('.wav', '.mid'))
        raise ValueError('Invalid dataset name.')

    from mr_mt3_tpu_torch.midi import note_sequence_to_midi_file

    # batch songs through the engine (contiguous segmem decodes them in
    # lockstep; see InferenceHandler.transcribe_many)
    for start in range(0, len(eval_audio_dir), songs_per_batch):
        chunk = eval_audio_dir[start:start + songs_per_batch]
        if verbose:
            print('transcribing', *map(str, chunk))
        try:
            audios = [load_eval_audio(f, eval_dataset) for f in chunk]
            results = handler.transcribe_many(audios)
            for fname, ns in zip(chunk, results):
                outpath = outpath_for(fname)
                parent = os.path.dirname(outpath)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                note_sequence_to_midi_file(ns, outpath)
        except Exception:
            import traceback
            traceback.print_exc()
            # fall back to one-by-one so a bad song only skips itself —
            # including a song whose AUDIO fails to load (quite possibly
            # the very error that broke the batch): an unguarded reload
            # here would abort the whole eval
            for fname in chunk:
                try:
                    audio = load_eval_audio(fname, eval_dataset)
                except Exception:
                    traceback.print_exc()
                    continue
                handler.inference(audio=audio,
                                  audio_path=str(fname),
                                  outpath=outpath_for(fname),
                                  verbose=verbose)

    scores = evaluate_main(
        dataset_name=eval_dataset,
        test_midi_dir=exp_tag_name,
        ground_truth_midi_dir=ground_truth_midi_dir)

    if verbose:
        for key in sorted(scores):
            print('{}: {:.4}'.format(key, scores[key]))
    return scores
