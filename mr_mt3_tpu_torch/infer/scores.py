"""Batch transcription + evaluation, "get_scores" (port of
mr_mt3_tpu/infer/scores.py).

Package home of the reference's test.get_scores (reference: test.py:15-80),
which the training loop's periodic-F1 hook also uses (reference:
tasks/mt3_base.py:27-46). A mesh shards the decode batches over its
replicas (infer/handler.py); under a process group each rank transcribes
its stride of the songs, and rank 0 scores them all (parallel/mesh.py).
"""

from __future__ import annotations

import os
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from mr_mt3_tpu_torch.audio import read_audio, resample
from mr_mt3_tpu_torch import parallel
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
    handler's ('cuda' unless 'cpu' is given; a mesh's first device).

    mesh: a parallel.Mesh of this process's devices: the decode batches
    shard over its data axis (at least n_data songs a batch); a model axis
    above 1 raises ValueError. Under a
    process group (parallel.init_multihost) each rank transcribes every
    world-th song (the stride balances the long and short songs that
    sorted lists cluster), into exp_tag_name on a filesystem every rank
    sees; after a barrier rank 0 scores the whole directory and broadcasts
    the dict, so every rank returns the same scores. An error on any rank
    (its songs' decode, its handler) raises on every rank, after all of
    them have transcribed; a song that fails to load only skips itself.

    quantize='auto': on the card the serving default
    (serve.default_quantize, the int4 window kernel) guarded by the probe
    ladder (infer/probe.resolve_auto_quantize), which falls back towards
    exact numerics on a material token flip, keeping the within-0.001-F1
    bar; on the CPU the exact path with no probe, as the JAX function
    gives 'none' off the TPU.
    """
    from mr_mt3_tpu_torch.utils.device import resolve_device
    if mesh is not None and mesh.model > 1:
        raise ValueError(
            'get_scores takes a mesh of the data axis only: its ranks '
            'transcribe different songs, which the ranks of a model axis '
            '> 1 cannot (they decode in lockstep); score a sharded model '
            'with its full weights (parallel.tensor.unsharded_copy), as '
            'the train CLI\'s eval hook does')
    if handler is not None:
        device = handler.device
    elif mesh is not None:
        device = mesh.devices[0]
    else:
        device = resolve_device(device)
    rank, world = parallel.rank(), parallel.world()
    if world > 1:
        eval_audio_dir = list(eval_audio_dir)[rank::world]
        if verbose:
            print(f'multihost eval: rank {rank}/{world} transcribes '
                  f'{len(eval_audio_dir)} songs')
    probe_guard = False
    if quantize == 'auto':
        from mr_mt3_tpu_torch.serve import default_quantize
        quantize = default_quantize(device)
        probe_guard = quantize != 'none'

    def outpath_for(fname):
        if eval_dataset == 'Slakh':
            name = str(fname).split(os.sep)[-2]
            return os.path.join(exp_tag_name, name, 'mix.mid')
        if eval_dataset in ('ComMU', 'NSynth'):
            name = os.path.basename(str(fname))
            return os.path.join(exp_tag_name, name.replace('.wav', '.mid'))
        raise ValueError('Invalid dataset name.')

    def transcribe(handler, songs_per_batch):
        """This rank's songs to MIDI files."""
        if handler is None:
            handler = InferenceHandler(
                model=model, mel_norm=mel_norm,
                contiguous_inference=contiguous_inference,
                filterbank_style='tf' if use_tf_spectral_ops else 'torch',
                batch_size=batch_size, max_length=max_length,
                quantize=quantize, mesh=mesh,
                device=None if mesh is not None else device)
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
        # in lockstep (contiguous) mode each device carries whole songs:
        # fewer songs a batch than devices would idle the rest
        songs_per_batch = max(songs_per_batch, handler.n_data)

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
                traceback.print_exc()
                # fall back to one-by-one so a bad song only skips itself
                # -- including a song whose AUDIO fails to load (quite
                # possibly the very error that broke the batch): an
                # unguarded reload here would abort the whole eval
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

    if world == 1:
        transcribe(handler, songs_per_batch)
    else:
        # any error of one rank (a decode failure, an out-of-memory, the
        # handler's build) reaches every rank at the all-reduce that stands
        # for the barrier after the MIDI writes, and all raise together:
        # a rank that raised alone would take its next collective while the
        # others wait here, pairing collectives that do not belong together
        failed = torch.zeros(world)
        try:
            transcribe(handler, songs_per_batch)
        except Exception:
            traceback.print_exc()
            failed[rank] = 1
        failed = parallel.all_reduce_sum(failed)
        if failed.any():
            ranks = [r for r in range(world) if failed[r]]
            raise RuntimeError(f'transcription failed on rank(s) {ranks}')

    def score():
        return evaluate_main(dataset_name=eval_dataset,
                             test_midi_dir=exp_tag_name,
                             ground_truth_midi_dir=ground_truth_midi_dir)

    if world > 1:
        # every rank's MIDI writes landed (the all-reduce above); a scoring
        # error on rank 0 reaches every rank instead of leaving them at
        # the broadcast
        scores = None
        if rank == 0:
            try:
                scores = {'scores': score()}
            except Exception as e:  # noqa: BLE001 -- re-raised on every rank
                scores = {'error': repr(e)}
        scores = parallel.broadcast_object(scores)
        if 'error' in scores:
            raise RuntimeError(f'scoring failed on rank 0: {scores["error"]}')
        scores = scores['scores']
    else:
        scores = score()

    if verbose and rank == 0:
        for key in sorted(scores):
            print('{}: {:.4}'.format(key, scores[key]))
    return scores
