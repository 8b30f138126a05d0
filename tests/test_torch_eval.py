"""The port's evaluation (mr_mt3_tpu_torch/eval, infer/scores.py, the
eval CLI `python -m mr_mt3_tpu_torch.eval` and the trainer's eval hook) on
the CPU: the metric functions equal the JAX package's on the same inputs
(tests/test_eval.py's cases); get_scores on the overfit parity model equals
the JAX get_scores score for score; the CLI transcribes and scores a
fabricated Slakh-format set (chip_smoke.eval_set) with device=cpu; the
Trainer's eval hook keeps its cadence, its crash costs no checkpoint, and
monitor=val_f1_flat ranks the top-k, through the train CLI too."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import mr_mt3_tpu.eval as jax_eval
from mr_mt3_tpu.infer.scores import get_scores as jax_get_scores
from mr_mt3_tpu.midi import read_midi as jax_read_midi
from mr_mt3_tpu.models import MT3 as JaxMT3
import mr_mt3_tpu_torch.eval as port_eval
from mr_mt3_tpu_torch.audio import write_wav
from mr_mt3_tpu_torch.codec import note_sequences as nsq
from mr_mt3_tpu_torch.infer import scores as port_scores
from mr_mt3_tpu_torch.midi import note_sequence_to_midi_file, read_midi
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.train import optim
from mr_mt3_tpu_torch.train.trainer import (
    CheckpointPolicy,
    Trainer,
    create_train_state,
)
from mr_mt3_tpu_torch.utils import builders
from mr_mt3_tpu_torch.utils.checkpoint_import import state_dict_from_jax_params
from mr_mt3_tpu_torch.utils.config import load_config
from tests.parity_common import (
    MAX_LENGTH,
    VANILLA_CFG,
    load_golden,
    parity_corpus,
)

REPO = Path(__file__).resolve().parent.parent

# evaluate_main's keys: the agnostic onset scores and, per granularity, the
# onset + program scores
SCORE_KEYS = {'Onset precision', 'Onset recall', 'Onset F1'} | {
    f'Onset + program {m} ({g})' for m in ('precision', 'recall', 'F1')
    for g in ('flat', 'full', 'midi_class')}

TINY_OVERRIDES = ['model=MT3Net', 'model.config.d_model=32',
                  'model.config.d_kv=8', 'model.config.d_ff=48',
                  'model.config.num_heads=4', 'model.config.num_layers=1',
                  'model.config.num_decoder_layers=1']


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tier-1 run puts six test files at once on one machine's cores:
    one torch thread per test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _iv(*pairs):
    return np.array(pairs, dtype=float).reshape(-1, 2)


def _hz(*pitches):
    return jax_eval.midi_to_hz(list(pitches))


# (ref intervals, ref pitches, est intervals, est pitches, kwargs): the
# inputs of tests/test_eval.py::TestMatchNotes and ::TestPRF
MATCH_CASES = {
    'perfect': (_iv((0, 1), (1, 2), (2, 3)), _hz(60, 64, 67),
                _iv((0, 1), (1, 2), (2, 3)), _hz(60, 64, 67),
                {'offset_ratio': None}),
    'onset_edge_in': (_iv((0.0, 1.0)), _hz(60), _iv((0.05, 1.0)), _hz(60),
                      {'offset_ratio': None}),
    'onset_edge_out': (_iv((0.0, 1.0)), _hz(60), _iv((0.0501, 1.0)),
                       _hz(60), {'offset_ratio': None}),
    'pitch_49_cents': (_iv((0, 1)), _hz(60), _iv((0, 1)),
                       _hz(60) * 2 ** (49 / 1200), {'offset_ratio': None}),
    'pitch_51_cents': (_iv((0, 1)), _hz(60), _iv((0, 1)),
                       _hz(60) * 2 ** (51 / 1200), {'offset_ratio': None}),
    'midi_number_quirk': (_iv((0, 1)), np.array([60]), _iv((0, 1)),
                          np.array([61]), {'offset_ratio': None}),
    'offset_good': (_iv((0.0, 1.0)), _hz(60), _iv((0.0, 1.15)), _hz(60),
                    {'offset_ratio': 0.2}),
    'offset_bad': (_iv((0.0, 1.0)), _hz(60), _iv((0.0, 1.30)), _hz(60),
                   {'offset_ratio': 0.2}),
    'maximum_matching': (_iv((0.00, 1.0), (0.09, 1.0)), _hz(60, 60),
                         _iv((0.05, 1.0), (0.00, 1.0)), _hz(60, 60),
                         {'offset_ratio': None}),
    'empty_ref': (_iv(), np.array([]), _iv((0, 1)), _hz(60), {}),
    'partial': (_iv((0, 1), (1, 2), (2, 3), (3, 4)), _hz(60, 62, 64, 65),
                _iv((0, 1), (1, 2)), _hz(60, 62), {'offset_ratio': None}),
    'overlap_half': (_iv((0.0, 1.0)), _hz(60), _iv((0.0, 0.5)), _hz(60),
                     {'offset_ratio': None}),
}


class TestMetricsEqualJax:
    @pytest.mark.parametrize('case', sorted(MATCH_CASES))
    def test_match_notes_and_prf(self, case):
        ref_i, ref_p, est_i, est_p, kw = MATCH_CASES[case]
        assert port_eval.match_notes(ref_i, ref_p, est_i, est_p, **kw) == \
            jax_eval.match_notes(ref_i, ref_p, est_i, est_p, **kw)
        assert port_eval.precision_recall_f1_overlap(
            ref_i, ref_p, est_i, est_p, **kw) == \
            jax_eval.precision_recall_f1_overlap(
                ref_i, ref_p, est_i, est_p, **kw)

    @pytest.mark.parametrize('seed', range(6))
    def test_banded_matching(self, seed):
        """tests/test_eval.py::TestBandedMatchingEquivalence's random
        instances, 5 per seed: the port's pairs are the JAX pairs."""
        for sub in range(5):
            rng = np.random.default_rng(seed * 5 + sub)
            nr, ne = rng.integers(0, 60, 2)
            ref_i = np.sort(rng.uniform(0, 10, (nr, 2)), axis=1)
            est_i = np.sort(rng.uniform(0, 10, (ne, 2)), axis=1)
            ref_p = rng.integers(50, 70, nr)
            est_p = rng.integers(50, 70, ne)
            for oratio in (None, 0.2):
                for strict in (False, True):
                    kw = dict(offset_ratio=oratio, strict=strict)
                    assert port_eval.match_notes(
                        ref_i, ref_p, est_i, est_p, **kw) == \
                        jax_eval.match_notes(ref_i, ref_p, est_i, est_p,
                                             **kw)

    @pytest.mark.parametrize('granularity', ['full', 'midi_class', 'flat'])
    def test_granular_program(self, granularity):
        for program in range(128):
            for drum in (False, True):
                assert port_eval.get_granular_program(
                    program, drum, granularity) == \
                    jax_eval.get_granular_program(program, drum, granularity)
        with pytest.raises(ValueError):
            port_eval.get_granular_program(0, False, 'coarse')

    def test_midi_to_hz_and_f_measure(self):
        pitches = np.arange(0, 128)
        assert np.array_equal(port_eval.midi_to_hz(pitches),
                              jax_eval.midi_to_hz(pitches))
        for p, r in ((0, 0), (1, 0.5), (0.3, 0.7), (1, 1)):
            assert port_eval.f_measure(p, r) == jax_eval.f_measure(p, r)


def _write_song(path, note_specs):
    ns = nsq.NoteSequence()
    for (start, end, pitch, program, is_drum, inst) in note_specs:
        ns.add_note(start_time=start, end_time=end, pitch=pitch,
                    velocity=100, program=program, is_drum=is_drum,
                    instrument=inst)
        ns.total_time = max(ns.total_time, end)
    note_sequence_to_midi_file(ns, path)


# (ref notes, est notes) of tests/test_eval.py::TestProgramAwareScores
SONGS = {
    'identical': ([(0.0, 0.5, 60, 0, False, 0), (0.5, 1.0, 64, 0, False, 0),
                   (0.0, 0.6, 40, 33, False, 1), (0.2, 0.21, 36, 0, True, 9)],
                  [(0.0, 0.5, 60, 0, False, 0), (0.5, 1.0, 64, 0, False, 0),
                   (0.0, 0.6, 40, 33, False, 1),
                   (0.2, 0.21, 36, 0, True, 9)]),
    'wrong_program': ([(0.0, 0.5, 60, 0, False, 0)],
                      [(0.0, 0.5, 60, 26, False, 0)]),
    'drums_vs_pitched': ([(0.0, 0.01, 36, 0, True, 9)],
                         [(0.0, 0.01, 36, 0, False, 0)]),
    'mixed': ([(0.5 * i, 0.5 * i + 0.3, 60 + i, 8 * (i % 3), False, i % 3)
               for i in range(9)] + [(0.25, 0.3, 38, 0, True, 9)],
              [(0.5 * i + 0.02, 0.5 * i + 0.35, 60 + i + (i == 4),
                8 * (i % 2), False, i % 2) for i in range(8)]),
}


class TestScoresEqualJax:
    @pytest.mark.parametrize('granularity', ['flat', 'midi_class', 'full'])
    @pytest.mark.parametrize('song', sorted(SONGS))
    def test_program_aware_note_scores(self, tmp_path, song, granularity):
        ref, est = tmp_path / 'ref.mid', tmp_path / 'est.mid'
        _write_song(ref, SONGS[song][0])
        _write_song(est, SONGS[song][1])
        mine = port_eval.program_aware_note_scores(ref, est, granularity)
        assert mine == jax_eval.program_aware_note_scores(ref, est,
                                                          granularity)
        if song == 'identical':
            assert mine[f'Onset + program F1 ({granularity})'] == 1.0

    def _layout(self, root, dataset):
        gt, out = root / 'gt', root / 'out'
        for i, song in enumerate(sorted(SONGS)):
            ref, est = SONGS[song]
            if dataset == 'Slakh':
                (gt / song).mkdir(parents=True)
                (out / song).mkdir(parents=True)
                _write_song(gt / song / 'all_src_v2.mid', ref)
                _write_song(out / song / 'mix.mid', est)
            else:
                gt.mkdir(exist_ok=True)
                out.mkdir(exist_ok=True)
                _write_song(gt / f'{song}.mid', ref)
                _write_song(out / f'{song}_16k.mid', est)
        return str(out), str(gt)

    @pytest.mark.parametrize('first_n', [None, 2])
    @pytest.mark.parametrize('dataset', ['Slakh', 'NSynth', 'ComMU'])
    def test_evaluate_main_layouts(self, tmp_path, dataset, first_n):
        out, gt = self._layout(tmp_path, dataset)
        mine = port_eval.evaluate_main(dataset, out, gt, first_n=first_n,
                                       enable_instrument_eval=True)
        assert mine == jax_eval.evaluate_main(dataset, out, gt,
                                              first_n=first_n,
                                              enable_instrument_eval=True)
        assert set(mine) == SCORE_KEYS
        with pytest.raises(ValueError):
            port_eval.evaluate_main('MAESTRO', out, gt)

    def test_compute_transcription_metrics(self, tmp_path):
        notes = [(0.5 * i, 0.5 * i + 0.3, 60 + i, 0, False, 0)
                 for i in range(6)]
        ref, est = tmp_path / 'ref.mid', tmp_path / 'est.mid'
        _write_song(ref, notes)
        _write_song(est, [(s, e + 0.2, p, pr, d, i)
                          for s, e, p, pr, d, i in notes])
        mine = port_eval.compute_transcription_metrics(str(ref), str(est))
        assert mine == jax_eval.compute_transcription_metrics(str(ref),
                                                              str(est))
        assert mine['on_f1'] == 1.0 and mine['onoff_f1'] < 1.0

    @pytest.mark.parametrize('song', ['identical', 'mixed', 'empty_est'])
    def test_loop_transcription_eval(self, tmp_path, song):
        ref, est = tmp_path / 'ref.mid', tmp_path / 'est.mid'
        if song == 'empty_est':
            _write_song(ref, SONGS['identical'][0])
            note_sequence_to_midi_file(nsq.NoteSequence(), est)
        else:
            _write_song(ref, SONGS[song][0])
            _write_song(est, SONGS[song][1])
        mine = port_eval.loop_transcription_eval(read_midi(ref),
                                                 read_midi(est))
        assert mine == jax_eval.loop_transcription_eval(jax_read_midi(ref),
                                                        jax_read_midi(est))
        if song == 'empty_est':
            assert mine[0] == 0.0


def test_chip_smoke_parity_corpus_is_the_tests():
    """chip_smoke's numpy copy of the parity corpus (it scores F1 on the
    card against these notes) equals tests/parity_common.py's."""
    audios, notes = chip_smoke.parity_corpus()
    want_audios, want_notes = parity_corpus()
    assert notes == want_notes
    for a, b in zip(audios, want_audios):
        assert np.array_equal(a, b)


def test_get_scores_on_the_parity_model_equals_jax(tmp_path):
    """The overfit parity model over the parity corpus as a Slakh set
    (float WAVs, so both packages read the corpus's exact samples): the
    port on the CPU writes the JAX package's MIDI bytes and its scores
    equal JAX's, key for key."""
    params, _ = load_golden('parity_vanilla.npz')
    cfg = MT3Config(**{f: getattr(VANILLA_CFG, f)
                       for f in MT3Config.__dataclass_fields__})
    model = MT3(cfg)
    model.load_state_dict(state_dict_from_jax_params(params, cfg))
    audios, notes = parity_corpus()
    gt = tmp_path / 'gt'
    files = chip_smoke.eval_set(gt, audios, notes, subtype='FLOAT')
    mine = port_scores.get_scores(
        model=model, eval_audio_dir=files, exp_tag_name=str(tmp_path / 'p'),
        ground_truth_midi_dir=str(gt), max_length=MAX_LENGTH,
        verbose=False, device='cpu')
    theirs = jax_get_scores(
        model=JaxMT3(VANILLA_CFG), variables={'params': params},
        eval_audio_dir=files, exp_tag_name=str(tmp_path / 'j'),
        ground_truth_midi_dir=str(gt), max_length=MAX_LENGTH,
        verbose=False)
    print(mine)
    assert mine == theirs
    assert set(mine) == SCORE_KEYS
    assert mine['Onset F1'] > 0.5
    for f in files:
        song = Path(f).parent.name
        assert (tmp_path / 'p' / song / 'mix.mid').read_bytes() == \
            (tmp_path / 'j' / song / 'mix.mid').read_bytes()


def _tiny_model(seed=0):
    cfg = load_config(str(REPO / 'configs'), 'config', TINY_OVERRIDES)
    return builders.init_params(builders.build_model(cfg), seed)


@pytest.fixture(scope='module')
def eval_set(tmp_path_factory):
    """Two songs of 2.5 and 4 s (tones), their notes as ground truth, and
    a port checkpoint of the tiny model's seed-0 weights."""
    root = tmp_path_factory.mktemp('evalset')
    audios, note_lists = [], []
    for i, seconds in enumerate((2.5, 4.0)):
        t = np.arange(int(16000 * seconds)) / 16000
        pitch = 60 + 4 * i
        audios.append((0.3 * np.sin(2 * np.pi * 440 * 2 ** ((pitch - 69)
                                                              / 12) * t))
                      .astype(np.float32))
        note_lists.append([(0.5, 1.5, pitch)])
    chip_smoke.eval_set(root / 'set', audios, note_lists)
    ckpt = root / 'weights'
    torch.save({'params': _tiny_model().state_dict(), 'step': 0}, ckpt)
    return root


def _cli_args(eval_set, out, *extra):
    return [*TINY_OVERRIDES, f'path={eval_set / "weights"}',
            f'eval.audio_dir={eval_set / "set"}/*/mix_16k.wav',
            f'eval.exp_tag_name={out}', f'eval.midi_dir={eval_set / "set"}',
            'eval.max_length=16', *extra]


class TestEvalCli:
    def test_module_cli_on_the_cpu(self, eval_set, tmp_path):
        """`python -m mr_mt3_tpu_torch.eval ... device=cpu`: a MIDI per
        song, evaluate_main's scores printed."""
        out = tmp_path / 'out'
        env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1')
        proc = subprocess.run(
            [sys.executable, '-m', 'mr_mt3_tpu_torch.eval',
             *_cli_args(eval_set, out, 'device=cpu')],
            cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        for song in ('Track00000', 'Track00001'):
            assert (out / song / 'mix.mid').read_bytes()[:4] == b'MThd'
        for key in SCORE_KEYS:
            assert f'{key}: ' in proc.stdout

    def test_main_returns_the_scores_and_auto_is_exact(self, eval_set,
                                                       tmp_path,
                                                       monkeypatch):
        """main(argv) returns evaluate_main's dict; +eval.quantize=auto on
        the CPU decodes on the exact path and walks no probe ladder."""
        from mr_mt3_tpu_torch.eval.__main__ import main
        from mr_mt3_tpu_torch.infer import probe
        from mr_mt3_tpu_torch.infer.handler import InferenceHandler

        def no_probe(*args, **kwargs):
            raise AssertionError('the CPU eval walked the probe ladder')
        monkeypatch.setattr(probe, 'resolve_auto_quantize', no_probe)
        tiers = []
        real = InferenceHandler.transcribe_many

        def spy(handler, audios):
            tiers.append(handler.quantize)
            return real(handler, audios)
        monkeypatch.setattr(InferenceHandler, 'transcribe_many', spy)
        scores = main(_cli_args(eval_set, tmp_path / 'out', 'device=cpu',
                                '+eval.quantize=auto'))
        assert set(scores) == SCORE_KEYS
        assert tiers == ['none']

    def test_files_filters_and_ground_truth(self, eval_set, tmp_path,
                                            monkeypatch):
        """test.py's file list (sorted glob, the NSynth vocal/mallet
        filter, eval_first_n_examples), mel_norm from the path and the
        ground truth falling back to dataset.test.root_dir."""
        from mr_mt3_tpu_torch.eval.__main__ import main
        seen = {}
        monkeypatch.setattr(port_scores, 'get_scores',
                            lambda **kw: seen.update(kw) or {})
        nsynth = tmp_path / 'nsynth'
        nsynth.mkdir()
        for name in ('b_vocal_1', 'a_keys_2', 'c_mallet_3', 'd_bass_4'):
            (nsynth / f'{name}_16k.wav').write_bytes(b'')
        main([*_cli_args(eval_set, tmp_path / 'out', 'device=cpu'),
              f'eval.audio_dir={nsynth}/*.wav', 'eval.eval_dataset=NSynth',
              'eval.midi_dir=null', 'dataset.test.root_dir=/gt',
              'eval.eval_first_n_examples=1'])
        assert [Path(f).name for f in seen['eval_audio_dir']] == \
            ['a_keys_2_16k.wav']
        assert seen['ground_truth_midi_dir'] == '/gt'
        assert seen['mel_norm'] is True
        assert seen['quantize'] == 'none'
        assert seen['device'].type == 'cpu'

    @pytest.mark.parametrize('extra,error', [
        # no launcher environment to join a process group from
        (['multihost=true'], ValueError),
        # two devices of the CPU's one (a mesh exceeding its devices)
        (['devices=2'], ValueError),
        (['path=null'], ValueError),
        (['eval.audio_dir=null'], ValueError),
        (['eval.exp_tag_name=null'], ValueError)])
    def test_what_it_does_not_take_raises(self, eval_set, tmp_path, extra,
                                          error, monkeypatch):
        from mr_mt3_tpu_torch.eval.__main__ import main
        for name in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK'):
            monkeypatch.delenv(name, raising=False)
        with pytest.raises(error):
            main([*_cli_args(eval_set, tmp_path / 'out', 'device=cpu'),
                  *extra])


class TestGetScores:
    def test_unreadable_audio_skips_only_itself(self, eval_set, tmp_path):
        """tests/test_inference.py::test_get_scores_skips_unreadable_audio
        on the port: the per-song fallback catches a load error."""
        good = tmp_path / 'good.wav'
        write_wav(good, np.random.default_rng(0).normal(size=32000) * 0.05,
                  16000)
        bad = tmp_path / 'bad.wav'
        bad.write_bytes(b'not audio at all')
        for name in ('good', 'bad'):
            _write_song(tmp_path / f'{name}.mid',
                        [(0.1, 0.5, 60, 0, False, 0)])
        scores = port_scores.get_scores(
            model=_tiny_model(), eval_audio_dir=[str(good), str(bad)],
            eval_dataset='NSynth', exp_tag_name=str(tmp_path / 'out'),
            ground_truth_midi_dir=str(tmp_path), max_length=8,
            verbose=False, device='cpu')
        assert 'Onset F1' in scores
        assert (tmp_path / 'out' / 'good.mid').exists()
        assert not (tmp_path / 'out' / 'bad.mid').exists()

    def test_mesh_is_not_ported(self):
        """get_scores spans the data axis of a mesh (tests/test_torch_ddp.py,
        tests/test_torch_mesh_decode.py); a model axis (tensor parallelism,
        tests/test_torch_tensor_parallel.py) it does not take, as its
        ranks transcribe different songs: it raises naming the model
        axis, before any collective."""
        from mr_mt3_tpu_torch.parallel import Mesh
        with pytest.raises(ValueError, match='model axis'):
            port_scores.get_scores(model=_tiny_model(), eval_audio_dir=[],
                                   mesh=Mesh(('cpu',) * 2, model=2))

    def test_load_eval_audio_pads_nsynth_and_resamples(self, tmp_path):
        x = np.linspace(-0.5, 0.5, 8000).astype(np.float32)
        write_wav(tmp_path / 'a.wav', x, 8000, subtype='FLOAT')
        slakh = port_scores.load_eval_audio(tmp_path / 'a.wav')
        nsynth = port_scores.load_eval_audio(tmp_path / 'a.wav', 'NSynth')
        assert len(slakh) == 16000
        assert np.array_equal(nsynth[:800], np.zeros(800, np.float32))
        assert np.array_equal(nsynth[800:], slakh)


TINY = MT3Config(vocab_size=1536, d_model=32, d_kv=8, d_ff=48, num_heads=4,
                 num_encoder_layers=1, num_decoder_layers=1, mel_bins=512,
                 dropout_rate=0.0)


def _fit(tmp_path, epochs, **trainer_kw):
    """tests/test_torch_trainer.py's tiny fp32 model and batch, fit for
    `epochs` with validation every epoch. Returns the trainer."""
    model = builders.init_params(MT3(TINY), 0)
    state = create_train_state(model, optim.make_optimizer(
        1e-5, use_schedule=False))
    rng = np.random.default_rng(7)
    batch = {
        'audio': rng.normal(size=(2, 256 * 128)).astype(np.float32) * 0.1,
        'valid_frames': np.full((2,), 256, np.int32),
        'targets': np.concatenate([
            rng.integers(3, 1391, (2, 20)), np.ones((2, 1), np.int64),
            np.full((2, 107), -100, np.int64)], axis=1)}
    trainer = Trainer(model, state.optimizer, out_dir=str(tmp_path / 'run'),
                      **trainer_kw)
    trainer.fit(state, [batch], val_loader=[batch], num_epochs=epochs)
    return trainer


def _records(tmp_path):
    return [json.loads(ln)
            for ln in open(tmp_path / 'run' / 'logs' / 'metrics.jsonl')]


class TestTrainerEvalHook:
    @pytest.mark.parametrize('after,per,epochs,want', [
        (0, 1, 2, [0, 1]), (1, 1, 3, [1, 2]), (0, 2, 4, [0, 2])])
    def test_cadence(self, tmp_path, after, per, epochs, want):
        """The hook runs on epochs >= eval_after_num_epoch with epoch %
        eval_per_epoch == 0, gets the trained model, and its scores are
        logged as val_<name>."""
        seen = []

        def hook(model, epoch):
            assert isinstance(model, MT3)
            seen.append(epoch)
            return {'f1_flat': 0.1 * epoch}
        _fit(tmp_path, epochs, eval_hook=hook, eval_after_num_epoch=after,
             eval_per_epoch=per)
        assert seen == want
        logged = [r['val_f1_flat'] for r in _records(tmp_path)
                  if 'val_f1_flat' in r]
        assert logged == pytest.approx([0.1 * e for e in want])

    def test_crashing_hook_still_saves_checkpoints(self, tmp_path):
        def boom(model, epoch):
            raise RuntimeError('eval glob empty')
        trainer = _fit(tmp_path, 1, eval_hook=boom,
                       checkpoint_policy=CheckpointPolicy(save_top_k=1))
        ckpts = set(os.listdir(trainer._ckpt_dir))
        assert 'last' in ckpts
        assert any(c.startswith('epoch=0-val_loss=') for c in ckpts)

    def test_topk_ranks_by_eval_hook_f1(self, tmp_path):
        f1_by_epoch = {0: 0.2, 1: 0.9, 2: 0.5}
        trainer = _fit(
            tmp_path, 3,
            checkpoint_policy=CheckpointPolicy(
                monitor='val_f1_flat', mode='max', save_top_k=1),
            eval_hook=lambda model, epoch: {'f1_flat': f1_by_epoch[epoch]})
        ckpts = {c for c in os.listdir(trainer._ckpt_dir) if c != 'last'}
        assert ckpts == {'epoch=1-val_f1_flat=0.9000'}


def test_train_cli_eval_hook_ranks_by_val_f1(tmp_path):
    """`python -m mr_mt3_tpu_torch.train` (the paper's recipe at a tiny
    width) with eval.audio_dir on its own corpus: the hook transcribes and
    scores the songs after validation, val_f1_flat / _midi_class / _full
    land in the metrics, and monitor=val_f1_flat names the top-k."""
    from mr_mt3_tpu_torch.train import main
    corpus = tmp_path / 'corpus'
    rng = np.random.default_rng(0)
    for si in range(2):
        d = corpus / f'Track{si:05d}'
        (d / 'MIDI').mkdir(parents=True)
        write_wav(d / 'mix_16k.wav',
                  (rng.normal(size=16000 * 3) * 0.05).astype(np.float32),
                  16000)
        notes = [(0.25 * i, 0.25 * i + 0.2, int(rng.integers(40, 80)), 0,
                  False, 0) for i in range(10)]
        _write_song(d / 'MIDI' / 'S00.mid', notes)
        _write_song(d / 'all_src_v2.mid', notes)
        (d / 'inst_names.json').write_text(json.dumps(
            {'S00': 'Acoustic Piano'}))
    out = tmp_path / 'run'
    main(['--config-name=config_slakh_segmem',
          'model=MT3NetSegMemV2WithPrev', 'dataset=SlakhPrev',
          'model_segmem_length=8', f'dataset.train.root_dir={corpus}',
          f'dataset.val.root_dir={corpus}', f'out_dir={out}',
          'model.config.d_model=32', 'model.config.d_kv=8',
          'model.config.d_ff=48', 'model.config.num_heads=4',
          'model.config.num_layers=1', 'model.config.num_decoder_layers=1',
          'num_rows_per_batch=2', 'trainer.check_val_every_n_epoch=1',
          'trainer.max_epochs=1', 'optim.warmup_steps=2',
          'optim.num_steps_per_epoch=2', 'device=cpu',
          f'eval.audio_dir={corpus}/*/mix_16k.wav',
          f'eval.midi_dir={corpus}', 'eval.eval_after_num_epoch=0',
          'eval.max_length=16', 'modelcheckpoint.monitor=val_f1_flat',
          'modelcheckpoint.mode=max', 'modelcheckpoint.every_n_epochs=1'])
    records = [json.loads(ln) for ln in open(out / 'logs' / 'metrics.jsonl')]
    evals = [r for r in records if 'val_f1_flat' in r]
    assert len(evals) == 1
    assert {'val_f1_flat', 'val_f1_midi_class', 'val_f1_full'} <= set(evals[0])
    for song in ('Track00000', 'Track00001'):
        assert (out / 'val_midis' / song / 'mix.mid').exists()
    assert any(c.startswith('epoch=0-val_f1_flat=')
               for c in os.listdir(out / 'checkpoints'))
