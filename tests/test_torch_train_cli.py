"""The port's train CLI (python -m mr_mt3_tpu_torch.train) on the CPU: the
paper's recipe (config_slakh_segmem, model=MT3NetSegMemV2WithPrev,
dataset=SlakhPrev) cut to a tiny model on a fabricated Slakh-format corpus
writes metrics and the 'last', top-k and 'final' checkpoints, and resumes
from 'last' with its optimizer state and step; what is not ported raises."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mr_mt3_tpu.audio import write_wav
from mr_mt3_tpu_torch.codec import note_sequences as nsq
from mr_mt3_tpu_torch.midi import note_sequence_to_midi_file
from mr_mt3_tpu_torch.train import main
from mr_mt3_tpu_torch.train.trainer import load_checkpoint

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tier-1 run puts six test files at once on one machine's cores,
    where torch's default of one intra-op thread per core oversubscribes
    them many times over and slows these small steps tens of times: one
    thread per test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """Two 6 s songs, three stems each (a note every 0.25 s)."""
    root = tmp_path_factory.mktemp('corpus')
    rng = np.random.default_rng(0)
    for si in range(2):
        d = root / f'Track{si:05d}'
        (d / 'MIDI').mkdir(parents=True)
        write_wav(d / 'mix_16k.wav',
                  (rng.normal(size=16000 * 6) * 0.05).astype(np.float32),
                  16000)
        stems = {}
        for ti, (name, prog, drum) in enumerate(
                [('Acoustic Piano', 0, False), ('Electric Bass', 33, False),
                 ('Drums', 0, True)]):
            ns = nsq.NoteSequence()
            for i in range(22):
                ns.add_note(start_time=0.25 * i, end_time=0.25 * i + 0.2,
                            pitch=int(rng.integers(40, 80)), velocity=100,
                            program=prog, is_drum=drum,
                            instrument=9 if drum else 0)
            ns.total_time = 6.0
            note_sequence_to_midi_file(ns, str(d / 'MIDI' / f'S{ti:02d}.mid'))
            stems[f'S{ti:02d}'] = name
        (d / 'inst_names.json').write_text(json.dumps(stems))
    return str(root)


def _argv(corpus, out_dir, *extra):
    """The paper's recipe at a tiny width, on the CPU."""
    return ['--config-name=config_slakh_segmem',
            'model=MT3NetSegMemV2WithPrev', 'dataset=SlakhPrev',
            'model_segmem_length=8', 'eval.audio_dir=null',
            f'dataset.train.root_dir={corpus}',
            f'dataset.val.root_dir={corpus}', f'out_dir={out_dir}',
            'model.config.d_model=32', 'model.config.d_kv=8',
            'model.config.d_ff=48', 'model.config.num_heads=4',
            'model.config.num_layers=1', 'model.config.num_decoder_layers=1',
            'num_rows_per_batch=2', 'trainer.check_val_every_n_epoch=1',
            'trainer.log_every_n_steps=1', 'modelcheckpoint.every_n_epochs=1',
            'optim.warmup_steps=2', 'optim.num_steps_per_epoch=2',
            *extra]


def test_module_cli_trains_and_resumes(corpus, tmp_path):
    """`python -m mr_mt3_tpu_torch.train ... device=cpu` for 2 epochs, then
    main() resumed from 'last' for one more: metrics, checkpoints, the step
    continuing from 4 to 6 and the optimizer's count with it."""
    out = tmp_path / 'run'
    env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', 'mr_mt3_tpu_torch.train',
         *_argv(corpus, out, 'device=cpu', 'trainer.max_epochs=2')],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ckpts = set(os.listdir(out / 'checkpoints'))
    assert {'last', 'final'} <= ckpts
    assert any(c.startswith('epoch=1-val_loss=') for c in ckpts)
    records = [json.loads(ln) for ln in open(out / 'logs' / 'metrics.jsonl')]
    train = [r for r in records if 'train_loss' in r]
    assert [r['step'] for r in train] == [1, 2, 3, 4]
    assert all(np.isfinite(r['train_loss']) for r in train)
    assert sum('val_loss' in r for r in records) == 2
    last = load_checkpoint(str(out / 'checkpoints' / 'last'))
    assert last['step'] == 4 and last['opt_state']['count'] == 4

    state = main(_argv(corpus, out, 'device=cpu', 'trainer.max_epochs=3',
                       f'path={out / "checkpoints" / "last"}'))
    assert state.step == 6 and state.optimizer.count == 6
    final = load_checkpoint(str(out / 'checkpoints' / 'final'))
    assert final['step'] == 6
    for name, value in state.model.state_dict().items():
        assert torch.equal(final['params'][name], value.cpu())
    records = [json.loads(ln) for ln in open(out / 'logs' / 'metrics.jsonl')]
    assert [r['step'] for r in records if 'train_loss' in r][-2:] == [5, 6]


def test_warm_start_from_weights_only(corpus, tmp_path):
    """A reference-format weights file (.pth) warm-starts: the weights
    load, the step starts at 0."""
    first = main(_argv(corpus, tmp_path / 'a', 'device=cpu',
                       'trainer.max_epochs=1'))
    path = tmp_path / 'a' / 'weights.pth'
    torch.save(first.model.state_dict(), path)
    seen = {}
    import mr_mt3_tpu_torch.utils.builders as builders
    real = builders.load_weights

    def spy(p, model, strict=False):
        out = real(p, model, strict)
        seen['params'] = {k: v.clone() for k, v in model.state_dict().items()}
        return out
    builders.load_weights = spy
    try:
        state = main(_argv(corpus, tmp_path / 'b', 'device=cpu',
                           'trainer.max_epochs=1', f'path={path}'))
    finally:
        builders.load_weights = real
    assert state.step == 2
    for name, value in first.model.state_dict().items():
        assert torch.equal(seen['params'][name], value)


class TestRaises:
    def test_without_a_card_and_without_device_cpu(self, corpus, tmp_path,
                                                   monkeypatch):
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(_argv(corpus, tmp_path, 'trainer.max_epochs=1'))

    def test_eval_audio_dir_is_not_ported(self, corpus, tmp_path):
        """eval.audio_dir raised here until the eval hook was ported
        (ROADMAP A7); the test keeps its name and now checks that the hook
        runs after validation: an eval glob under tmp_path that matches no
        song gives F1 0.0, as the JAX trainer logs it."""
        songs = tmp_path / 'no_songs'
        argv = [a for a in _argv(corpus, tmp_path, 'device=cpu',
                                 'trainer.max_epochs=1',
                                 'eval.eval_after_num_epoch=0')
                if not a.startswith('eval.audio_dir')]
        argv += [f'eval.audio_dir={songs}/*/mix_16k.wav',
                 f'eval.midi_dir={songs}']
        state = main(argv)
        assert state.step == 2
        records = [json.loads(ln)
                   for ln in open(tmp_path / 'logs' / 'metrics.jsonl')]
        assert [(r['val_f1_flat'], r['val_f1_midi_class'], r['val_f1_full'])
                for r in records if 'val_f1_flat' in r] == [(0.0, 0.0, 0.0)]

    @pytest.mark.parametrize('extra', ['multihost=true', 'devices=2',
                                       'devices=[0,1]', 'model_devices=2'])
    def test_more_than_one_device_is_not_ported(self, corpus, tmp_path,
                                                extra, monkeypatch):
        """Both axes are ported: devices=2 (or two ids) with device=cpu
        trains two gloo ranks, one process each, for the epoch's 2 steps,
        rank 0 alone logging and writing; so does model_devices=2, the two
        ranks one model group holding the shards of one model (the mesh
        printed as train.py prints it); multihost=true without a
        launcher's environment raises."""
        argv = _argv(corpus, tmp_path, 'device=cpu', extra)
        if extra == 'multihost=true':
            monkeypatch.delenv('WORLD_SIZE', raising=False)
            with pytest.raises(ValueError, match='WORLD_SIZE'):
                main(argv)
            return
        env = {k: v for k, v in os.environ.items()
               if k not in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK')}
        env['OMP_NUM_THREADS'] = '1'
        proc = subprocess.Popen(
            [sys.executable, '-m', 'mr_mt3_tpu_torch.train', *argv,
             'trainer.max_epochs=1'], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        try:
            out = proc.communicate(timeout=240)[0]
        finally:
            if proc.poll() is None:     # the ranks too: one session
                os.killpg(proc.pid, 9)
                proc.wait()
        assert proc.returncode == 0, out[-4000:]
        assert 'ranks 2' in out
        mesh = ({'data': 1, 'model': 2} if extra == 'model_devices=2'
                else {'data': 2, 'model': 1})
        assert out.count(f'train mesh: {mesh}') == 1
        assert load_checkpoint(str(tmp_path / 'checkpoints' / 'final')
                               )['step'] == 2
        steps = [json.loads(ln)['step']
                 for ln in open(tmp_path / 'logs' / 'metrics.jsonl')
                 if 'train_loss' in ln]
        assert steps == [1, 2]

    def test_fast_rng_is_accepted_without_effect(self, corpus, tmp_path,
                                                 capsys):
        state = main(_argv(corpus, tmp_path, 'device=cpu',
                           'trainer.max_epochs=1', '+trainer.fast_rng=true'))
        assert state.step == 2
        assert 'fast_rng' in capsys.readouterr().out
