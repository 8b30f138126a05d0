"""The port's data layer (mr_mt3_tpu_torch.data, .midi.reader, .codec.slakh,
.audio.io) against the JAX package's on a fabricated Slakh-format corpus
(the tests/test_data.py:34 recipe) and a ComMU-format one: items bit-equal
for the three Slakh classes and ComMU over two visits, the DataLoader's
batch order, equal NoteSequences from the MIDI reader; and the dataset
configs (configs/dataset/*.yaml name mr_mt3_tpu.data classes) building
the port's datasets without importing the JAX package."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mr_mt3_tpu import data as jdata
from mr_mt3_tpu.audio import write_wav
from mr_mt3_tpu.codec import note_sequences as jnsq
from mr_mt3_tpu.midi import midi_file_to_note_sequence as jax_read
from mr_mt3_tpu.midi import note_sequence_to_midi_file
from mr_mt3_tpu_torch import data as pdata
from mr_mt3_tpu_torch.audio import read_audio
from mr_mt3_tpu_torch.midi import midi_file_to_note_sequence as port_read
from mr_mt3_tpu_torch.midi import read_midi
from mr_mt3_tpu_torch.utils.config import instantiate, resolve_target

REPO = Path(__file__).resolve().parent.parent


def _write_track(path, notes, program=0, is_drum=False):
    ns = jnsq.NoteSequence()
    for start, end, pitch in notes:
        ns.add_note(start_time=start, end_time=end, pitch=pitch, velocity=100,
                    program=program, is_drum=is_drum,
                    instrument=9 if is_drum else 0)
        ns.total_time = max(ns.total_time, end)
    note_sequence_to_midi_file(ns, path)


@pytest.fixture(scope='module')
def slakh_root(tmp_path_factory):
    """Three-song Slakh-format corpus, ~20 s each at 16 kHz (the
    tests/test_data.py recipe, one more song for the loader's order)."""
    root = tmp_path_factory.mktemp('slakh')
    rng = np.random.default_rng(0)
    for song in ['Track00001', 'Track00002', 'Track00003']:
        d = root / song
        (d / 'MIDI').mkdir(parents=True)
        audio = (rng.normal(size=16000 * 20) * 0.05).astype(np.float32)
        write_wav(d / 'mix_16k.wav', audio, 16000)
        piano = [(0.5 + i, 0.9 + i, 60 + (i % 12)) for i in range(18)]
        _write_track(d / 'MIDI' / 'S00.mid', piano, program=0)
        bass = [(0.25 + 2 * i, 1.25 + 2 * i, 40 + (i % 5)) for i in range(9)]
        _write_track(d / 'MIDI' / 'S01.mid', bass, program=33)
        drums = [(0.5 * i, 0.5 * i + 0.05, 36) for i in range(36)]
        _write_track(d / 'MIDI' / 'S02.mid', drums, is_drum=True)
        with open(d / 'inst_names.json', 'w') as f:
            json.dump({'S00': 'Acoustic Piano', 'S01': 'Electric Bass',
                       'S02': 'Drums'}, f)
    return str(root)


@pytest.fixture(scope='module')
def commu_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('commu')
    audio_dir = root / 'commu_audio_v2' / 'train'
    midi_dir = root / 'commu_midi_v2' / 'train'
    audio_dir.mkdir(parents=True)
    midi_dir.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for name in ['commu00001', 'commu00002']:
        audio = (rng.normal(size=16000 * 8) * 0.05).astype(np.float32)
        write_wav(audio_dir / f'{name}_16k.wav', audio, 16000)
        notes = [(0.5 * i, 0.5 * i + 0.3, 50 + i) for i in range(12)]
        _write_track(midi_dir / f'{name}.mid', notes, program=33)
    return str(audio_dir)


def _assert_items_equal(a, b):
    assert a is not None and b is not None
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


SLAKH_CASES = [
    pytest.param('SlakhDataset', {}, id='slakh'),
    pytest.param('SlakhDataset', dict(is_deterministic=True,
                                      is_randomize_tokens=False),
                 id='slakh_deterministic'),
    pytest.param('SlakhDatasetWithPrevSegmem', {}, id='prev'),
    pytest.param('SlakhDatasetWithPrevSegmem', dict(is_deterministic=True),
                 id='prev_deterministic'),
    pytest.param('SlakhDatasetWithPrevSegmemAugment',
                 dict(prev_augment_frames=3), id='prev_augment'),
]


@pytest.mark.parametrize('cls,kw', SLAKH_CASES)
def test_slakh_items_bit_equal(slakh_root, cls, kw):
    """Two visits of every song (fresh randomness each): the same
    windows, audio, valid frames, targets and memory targets."""
    args = dict(shuffle=True, num_rows_per_batch=3, split_frame_length=512,
                seed=7, **kw)
    mine = getattr(pdata, cls)(slakh_root, **args)
    ref = getattr(jdata, cls)(slakh_root, **args)
    assert [r['audio_path'] for r in mine.df] == \
        [r['audio_path'] for r in ref.df]
    for _ in range(2):
        for idx in range(len(ref)):
            _assert_items_equal(mine[idx], ref[idx])


def test_commu_items_bit_equal(commu_root):
    mine = pdata.ComMUDataset(commu_root, num_rows_per_batch=3, seed=4)
    ref = jdata.ComMUDataset(commu_root, num_rows_per_batch=3, seed=4)
    for _ in range(2):
        for idx in range(len(ref)):
            _assert_items_equal(mine[idx], ref[idx])


def test_loader_order_matches(slakh_root):
    """Shuffled batches of 2 songs over two epochs: the same batches in
    the same order (the row-concatenating collate included)."""
    args = dict(shuffle=False, num_rows_per_batch=2,
                split_frame_length=256, is_deterministic=True)
    loaders = [mod.DataLoader(mod.SlakhDatasetWithPrevSegmem(slakh_root,
                                                             **args),
                              batch_size=2, shuffle=True, num_workers=2,
                              seed=11)
               for mod in (pdata, jdata)]
    assert len(loaders[0]) == len(loaders[1]) == 2
    for _ in range(2):
        got, want = (list(ld) for ld in loaders)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            _assert_items_equal(a, b)


def test_collate_matches(slakh_root):
    ds = pdata.SlakhDataset(slakh_root, shuffle=False, num_rows_per_batch=2,
                            split_frame_length=256, is_deterministic=True)
    items = [ds[0], None, ds[1]]
    got = pdata.collate_batch(items)
    assert got['targets'].shape == (4, 1024)
    _assert_items_equal(got, jdata.collate_batch(items))
    with pytest.raises(ValueError, match='None'):
        pdata.collate_batch([None])


def test_midi_reader_gives_equal_note_sequences(slakh_root):
    for path in sorted(Path(slakh_root).glob('*/MIDI/*.mid')):
        mine, ref = port_read(str(path)), jax_read(str(path))
        assert len(mine.notes) == len(ref.notes) > 0
        for a, b in zip(mine.notes, ref.notes):
            assert vars(a) == vars(b)
        assert mine.total_time == ref.total_time
        assert mine.ticks_per_quarter == ref.ticks_per_quarter
        assert [vars(c) for c in mine.control_changes] == \
            [vars(c) for c in ref.control_changes]
        assert [vars(p) for p in mine.pitch_bends] == \
            [vars(p) for p in ref.pitch_bends]
    midi = read_midi(str(path))
    assert midi.instruments and midi.instruments[0].is_drum


def test_read_audio_wav_and_flac(slakh_root, tmp_path):
    from mr_mt3_tpu.audio import read_audio as jax_read_audio
    wav = os.path.join(slakh_root, 'Track00001', 'mix_16k.wav')
    (a, sr), (b, jsr) = read_audio(wav), jax_read_audio(wav)
    assert sr == jsr == 16000
    np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError, match='FLAC'):
        read_audio(str(tmp_path / 'mix.flac'))


def test_disk_cache_round_trip(slakh_root, tmp_path):
    """The port's tokenization cache: a warm instance reads its entries
    and gives the cold instance's items."""
    args = dict(shuffle=False, is_deterministic=True, num_rows_per_batch=2,
                cache_dir=str(tmp_path / 'cache'))
    cold = pdata.SlakhDataset(slakh_root, **args)
    items = [cold[i] for i in range(len(cold))]
    assert any(f.suffix == '.npz' for f in (tmp_path / 'cache').iterdir())
    warm = pdata.SlakhDataset(slakh_root, **args)
    from mr_mt3_tpu_torch.data import transforms

    def forbidden(*a, **k):
        raise AssertionError('re-tokenized on a warm cache')
    real = transforms.tokenize_song
    transforms.tokenize_song = forbidden
    try:
        for i, item in enumerate(items):
            _assert_items_equal(warm[i], item)
    finally:
        transforms.tokenize_song = real


class TestConfigTargets:
    def test_jax_targets_map_into_the_port(self):
        assert resolve_target('mr_mt3_tpu.data.slakh.SlakhDataset') == \
            'mr_mt3_tpu_torch.data.slakh.SlakhDataset'
        assert resolve_target('mr_mt3_tpu_torch.data.commu.ComMUDataset') \
            == 'mr_mt3_tpu_torch.data.commu.ComMUDataset'
        for bad in ('mr_mt3_tpu.models.MT3', 'os.system',
                    'mr_mt3_tpu.train.trainer.Trainer'):
            with pytest.raises(ValueError, match='_target_'):
                instantiate({'_target_': bad})

    @pytest.mark.parametrize('name', ['Slakh', 'SlakhPrev',
                                      'SlakhPrevAugment', 'ComMU'])
    def test_building_datasets_leaves_jax_unimported(self, name, slakh_root,
                                                     commu_root):
        """builders.build_datasets on configs/dataset/<name>.yaml, in a
        fresh process: the port's classes, and no mr_mt3_tpu or jax module
        loaded."""
        root = commu_root if name == 'ComMU' else slakh_root
        code = (
            'import sys\n'
            'from mr_mt3_tpu_torch.utils import builders\n'
            'from mr_mt3_tpu_torch.utils.config import load_config\n'
            f'cfg = load_config("configs", "config", ["dataset={name}",\n'
            f'    "dataset.train.root_dir={root}",\n'
            f'    "dataset.val.root_dir={root}"])\n'
            'train, val = builders.build_datasets(cfg)\n'
            'print(type(train).__module__, type(val).__name__, len(train))\n'
            'bad = sorted(n for n in sys.modules\n'
            '             if n.split(".")[0] in ("mr_mt3_tpu", "jax"))\n'
            'assert not bad, bad\n')
        out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.startswith('mr_mt3_tpu_torch.data.')
