"""The port's Slakh preparation and leakage scripts
(mr_mt3_tpu_torch/scripts/) against the JAX package's
(mr_mt3_tpu/scripts/), each run on its own copy of one fabricated raw
Slakh tree: metadata.yaml, MIDI stems and a 44.1 kHz mix.flac per song.
The prepared files must be byte-equal and the analyses' dicts equal."""

import json
import os
import shutil

import numpy as np
import pytest
import yaml

from mr_mt3_tpu.scripts import generate_inst_names as jax_inst_names
from mr_mt3_tpu.scripts import instrument_leakage as jax_leakage
from mr_mt3_tpu.scripts import merge_slakh_midi as jax_merge
from mr_mt3_tpu.scripts import resample_slakh as jax_resample
from mr_mt3_tpu_torch.codec import note_sequences as nsq
from mr_mt3_tpu_torch.midi import note_sequence_to_midi_file, read_midi
from mr_mt3_tpu_torch.native import encode_flac_bytes
from mr_mt3_tpu_torch.scripts import (
    generate_inst_names,
    instrument_leakage,
    merge_slakh_midi,
    resample_slakh,
)

# (stem, program, is_drum, integrated_loudness): the last is not rendered
STEMS = [('S00', 0, False, -14.5), ('S01', 33, False, -18.0),
         ('S02', 0, True, -12.25), ('S03', 27, False, None)]
SPLITS = {'train': 2, 'validation': 1}


def _write_stem(path, rng, program, drum, seconds):
    ns = nsq.NoteSequence()
    for start in np.arange(0.1, seconds - 0.4, 0.3):
        ns.add_note(start_time=float(start), end_time=float(start) + 0.2,
                    pitch=int(rng.integers(36, 84)),
                    velocity=int(rng.integers(40, 128)), program=program,
                    is_drum=drum, instrument=9 if drum else 0)
    ns.total_time = seconds
    note_sequence_to_midi_file(ns, path)


def _raw_slakh(root, seconds=3.0):
    """<root>/<split>/TrackNNNNN/{mix.flac, MIDI/S0*.mid, metadata.yaml},
    the layout slakh2100_flac_redux ships."""
    rng = np.random.default_rng(0)
    for split, songs in SPLITS.items():
        for i in range(songs):
            d = os.path.join(root, split, f'Track{len(split)}{i:04d}')
            os.makedirs(os.path.join(d, 'MIDI'))
            t = np.arange(int(44100 * seconds)) / 44100
            mix = (0.3 * np.sin(2 * np.pi * (220 + 110 * i) * t)
                   + 0.01 * rng.normal(size=t.shape))
            with open(os.path.join(d, 'mix.flac'), 'wb') as f:
                f.write(encode_flac_bytes(
                    np.round(mix * 32767).astype(np.int32), 44100))
            stems = {}
            for stem, program, drum, loudness in STEMS:
                _write_stem(os.path.join(d, 'MIDI', f'{stem}.mid'), rng,
                            program, drum, seconds)
                stems[stem] = {'program_num': program, 'is_drum': drum,
                               'integrated_loudness': loudness,
                               'audio_rendered': loudness is not None}
            with open(os.path.join(d, 'metadata.yaml'), 'w') as f:
                yaml.safe_dump({'audio_dir': 'stems', 'midi_dir': 'MIDI',
                                'stems': stems}, f)


def _prepare(root, scripts):
    inst_names, merge, resample = scripts
    for split in SPLITS:
        inst_names.main(os.path.join(root, split))
        merge.main(os.path.join(root, split))
    failed = resample.main(root)
    assert not failed


@pytest.fixture(scope='module')
def prepared(tmp_path_factory):
    """The raw tree copied twice, prepared by the port's scripts and by the
    JAX package's."""
    base = tmp_path_factory.mktemp('slakh')
    raw = str(base / 'raw')
    _raw_slakh(raw)
    port, jax = str(base / 'port'), str(base / 'jax')
    shutil.copytree(raw, port)
    shutil.copytree(raw, jax)
    _prepare(port, (generate_inst_names, merge_slakh_midi, resample_slakh))
    _prepare(jax, (jax_inst_names, jax_merge, jax_resample))
    return port, jax


def _songs(root):
    return sorted(os.path.relpath(os.path.join(dp), root)
                  for dp, dirs, _ in os.walk(root) if 'MIDI' in dirs)


@pytest.mark.parametrize('name', ['inst_names.json', 'all_src_v2.mid',
                                  'mix_16k.wav'])
def test_prepared_files_equal_jax(prepared, name):
    port, jax = prepared
    songs = _songs(port)
    assert songs == _songs(jax) and len(songs) == sum(SPLITS.values())
    for song in songs:
        with open(os.path.join(port, song, name), 'rb') as a, \
                open(os.path.join(jax, song, name), 'rb') as b:
            assert a.read() == b.read(), f'{song}/{name}'


def test_prepared_files_read_back(prepared):
    port, _ = prepared
    for song in _songs(port):
        names = json.load(open(os.path.join(port, song, 'inst_names.json')))
        assert names == {'S00': 'Acoustic Piano', 'S01': 'Electric Bass',
                         'S02': 'Drums'}
        merged = read_midi(os.path.join(port, song, 'all_src_v2.mid'))
        assert len(merged.instruments) == len(STEMS)
        from mr_mt3_tpu_torch.audio import read_wav
        audio, sr = read_wav(os.path.join(port, song, 'mix_16k.wav'))
        assert sr == 16000 and len(audio) == 3 * 16000


def _transcriptions(out, truth, rng):
    """<out>/<song>/mix.mid with a subset of the truth's programs and one
    program it lacks, as a transcription run writes them."""
    for song in sorted(os.listdir(truth)):
        os.makedirs(os.path.join(out, song))
        ns = nsq.NoteSequence()
        for k, program in enumerate([0, 33, 74][:1 + int(rng.integers(3))]):
            ns.add_note(start_time=0.1 * k, end_time=0.1 * k + 0.5,
                        pitch=60 + k, velocity=100, program=program,
                        instrument=k)
        ns.total_time = 1.0
        note_sequence_to_midi_file(ns, os.path.join(out, song, 'mix.mid'))


def test_leakage_equals_jax(prepared, tmp_path):
    port, _ = prepared
    truth = os.path.join(port, 'train')
    out = str(tmp_path / 'out')
    _transcriptions(out, truth, np.random.default_rng(1))
    for directory in (out, truth):
        counts = instrument_leakage.count_num_instruments(directory, truth)
        assert counts == jax_leakage.count_num_instruments(directory, truth)
        stats = instrument_leakage.instrument_presence_f1(directory, truth)
        assert stats == jax_leakage.instrument_presence_f1(directory, truth)
    # the ground truth against itself: its distinct programs (piano and
    # drums share program 0), a perfect presence score
    assert instrument_leakage.count_num_instruments(truth, truth) == {
        song: 3 for song in os.listdir(truth)}
    assert instrument_leakage.instrument_presence_f1(truth, truth)['f1'] \
        == 1.0


def test_leakage_cli(prepared, tmp_path, capsys):
    port, _ = prepared
    truth = os.path.join(port, 'train')
    out = str(tmp_path / 'out')
    _transcriptions(out, truth, np.random.default_rng(2))
    import sys
    argv = sys.argv
    sys.argv = ['instrument_leakage', '--ground_truth', truth, out]
    try:
        instrument_leakage.main()
    finally:
        sys.argv = argv
    printed = capsys.readouterr().out
    assert 'distinct programs per song' in printed and 'f1:' in printed
