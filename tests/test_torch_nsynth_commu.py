"""The port's NSynth and ComMU scripts against the JAX package's on the
same fabricated inputs (mirroring tests/test_scripts_tools.py:62-96): the
MIDI files, the parsed JSON and the scores of the NSynth scripts, the
ComMU split's CSV and moved files, and render_commu's guarded raise and
program override (fluidsynth stood in for, nothing rendered)."""

import json
import os
import shutil

import numpy as np
import pytest

from mr_mt3_tpu.scripts import convert_nsynth_json_to_midi as jax_nsynth_midi
from mr_mt3_tpu.scripts import create_commu_test_split as jax_split
from mr_mt3_tpu.scripts import evaluate_nsynth_json as jax_nsynth_eval
from mr_mt3_tpu.scripts import parse_nsynth_valid as jax_nsynth_parse
from mr_mt3_tpu.scripts import render_commu as jax_render
from mr_mt3_tpu_torch.codec.note_sequences import NoteSequence
from mr_mt3_tpu_torch.midi import (
    midi_file_to_note_sequence,
    note_sequence_to_midi_file,
)
from mr_mt3_tpu_torch.scripts import commu_const
from mr_mt3_tpu_torch.scripts import convert_nsynth_json_to_midi
from mr_mt3_tpu_torch.scripts import create_commu_test_split
from mr_mt3_tpu_torch.scripts import evaluate_nsynth_json
from mr_mt3_tpu_torch.scripts import parse_nsynth_valid
from mr_mt3_tpu_torch.scripts import render_commu

EXAMPLES = {
    'guitar_acoustic_000-060-100': {
        'pitch': 60, 'velocity': 100, 'instrument_family_str': 'guitar'},
    'bass_electronic_018-036-075': {
        'pitch': 36, 'velocity': 75, 'instrument_family_str': 'bass'},
    'keyboard_acoustic_004-071-127': {
        'pitch': 71, 'velocity': 127, 'instrument_family_str': 'keyboard'},
    'vocal_synthetic_001-062-050': {
        'pitch': 62, 'velocity': 50, 'instrument_family_str': 'string'},
}


def _notes(path):
    ns = midi_file_to_note_sequence(path)
    return [(n.pitch, n.velocity, n.program, round(n.start_time, 6),
             round(n.end_time, 6), n.is_drum) for n in ns.notes]


def _nsynth_dir(root):
    root.mkdir()
    with open(root / 'examples.json', 'w') as f:
        json.dump(EXAMPLES, f)
    return root


def test_nsynth_scripts_equal_jax(tmp_path):
    mine = _nsynth_dir(tmp_path / 'port')
    theirs = _nsynth_dir(tmp_path / 'jax')
    convert_nsynth_json_to_midi.main(str(mine))
    jax_nsynth_midi.main(str(theirs))
    names = sorted(os.listdir(mine / 'midi'))
    assert names == sorted(os.listdir(theirs / 'midi'))
    assert len(names) == 3                          # the vocal is skipped
    for name in names:
        assert (mine / 'midi' / name).read_bytes() == \
            (theirs / 'midi' / name).read_bytes()
    (pitch, _, program, start, _, _), = _notes(
        mine / 'midi' / 'guitar_acoustic_000-060-100.mid')
    assert (pitch, program) == (60, 24)
    assert start == pytest.approx(0.05, abs=0.003)

    # a transcription that got one clip's family wrong and added a pitch
    ns = NoteSequence()
    for pitch in (71, 74):
        ns.add_note(pitch=pitch, velocity=100, start_time=0.05,
                    end_time=1.0, program=40, is_drum=False, instrument=0)
    ns.total_time = 1.0
    for root in (mine, theirs):
        note_sequence_to_midi_file(
            ns, root / 'midi' / 'keyboard_acoustic_004-071-127.mid')
    got = parse_nsynth_valid.parse(str(mine / 'examples.json'),
                                   str(mine / 'midi' / '*.mid'))
    want = jax_nsynth_parse.parse(str(theirs / 'examples.json'),
                                  str(theirs / 'midi' / '*.mid'))
    assert got == want
    assert got['keyboard_acoustic_004-071-127']['predicted']['events'] == [
        {'instrument': 'strings', 'pitch': [71, 74]}]
    scores = evaluate_nsynth_json.evaluate(got)
    assert scores == jax_nsynth_eval.evaluate(want)
    assert scores['instrument_acc'] == pytest.approx(2 / 3)
    assert scores['pitch_acc'] == 1.0


def _commu_root(root, rows):
    """dataset/commu_meta.csv and dataset/commu_midi/<set>/raw/<id>.mid."""
    (root / 'dataset').mkdir(parents=True)
    lines = ['id,inst,bpm']
    for i, (idname, inst) in enumerate(rows):
        lines.append(f'{idname},{inst},{100 + i}')
        raw = root / 'dataset' / 'commu_midi' / ('train' if i % 2 else
                                                  'val') / 'raw'
        raw.mkdir(parents=True, exist_ok=True)
        ns = NoteSequence()
        ns.add_note(pitch=60 + i % 12, velocity=90, start_time=0.0,
                    end_time=0.5, program=0, is_drum=False, instrument=0)
        ns.total_time = 0.5
        note_sequence_to_midi_file(ns, raw / f'{idname}.mid')
    (root / 'dataset' / 'commu_meta.csv').write_text('\n'.join(lines) + '\n')
    return root


COMMU_ROWS = ([(f'commu{i:05d}', 'acoustic_piano') for i in range(40)]
              + [(f'commu{i:05d}', 'string_violin') for i in range(40, 62)]
              + [(f'commu{i:05d}', 'synth_bass_wobble')
                 for i in range(62, 65)])


def test_commu_split_equals_jax(tmp_path):
    pytest.importorskip('pandas')
    mine = _commu_root(tmp_path / 'port', COMMU_ROWS)
    theirs = _commu_root(tmp_path / 'jax', COMMU_ROWS)
    create_commu_test_split.main(str(mine))
    jax_split.main(str(theirs))
    csv = 'dataset_processed/commu_meta_v2.csv'
    assert (mine / csv).read_bytes() == (theirs / csv).read_bytes()
    moved = {}
    for root in (mine, theirs):
        base = root / 'dataset_processed' / 'commu_midi_v2'
        moved[root] = {s: sorted(os.listdir(base / s))
                       for s in ('train', 'val', 'test')}
    assert moved[mine] == moved[theirs]
    assert [len(moved[mine][s]) for s in ('train', 'val', 'test')] == \
        [36 + 19 + 2, 2 + 1 + 0, 2 + 2 + 1]
    assert commu_const.get_inst_dict() == \
        jax_split.get_inst_dict()


def test_render_commu_needs_fluidsynth(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    for module in (render_commu, jax_render):
        with pytest.raises(RuntimeError, match='fluidsynth not found'):
            module.render_split(str(tmp_path), 'test', 'gm.sf2')


def test_render_commu_overrides_programs_as_jax(tmp_path, monkeypatch):
    """With fluidsynth stood in for (it records the programs of the MIDI
    it is handed and writes 0.1 s of silence at 44.1 kHz), both scripts
    hand it each file's instrument program and write the same 16 kHz
    WAVs."""
    pytest.importorskip('pandas')
    rows = [('commu00001', 'string_violin'), ('commu00002', 'bell'),
            ('commu00003', 'synth_bass_wobble')]
    programs = {}

    def fluidsynth(cmd, check):
        from mr_mt3_tpu_torch.audio import write_wav
        midi, wav = cmd[3], cmd[5]
        programs.setdefault(midi.split(os.sep)[-5], []).append(
            sorted({n[2] for n in _notes(midi)}))
        write_wav(wav, np.zeros(4410, np.float32), 44100)
    monkeypatch.setattr(shutil, 'which', lambda name: '/bin/fluidsynth')
    outs = {}
    for name, module in (('port', render_commu), ('jax', jax_render)):
        root = _commu_root(tmp_path / name, rows)
        processed = root / 'dataset_processed'
        test_dir = processed / 'commu_midi_v2' / 'test'
        test_dir.mkdir(parents=True)
        lines = ['id,inst,split_data']
        for idname, inst in rows:
            lines.append(f'{idname},{inst},test')
            src = next((root / 'dataset' / 'commu_midi').glob(
                f'*/raw/{idname}.mid'))
            src.rename(test_dir / f'{idname}.mid')
        (processed / 'commu_meta_v2.csv').write_text('\n'.join(lines) + '\n')
        monkeypatch.setattr(module.subprocess, 'run', fluidsynth)
        module.render_split(str(root), 'test', 'gm.sf2')
        out = processed / 'commu_audio_v2' / 'test'
        outs[name] = {f: (out / f).read_bytes()
                      for f in sorted(os.listdir(out))}
    inst = commu_const.get_inst_dict()
    assert programs['port'] == programs['jax'] == [
        [inst['string_violin']], [inst['bell']], [inst['synth_bass_wobble']]]
    assert outs['port'] == outs['jax']
    assert sorted(outs['port']) == [f'{i}_16k.wav' for i, _ in rows]
