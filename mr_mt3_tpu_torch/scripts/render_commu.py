"""Render ComMU MIDIs to 16 kHz wav with FluidSynth (port of
mr_mt3_tpu/scripts/render_commu.py).

(reference: scripts/commu/render_commu.py) Program numbers are overwritten
from the instrument-name mapping before rendering. Requires a `fluidsynth`
binary + soundfont; without fluidsynth on PATH the script raises and
explains rather than failing cryptically.

Usage: python -m mr_mt3_tpu_torch.scripts.render_commu <commu_root> \
    <soundfont.sf2>
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
import sys

from mr_mt3_tpu_torch.audio import read_wav, resample, write_wav
from mr_mt3_tpu_torch.midi import note_sequence_to_midi_file, read_midi
from mr_mt3_tpu_torch.midi.reader import midi_to_note_sequence
from mr_mt3_tpu_torch.scripts.commu_const import get_inst_dict


def render_split(root: str, split: str, soundfont: str) -> None:
    if shutil.which('fluidsynth') is None:
        raise RuntimeError(
            'fluidsynth not found on PATH; install it (with a GM soundfont) '
            'to render ComMU audio, or render externally and place wavs in '
            'commu_audio_v2/<split>/')
    inst_dict = get_inst_dict()
    processed = os.path.join(root, 'dataset_processed')
    out_dir = os.path.join(processed, 'commu_audio_v2', split)
    os.makedirs(out_dir, exist_ok=True)
    df_path = os.path.join(processed, 'commu_meta_v2.csv')
    import pandas as pd
    df = pd.read_csv(df_path).set_index('id')

    for midi_path in sorted(glob.glob(os.path.join(
            processed, 'commu_midi_v2', split, '*.mid'))):
        idname = os.path.basename(midi_path)[:-4]
        inst_name = df.loc[idname, 'inst']
        program = next(v for k, v in inst_dict.items() if k in inst_name)
        # stamp the program onto every instrument before rendering
        ns = midi_to_note_sequence(read_midi(midi_path))
        for note in ns.notes:
            note.program = program
        tmp_midi = midi_path + '.render.mid'
        note_sequence_to_midi_file(ns, tmp_midi)
        tmp_wav = os.path.join(out_dir, idname + '.render.wav')
        subprocess.run(['fluidsynth', '-ni', soundfont, tmp_midi,
                        '-F', tmp_wav, '-r', '44100'], check=True)
        audio, sr = read_wav(tmp_wav)
        audio = resample(audio, sr, 16000)
        write_wav(os.path.join(out_dir, idname + '_16k.wav'), audio, 16000,
                  subtype='PCM_24')
        os.remove(tmp_midi)
        os.remove(tmp_wav)


if __name__ == '__main__':
    for split in ['train', 'val', 'test']:
        render_split(sys.argv[1], split, sys.argv[2])
