"""ComMU single-track dataset (copy of mr_mt3_tpu/data/commu.py;
reference: dataset/dataset_commu.py).

Differences from Slakh: one MIDI per wav (path derived by string replace),
program/is_drum taken from the first note, contiguous mel_length windows
(split length = mel_length), and token-order randomization always on.
"""

from __future__ import annotations

import os
from glob import glob
from typing import List, Optional

from mr_mt3_tpu_torch.codec import note_sequences as nsq
from mr_mt3_tpu_torch.codec.slakh import (
    PitchBendError,
    add_track_to_notesequence,
)
from mr_mt3_tpu_torch.data import disk_cache
from mr_mt3_tpu_torch.data.slakh import SlakhDataset
from mr_mt3_tpu_torch.midi import midi_file_to_note_sequence


class ComMUDataset(SlakhDataset):

    def __init__(self, root_dir: str, mel_length: int = 256,
                 event_length: int = 1024, is_train: bool = True,
                 include_ties: bool = True, ignore_pitch_bends: bool = True,
                 onsets_only: bool = False, midi_folder: str = 'MIDI',
                 inst_filename: str = 'inst_names.json', shuffle: bool = True,
                 num_rows_per_batch: int = 8, seed: int = 0,
                 cache_songs: bool = True, **kwargs):
        # forward **kwargs so base-class options (is_deterministic,
        # use_tf_spectral_ops, ...) are honored instead of silently
        # dropped; the two ComMU-pinned values below are not overridable
        # (reference: dataset_commu.py:353-356, 378-382 — ComMU always
        # splits into contiguous mel_length windows and always
        # randomizes token order)
        for pinned in ('split_frame_length', 'is_randomize_tokens'):
            if pinned in kwargs:
                raise TypeError(f'{pinned} is fixed for ComMUDataset')
        super().__init__(
            root_dir=root_dir, mel_length=mel_length,
            event_length=event_length, is_train=is_train,
            include_ties=include_ties, ignore_pitch_bends=ignore_pitch_bends,
            onsets_only=onsets_only, midi_folder=midi_folder,
            inst_filename=inst_filename, shuffle=shuffle,
            num_rows_per_batch=num_rows_per_batch,
            split_frame_length=mel_length,
            is_randomize_tokens=True,
            seed=seed, cache_songs=cache_songs, **kwargs)

    def _build_dataset(self, root_dir: str, shuffle: bool) -> List[dict]:
        df = []
        for a_f in sorted(glob(os.path.join(root_dir, '*.wav'))):
            midi_path = a_f.replace('commu_audio_v2', 'commu_midi_v2').replace(
                '_16k.wav', '.mid')
            if not os.path.exists(midi_path):
                raise FileNotFoundError(midi_path)
            df.append({'audio_path': a_f, 'midi_path': midi_path})
        if not df:
            raise FileNotFoundError(f'no wavs under {root_dir}')
        if shuffle:
            self._rng.shuffle(df)
        return df

    def _parse_midi(self, row: dict) -> Optional[nsq.NoteSequence]:
        """Single MIDI per song; program/is_drum from the first note
        (reference: dataset_commu.py:84-96)."""
        track = midi_file_to_note_sequence(row['midi_path'])
        ns = nsq.NoteSequence(ticks_per_quarter=220)
        program = track.notes[0].program if track.notes else 0
        is_drum = track.notes[0].is_drum if track.notes else False
        try:
            add_track_to_notesequence(
                ns, track, program=program, is_drum=is_drum,
                ignore_pitch_bends=self.ignore_pitch_bends)
        except PitchBendError:
            return None
        return ns

    def _midi_fingerprint_parts(self, row: dict) -> list:
        return [disk_cache.hash_file(row['midi_path'])]
