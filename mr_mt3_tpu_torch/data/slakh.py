"""Slakh2100 dataset pipelines (copy of mr_mt3_tpu/data/slakh.py).

Behavior-compatible rebuild of the reference datasets
(reference: dataset/dataset_2_random.py, dataset_2_random_segmem_prev.py,
dataset_2_random_segmem_prev_augment.py) with two deliberate changes:

  * per-song tokenizations are cached in memory — the reference re-parses
    MIDI and re-runs the RLE hot loop every epoch; optionally also cached
    on disk (cache_dir / MR_MT3_TOKEN_CACHE, see data/disk_cache.py) so a
    process RESTART skips the ~40-min cold tokenization pass too;
  * items carry raw audio segments + valid frame counts; the log-mel runs
    inside the train step on the device (see data/transforms.py docstring).

One __getitem__ returns a *mini-batch* of `num_rows_per_batch` segments
sampled from a single song, exactly like the reference
(reference: dataset_2_random.py:385-420).
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict, List, Optional

import numpy as np

from mr_mt3_tpu_torch.audio import read_audio, resample
from mr_mt3_tpu_torch.audio.frontend import SpectrogramConfig
from mr_mt3_tpu_torch.codec import (
    VocabularyConfig,
    build_codec,
    vocabulary_from_codec,
)
from mr_mt3_tpu_torch.codec import note_sequences as nsq
from mr_mt3_tpu_torch.codec.events import Event
from mr_mt3_tpu_torch.codec.slakh import (
    PitchBendError,
    add_track_to_notesequence,
    slakh_class_to_program_and_is_drum,
)
from mr_mt3_tpu_torch.data import disk_cache, transforms
from mr_mt3_tpu_torch.midi import midi_file_to_note_sequence


class SlakhDataset:
    """Map-style dataset over Slakh songs.

    Items are dicts of numpy arrays:
      audio:        (rows, mel_length*hop) float32 raw segment audio
      valid_frames: (rows,) int32
      targets:      (rows, event_length) int64 model-space tokens
    """

    def __init__(
        self,
        root_dir: str,
        mel_length: int = 256,
        event_length: int = 1024,
        is_train: bool = True,
        include_ties: bool = True,
        ignore_pitch_bends: bool = True,
        onsets_only: bool = False,
        audio_filename: str = 'mix_16k.wav',
        midi_folder: str = 'MIDI',
        inst_filename: str = 'inst_names.json',
        shuffle: bool = True,
        num_rows_per_batch: int = 8,
        split_frame_length: int = 2000,
        is_randomize_tokens: bool = True,
        is_deterministic: bool = False,
        seed: int = 0,
        cache_songs: bool = True,
        cache_dir: Optional[str] = None,
        use_tf_spectral_ops: bool = False,  # accepted for config parity
    ) -> None:
        self.spectrogram_config = SpectrogramConfig(
            filterbank_style='tf' if use_tf_spectral_ops else 'torch')
        self.codec = build_codec(VocabularyConfig(num_velocity_bins=1))
        self.vocab = vocabulary_from_codec(self.codec)
        self.audio_filename = audio_filename
        self.midi_folder = midi_folder
        self.inst_filename = inst_filename
        self.mel_length = mel_length
        self.event_length = event_length
        self.is_train = is_train
        self.include_ties = include_ties
        self.ignore_pitch_bends = ignore_pitch_bends
        self.onsets_only = onsets_only
        self.tie_token = (self.codec.encode_event(Event('tie', 0))
                          if include_ties else None)
        self.num_rows_per_batch = num_rows_per_batch
        self.split_frame_length = split_frame_length
        self.is_randomize_tokens = is_randomize_tokens
        self.is_deterministic = is_deterministic
        self._seed = seed
        self._rng = np.random.default_rng(seed)  # shuffle only (ctor thread)
        import threading
        self._count_lock = threading.Lock()
        self._visit_counts: Dict[int, int] = {}
        self._cache: Dict[int, transforms.SongFeatures] = {}
        self.cache_songs = cache_songs
        resolved = disk_cache.resolve_cache_dir(cache_dir, root_dir)
        self._disk = (disk_cache.TokenizationCache(resolved)
                      if resolved else None)
        self.df = self._build_dataset(root_dir, shuffle=shuffle)

    # ---- file discovery (reference: dataset_2_random.py:65-79) ----

    def _build_dataset(self, root_dir: str, shuffle: bool) -> List[dict]:
        df = []
        audio_files = sorted(
            glob(os.path.join(root_dir, '**', self.audio_filename),
                 recursive=True))
        for a_f in audio_files:
            inst_path = a_f.replace(self.audio_filename, self.inst_filename)
            midi_path = a_f.replace(self.audio_filename, self.midi_folder)
            with open(inst_path) as f:
                inst_names = json.load(f)
            df.append({'inst_names': inst_names, 'audio_path': a_f,
                       'midi_path': midi_path})
        if not df:
            raise FileNotFoundError(
                f'no {self.audio_filename} under {root_dir}')
        if shuffle:
            self._rng.shuffle(df)
        return df

    def __len__(self) -> int:
        return len(self.df)

    # ---- song loading + tokenization (cached) ----

    def _parse_midi(self, row: dict) -> Optional[nsq.NoteSequence]:
        """All stems merged into one NoteSequence; None = PitchBendError
        (the reference skips such songs — dataset_2_random.py:97-101)."""
        ns = nsq.NoteSequence(ticks_per_quarter=220)
        for stem, inst_name in row['inst_names'].items():
            program, is_drum = slakh_class_to_program_and_is_drum(inst_name)
            track = midi_file_to_note_sequence(
                os.path.join(row['midi_path'], f'{stem}.mid'))
            try:
                add_track_to_notesequence(
                    ns, track, program=program, is_drum=is_drum,
                    ignore_pitch_bends=self.ignore_pitch_bends)
            except PitchBendError:
                return None
        return ns

    def _midi_fingerprint_parts(self, row: dict) -> list:
        """Content parts identifying the song's MIDI side for the disk
        cache key (sorted by stem for order stability)."""
        parts = []
        for stem, inst_name in sorted(row['inst_names'].items()):
            parts += [stem, inst_name, disk_cache.hash_file(
                os.path.join(row['midi_path'], f'{stem}.mid'))]
        return parts

    def _song_key(self, row: dict) -> str:
        sc = self.spectrogram_config
        return disk_cache.hash_parts(
            *self._midi_fingerprint_parts(row),
            self.is_train, self.include_ties, self.onsets_only,
            self.ignore_pitch_bends,
            sc.hop_width, sc.sample_rate,
            self.codec.steps_per_second, self.codec.max_shift_steps,
            self.codec.num_classes)

    def _read_audio(self, row: dict) -> np.ndarray:
        audio, sr = read_audio(row['audio_path'])
        if sr != self.spectrogram_config.sample_rate:
            audio = resample(audio, sr, self.spectrogram_config.sample_rate)
        return np.asarray(audio, dtype=np.float32)

    def _load_song(self, idx: int) -> Optional[transforms.SongFeatures]:
        if idx in self._cache:
            return self._cache[idx]
        row = self.df[idx]
        key = self._song_key(row) if self._disk else None
        entry = self._disk.get(key) if self._disk else None
        if entry is not None and entry['skipped']:
            return None

        audio = self._read_audio(row)
        hop = self.spectrogram_config.hop_width
        if len(audio) % hop != 0:  # same padding as tokenize_song
            audio = np.pad(audio, (0, hop - len(audio) % hop))
        num_frames = len(audio) // hop

        if entry is not None and entry['num_frames'] == num_frames:
            song = transforms.SongFeatures(
                audio=audio,
                frame_times=(np.arange(num_frames)
                             / self.spectrogram_config.frames_per_second),
                events=entry['events'],
                event_start_indices=entry['event_start_indices'],
                event_end_indices=entry['event_end_indices'],
                state_events=entry['state_events'],
                state_event_indices=entry['state_event_indices'])
        else:
            ns = self._parse_midi(row)
            if ns is None:
                if self._disk:
                    self._disk.put(key, None)
                return None
            song = transforms.tokenize_song(
                ns, audio, self.codec,
                spectrogram_config=self.spectrogram_config,
                is_train=self.is_train, include_ties=self.include_ties,
                onsets_only=self.onsets_only)
            if self._disk:
                self._disk.put(key, {
                    'events': song.events,
                    'event_start_indices': song.event_start_indices,
                    'event_end_indices': song.event_end_indices,
                    'state_events': song.state_events,
                    'state_event_indices': song.state_event_indices,
                }, num_frames=song.num_frames)
        if self.cache_songs:
            self._cache[idx] = song
        return song

    # ---- segment sampling ----

    def _sample_windows(self, song: transforms.SongFeatures,
                        rng: Optional[np.random.Generator]):
        windows = transforms.split_frames(song.num_frames,
                                          self.split_frame_length)
        if len(windows) > self.num_rows_per_batch:
            if rng is None:
                start = 0
            else:
                start = int(rng.integers(
                    0, len(windows) - self.num_rows_per_batch + 1))
            windows = windows[start:start + self.num_rows_per_batch]
        return windows

    def _chunk(self, window, rng):
        return transforms.random_chunk(window, self.mel_length, rng,
                                       deterministic_start=0)

    def _segment_targets(self, song, window, rng) -> np.ndarray:
        tokens = transforms.extract_segment_tokens(
            song, window, self.codec, self.tie_token)
        tokens = transforms.rle.run_length_encode_shifts(
            tokens, self.codec,
            drop_redundant_state_changes=not self.is_randomize_tokens)
        if self.is_randomize_tokens and rng is not None:
            tokens = transforms.augment_token_order(tokens, self.codec, rng)
        return transforms.finalize_targets(tokens, self.codec,
                                           self.event_length)

    def _item_rng(self, idx: int) -> np.random.Generator:
        """Thread-safe per-item RNG: derived from (seed, idx, visit count)
        so loader worker threads never share Generator state and epochs
        draw fresh randomness deterministically."""
        with self._count_lock:
            visit = self._visit_counts.get(idx, 0)
            self._visit_counts[idx] = visit + 1
        return np.random.default_rng([self._seed, idx, visit])

    def __getitem__(self, idx: int) -> Optional[Dict[str, np.ndarray]]:
        song = self._load_song(idx)
        if song is None:
            return None
        rng = None if self.is_deterministic else self._item_rng(idx)
        windows = self._sample_windows(song, rng)
        hop = self.spectrogram_config.hop_width

        audio_rows, valid_rows, target_rows = [], [], []
        for window in windows:
            chunk = self._chunk(window, rng)
            audio, valid, _ = transforms.segment_audio(
                song, chunk, self.mel_length, hop)
            audio_rows.append(audio)
            valid_rows.append(valid)
            target_rows.append(self._segment_targets(song, chunk, rng))

        return {
            'audio': np.stack(audio_rows),
            'valid_frames': np.array(valid_rows, dtype=np.int32),
            'targets': np.stack(target_rows),
        }


class SlakhDatasetWithPrevSegmem(SlakhDataset):
    """Adds the previous segment's tokens for explicit segment memory
    (reference: dataset_2_random_segmem_prev.py)."""

    def __getitem__(self, idx: int) -> Optional[Dict[str, np.ndarray]]:
        song = self._load_song(idx)
        if song is None:
            return None
        rng = None if self.is_deterministic else self._item_rng(idx)
        windows = self._sample_windows(song, rng)
        hop = self.spectrogram_config.hop_width

        audio_rows, valid_rows, target_rows, prev_rows = [], [], [], []
        for window in windows:
            chunk = self._chunk_with_prev(window, rng)
            chunk, prev_chunk = chunk
            audio, valid, _ = transforms.segment_audio(
                song, chunk, self.mel_length, hop)
            audio_rows.append(audio)
            valid_rows.append(valid)
            target_rows.append(self._segment_targets(song, chunk, rng))
            if prev_chunk is None:
                prev_tokens = transforms.finalize_targets(
                    self._maybe_augment(transforms.EMPTY_PREV_TOKENS, rng),
                    self.codec, self.event_length)
            else:
                prev_tokens = self._segment_targets(song, prev_chunk, rng)
            prev_rows.append(prev_tokens)

        return {
            'audio': np.stack(audio_rows),
            'valid_frames': np.array(valid_rows, dtype=np.int32),
            'targets': np.stack(target_rows),
            'targets_prev': np.stack(prev_rows),
        }

    def _maybe_augment(self, tokens, rng):
        if self.is_randomize_tokens and rng is not None:
            return transforms.augment_token_order(tokens, self.codec, rng)
        return tokens

    def _prev_offset_segments(self, rng) -> int:
        """How many mel_lengths back the memory segment sits."""
        return 1

    def _chunk_with_prev(self, window, rng):
        """Chunk + the window one (or N) mel_lengths earlier
        (reference: dataset_2_random_segmem_prev.py:135-157)."""
        slack = window.length - self.mel_length
        if slack < 1:
            return window, None
        if rng is None:
            # Deterministic pin. The reference's own deterministic branch
            # CRASHES here (start_length_prev is only assigned in the
            # random branch — dataset_2_random_segmem_prev.py:142-147
            # raises NameError at :152), so there is no reference behavior
            # to match; we pin a start that yields a real previous segment
            # whenever the window allows one, so deterministic eval
            # exercises the memory path instead of always seeing the
            # empty seed.
            offset = self._prev_offset_segments(rng) * self.mel_length
            start = offset + 16 if slack >= offset + 16 else 16
        else:
            start = int(rng.integers(0, slack + 1))
        prev_start = start - self._prev_offset_segments(rng) * self.mel_length
        chunk = transforms.FrameWindow(window.start + start, self.mel_length)
        prev = None
        # strictly > 0, not >= : a chunk starting exactly one memory
        # offset into the window has a complete in-bounds previous
        # segment at prev_start == 0, but the reference drops it
        # (`if start_length_prev > 0:`,
        # dataset_2_random_segmem_prev.py:153) — bug-compatible; trained
        # models expect that distribution
        if prev_start > 0:
            prev = transforms.FrameWindow(window.start + prev_start,
                                          self.mel_length)
        return chunk, prev

    def _sample_windows(self, song, rng):
        windows = transforms.split_frames(song.num_frames,
                                          self.split_frame_length)
        if len(windows) > self.num_rows_per_batch:
            if rng is None:
                start = 2  # reference's deterministic pin (:170-171)
            else:
                start = int(rng.integers(
                    0, len(windows) - self.num_rows_per_batch + 1))
            windows = windows[start:start + self.num_rows_per_batch]
        return windows


class SlakhDatasetWithPrevSegmemAugment(SlakhDatasetWithPrevSegmem):
    """Memory segment drawn uniformly from 1..prev_augment_frames segments
    back (reference: dataset_2_random_segmem_prev_augment.py:52-78)."""

    def __init__(self, *args, prev_augment_frames: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        self.prev_augment_frames = prev_augment_frames

    def _prev_offset_segments(self, rng) -> int:
        if rng is None:
            return 1
        return int(rng.integers(1, self.prev_augment_frames + 1))
