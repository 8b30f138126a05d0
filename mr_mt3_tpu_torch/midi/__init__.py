"""Standard MIDI File writer (copy of mr_mt3_tpu.midi.writer)."""

from mr_mt3_tpu_torch.midi.writer import (
    note_sequence_to_midi_bytes,
    note_sequence_to_midi_file,
)
