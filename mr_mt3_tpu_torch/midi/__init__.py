"""Standard MIDI File I/O (copies of mr_mt3_tpu.midi): the reader, the
writer and sustain-pedal note extension."""

from mr_mt3_tpu_torch.midi.reader import (
    MidiFile,
    MidiInstrument,
    MidiNote,
    midi_file_to_note_sequence,
    read_midi,
)
from mr_mt3_tpu_torch.midi.sustain import apply_sustain_control_changes
from mr_mt3_tpu_torch.midi.writer import (
    note_sequence_to_midi_bytes,
    note_sequence_to_midi_file,
)
