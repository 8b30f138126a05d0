"""Standard MIDI File writer (dependency-free).

NoteSequence -> SMF format 1, following note_seq.sequence_proto_to_midi_file
via pretty_midi: resolution = sequence.ticks_per_quarter (220), fixed 120 qpm
tempo, one track per (instrument, program, is_drum) note group, drums on
channel 9, non-drum channels cycling 0-15 skipping 9, times rounded to the
nearest tick (reference usage: inference.py:201).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

from mr_mt3_tpu_torch.codec.note_sequences import NoteSequence

_DEFAULT_QPM = 120.0


def _varlen(value: int) -> bytes:
    if value < 0:
        raise ValueError('negative varlen')
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def _track_chunk(events: List[Tuple[int, bytes]]) -> bytes:
    """events: (absolute_tick, message bytes), already sorted."""
    body = bytearray()
    prev_tick = 0
    for tick, msg in events:
        body += _varlen(tick - prev_tick)
        body += msg
        prev_tick = tick
    body += _varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track
    return b'MTrk' + len(body).to_bytes(4, 'big') + bytes(body)


def note_sequence_to_midi_bytes(ns: NoteSequence,
                                qpm: float = _DEFAULT_QPM) -> bytes:
    tpq = ns.ticks_per_quarter or 220
    ticks_per_second = tpq * qpm / 60.0

    def to_tick(time: float) -> int:
        return max(0, int(round(time * ticks_per_second)))

    # Group notes the way note_seq does when building pretty_midi instruments.
    groups: Dict[Tuple[int, int, bool], list] = collections.OrderedDict()
    for note in ns.notes:
        key = (note.instrument, note.program, note.is_drum)
        groups.setdefault(key, []).append(note)
    for cc in ns.control_changes:
        key = (cc.instrument, cc.program, cc.is_drum)
        groups.setdefault(key, [])
    for pb in ns.pitch_bends:
        key = (pb.instrument, pb.program, pb.is_drum)
        groups.setdefault(key, [])

    # Conductor track: tempo (+ implicit 4/4).
    tempo_us = int(round(6e7 / qpm))
    conductor = [
        (0, bytes([0xFF, 0x51, 0x03]) + tempo_us.to_bytes(3, 'big')),
        (0, bytes([0xFF, 0x58, 0x04, 4, 2, 24, 8])),
    ]
    chunks = [_track_chunk(conductor)]

    # Channel assignment: drums -> 9, others cycle through the rest.
    nondrum_channels = [c for c in range(16) if c != 9]
    next_channel = 0

    cc_by_group: Dict[Tuple[int, int, bool], list] = collections.defaultdict(list)
    for cc in ns.control_changes:
        cc_by_group[(cc.instrument, cc.program, cc.is_drum)].append(cc)
    pb_by_group: Dict[Tuple[int, int, bool], list] = collections.defaultdict(list)
    for pb in ns.pitch_bends:
        pb_by_group[(pb.instrument, pb.program, pb.is_drum)].append(pb)

    for key, notes in groups.items():
        _, program, is_drum = key
        if is_drum:
            channel = 9
        else:
            channel = nondrum_channels[next_channel % len(nondrum_channels)]
            next_channel += 1
        events: List[Tuple[int, int, bytes]] = []  # (tick, order, msg)
        events.append((0, 0,
                       bytes([0xC0 | channel, int(program) & 0x7F])))
        for cc in cc_by_group.get(key, []):
            events.append((to_tick(cc.time), 1,
                           bytes([0xB0 | channel,
                                  int(cc.control_number) & 0x7F,
                                  int(cc.control_value) & 0x7F])))
        for pb in pb_by_group.get(key, []):
            # bend is -8192..8191; the wire value is the 14-bit unsigned
            # offset (note_seq writes these through pretty_midi the same
            # way — a read-write round trip must not drop them)
            raw = max(0, min(0x3FFF, int(pb.bend) + 8192))
            events.append((to_tick(pb.time), 1,
                           bytes([0xE0 | channel, raw & 0x7F,
                                  (raw >> 7) & 0x7F])))
        for note in notes:
            pitch = int(note.pitch) & 0x7F
            vel = max(1, min(127, int(note.velocity)))
            # note-offs sort before note-ons at the same tick so back-to-back
            # repeats of a pitch survive the read-back pairing
            events.append((to_tick(note.end_time), 2,
                           bytes([0x80 | channel, pitch, 0])))
            events.append((to_tick(note.start_time), 3,
                           bytes([0x90 | channel, pitch, vel])))
        events.sort(key=lambda e: (e[0], e[1]))
        chunks.append(_track_chunk([(t, m) for t, _, m in events]))

    header = (b'MThd' + (6).to_bytes(4, 'big') + (1).to_bytes(2, 'big') +
              len(chunks).to_bytes(2, 'big') + int(tpq).to_bytes(2, 'big'))
    return header + b''.join(chunks)


def note_sequence_to_midi_file(ns: NoteSequence, path,
                               qpm: float = _DEFAULT_QPM) -> None:
    data = note_sequence_to_midi_bytes(ns, qpm=qpm)
    with open(path, 'wb') as f:
        f.write(data)
