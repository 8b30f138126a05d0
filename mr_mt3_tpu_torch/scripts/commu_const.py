"""ComMU instrument-name -> MIDI program mapping (a copy of
mr_mt3_tpu/scripts/commu_const.py).

The ComMU dataset names instruments by soundbank preset; rendering and
splitting need the corresponding General-MIDI program numbers. Presets are
1-indexed in the soundbank, so one is subtracted to get 0-indexed MIDI
programs (values verified against reference scripts/commu/const.py).
Some presets have no exact GM match: wobble bass falls back to synth bass,
synth bell to bell, synth pluck to calliope lead, horn means french horn.
"""

# name: 1-indexed soundbank preset
_SOUNDBANK_PRESETS = (
    ('accordion', 22), ('acoustic_bass', 33), ('acoustic_guitar', 25),
    ('acoustic_piano', 1), ('bassoon', 71), ('bell', 15),
    ('brass_ensemble', 62), ('celesta', 9), ('choir', 53),
    ('clarinet', 72), ('electric_bass', 34), ('electric_guitar_clean', 28),
    ('electric_guitar_distortion', 31), ('electric_piano', 5),
    ('flute', 74), ('glockenspiel', 10), ('harp', 47), ('horn', 61),
    ('marimba', 13), ('nylon_guitar', 25), ('oboe', 69), ('orgel', 17),
    ('string_cello', 43), ('string_double_bass', 44),
    ('string_ensemble', 49), ('string_viola', 42), ('string_violin', 41),
    ('synth_bass', 39), ('synth_bass_wobble', 39), ('synth_bell', 15),
    ('synth_pad', 89), ('synth_pluck', 83), ('synth_voice', 86),
    ('timpani', 48), ('trombone', 58), ('tuba', 59), ('vibraphone', 12),
    ('xylophone', 14),
)


def get_inst_dict():
    """name -> 0-indexed MIDI program."""
    return {name: preset - 1 for name, preset in _SOUNDBANK_PRESETS}
