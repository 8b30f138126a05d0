"""A tiny-size stand-in of each configuration and traffic mix, for the
CPU tests: the same program path (the configuration loader, the handler at
the fused_int4 tier, whose window kernel runs as its plain version on the
CPU), one decoder and encoder layer, 64 decode steps, a few short clips."""

TINY_SIZES = {'d_model': 32, 'd_kv': 8, 'd_ff': 32, 'num_heads': 2,
              'num_layers': 1, 'num_decoder_layers': 1, 'max_length': 64}

TINY_OVERRIDES = ['model.config.d_model=32', 'model.config.d_kv=8',
                  'model.config.d_ff=32', 'model.config.num_heads=2',
                  'model.config.num_layers=1',
                  'model.config.num_decoder_layers=1']


def config_patch(config: dict, limit: float = 1e-3) -> dict:
    """Patch for core.run: the tiny sizes; the limit of the comparison as
    given (the plain version and the reference agree to rounding on the
    CPU)."""
    return {'program_overrides': list(config['program_overrides'])
            + TINY_OVERRIDES
            + ['eval.max_length=64'],
            'sizes': {**config['sizes'], **TINY_SIZES},
            'limits': {'max_logit_gap': limit}}


def mix_patch(mix: dict) -> dict:
    """A few short clips; pools of a few songs of a few segments."""
    patch = {'seconds_range': [1.0, 5.0], 'judge_segments': 4,
             'judge_segments_per_song': 3, 'judge_min_steps': 64}
    if mix['kind'] == 'open_http':
        patch['rate_per_s'] = 3.0
    else:
        patch['pool'] = max(int(mix['songs_per_call']), 4)
        if int(mix['batch_size']) > 8:
            patch['batch_size'] = 4
    return patch
