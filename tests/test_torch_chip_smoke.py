"""chip_smoke.py's comparison of the window kernel with its plain version,
run on the CPU where the plain version stands in for the kernel: the
plain version passes its own bounds, and the f32-attention control
(a plain version without the int8 requantization of q and the
probabilities) breaks them, as chip_smoke requires on the card.

Small shapes (d_model 64, 2 layers, B=8, a window of 8 at pos0 64); the
readings are printed (-s)."""

import pytest
import torch

import chip_smoke
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.ops import fused_decode as fd
from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params
from mr_mt3_tpu_torch.utils.builders import init_params

CFG = MT3Config(vocab_size=256, d_model=64, d_kv=16, d_ff=96, num_heads=4,
                num_encoder_layers=1, num_decoder_layers=2, mel_bins=16)


def _window_args(tier, batch=8, pos0=64, t_window=8):
    """One window's arguments at pos0, the cache rows before it decoded
    by the plain version itself, the last row finished."""
    model = init_params(MT3(CFG), seed=0).eval()
    dp = stack_decode_params(model, quantize=tier)
    gen = torch.Generator().manual_seed(1)
    enc = torch.randn((batch, 16, CFG.d_model), generator=gen) * 0.5
    cross = fd.precompute_cross_kv_fused(dp, CFG, enc)
    cache = fd.init_fused_cache(CFG, batch, 128, 'cpu', tier)
    tokens = torch.randint(3, CFG.vocab_size, (batch,), generator=gen,
                           dtype=torch.int32)
    finished = torch.zeros(batch, dtype=torch.bool)
    for p in range(0, pos0, t_window):
        toks, finished, cache = fd.fused_decode_window(
            CFG, dp.fused, dp, tokens, finished, p, cache, cross, t_window)
        tokens = toks[:, -1].contiguous()
    finished = finished.clone()
    finished[-1] = True
    return (CFG, dp.fused, fd.window_pos_rows(dp, pos0, t_window), tokens,
            finished, pos0, cache, cross, t_window)


@pytest.mark.parametrize('tier', ['fused_bf16', 'fused', 'fused_int4'])
def test_plain_version_passes_its_own_bounds(tier):
    args = _window_args(tier)
    toks, fin, rows, logits = fd.fused_decode_window_reference(
        *args, return_logits=True)
    readings = chip_smoke.compare_window(
        torch, CFG, tier, (toks, fin, rows), (toks, fin, rows), logits,
        logits[-1])
    print(tier, readings)
    assert chip_smoke.violations(tier, readings) == []
    assert readings['rows_diverged'] == 0
    assert readings['unfinished_rows_agreeing'] == 7


@pytest.mark.parametrize('tier', ['fused', 'fused_int4'])
def test_bounds_catch_the_control(tier):
    """The right plain version (standing in for the kernel) against the
    control: the first-layer code reading breaks its bound, and the
    module's attention functions are restored afterwards."""
    args = _window_args(tier)
    want = fd.fused_decode_window_reference(*args, return_logits=True)
    ctrl = chip_smoke.float_attention_control(torch, fd, args)
    assert fd._int_scores.__name__ == '_int_scores'
    assert fd._int_values.__name__ == '_int_values'
    readings = chip_smoke.compare_window(
        torch, CFG, tier, want[:3], ctrl[:3], ctrl[3], want[3][-1])
    print(tier, readings)
    caught = chip_smoke.violations(tier, readings)
    assert any(v.startswith('first_layer_codes_unequal') for v in caught)


def test_every_unfinished_row_diverging_fails():
    """A case whose unfinished rows all diverge compares no logits of an
    unfinished row, so it fails whatever its other readings."""
    readings = {'kv_rel_err': 0.0, 'logit_rel_err': 0.0,
                'max_gap_rel': 0.0, 'unfinished_rows_agreeing': 0,
                'finished_flags_differ': 0}
    assert chip_smoke.violations('fused_bf16', readings) == [
        'every unfinished row diverged, so no logits were compared']
