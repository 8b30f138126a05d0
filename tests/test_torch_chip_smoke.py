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


# ---- the int8 tiers' phases ---------------------------------------------


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_int8_attention_bounds_catch_the_control(dtype):
    """The attention's plain version passes INT8_BOUNDS against itself,
    and the control (p not requantized) breaks the heads_apart bound."""
    from mr_mt3_tpu_torch.ops import int8_attention as i8a
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((8, 6, 64), generator=gen).to(getattr(torch, dtype))
    (kq, ks), (vq, vs) = (i8a.quantize_kv_rows(
        torch.randn((8, 6, 64, 256), generator=gen)) for _ in range(2))
    args = (q, kq, ks, vq, vs, 200)
    want = i8a.int8_decode_attention_reference(*args)
    same = chip_smoke.output_readings(torch, want, want, 64)
    assert chip_smoke.int8_violations('int8_decode_attention', dtype,
                                      same) == []
    ctrl = chip_smoke.output_readings(
        torch, want, chip_smoke.int8_attention_control(torch, *args), 64)
    print(dtype, ctrl)
    caught = chip_smoke.int8_violations('int8_decode_attention', dtype, ctrl)
    assert any(v.startswith('heads_apart') for v in caught)


@pytest.mark.parametrize('tier', ['int8', 'int8_kv'])
def test_steps_needed_equals_the_steps_run(tier):
    """chip_smoke's count of the greedy steps the decoded tokens needed
    (early exit every _EXIT_CHECK_EVERY steps) equals the steps the loop
    ran, on the parity model (rows that reach EOS) decoded in batches of
    3 rows."""
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from tests.parity_common import VANILLA_CFG, load_golden, parity_corpus
    from mr_mt3_tpu_torch.utils.checkpoint_import import (
        state_dict_from_jax_params,
    )
    params, _ = load_golden('parity_vanilla.npz')
    cfg = MT3Config(**{f: getattr(VANILLA_CFG, f)
                       for f in MT3Config.__dataclass_fields__})
    model = MT3(cfg).eval()
    model.load_state_dict(state_dict_from_jax_params(params, cfg))
    handler = InferenceHandler(model=model, max_length=300, batch_size=3,
                               quantize=tier, device='cpu')
    log, steps = chip_smoke.DecodeLog(), chip_smoke.StepLog()
    try:
        handler.transcribe(parity_corpus()[0][0])
    finally:
        steps.close()
        log.close()
    assert len(log.calls) == 1 and set(steps.steps) == {tier}
    assert steps.steps[tier] == chip_smoke.steps_needed(log, tier) < 2 * 300


def test_device_per_step_leaves_out_the_shared_setup(monkeypatch):
    """The per-step device time is the difference of the two profiled
    decodes over their extra steps: a set-up both share (the encoder)
    drops out, and so does the int8 kernels' share of it."""
    def device_time(torch, fn):
        n = fn()
        return 5.0 + 0.5 * n, {'int8_gated_ff': 1.0 + 0.25 * n}

    monkeypatch.setattr(chip_smoke, 'device_time', device_time)
    got = chip_smoke.device_per_step(torch, lambda n: n, 2.0)
    assert got['device_ms_per_step'] == pytest.approx(0.5)
    assert got['idle_share'] == pytest.approx(0.75)
    assert got['kernel_ms_per_step'] == {'int8_gated_ff': 0.25}
