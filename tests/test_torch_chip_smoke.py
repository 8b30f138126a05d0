"""chip_smoke.py's comparison of the window kernel with its plain version,
run on the CPU where the plain version stands in for the kernel: the
plain version passes its own bounds, and the f32-attention control
(a plain version without the int8 requantization of q and the
probabilities) breaks them, as chip_smoke requires on the card.

Small shapes (d_model 64, 2 layers, B=8, a window of 8 at pos0 64); the
readings are printed (-s). At the end, the Slakh and FLAC helpers of
its native phase, serving and training main paths."""

import os

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


# ---- the step and grouped kernels' phases ---------------------------------


def _step_args(tier, batch=8, pos=700):
    """One step's arguments at full cache length 1024 filled from a seed
    (chunk 256: three live chunks at position 700)."""
    model = init_params(MT3(CFG), seed=0).eval()
    dp = stack_decode_params(model, quantize=tier)
    gen = torch.Generator().manual_seed(5)
    enc = torch.randn((batch, 16, CFG.d_model), generator=gen) * 0.5
    cross = fd.precompute_cross_kv_fused(dp, CFG, enc)
    cache = chip_smoke.seeded_cache(torch, fd, CFG, batch, tier, gen)
    tokens = torch.randint(3, CFG.vocab_size, (batch,), generator=gen)
    x = dp.token_embed[tokens].float() + dp.pos_table[pos].float()
    return (CFG, dp.fused, x, pos, cache, cross, fd.cache_chunk(cache, cross))


@pytest.mark.parametrize('tier', ['fused_bf16', 'fused', 'fused_int4'])
def test_step_plain_version_passes_its_own_bounds(tier):
    args = _step_args(tier)
    assert args[-1] == 256
    want = fd.fused_decode_step_reference(*args)
    readings = chip_smoke.compare_step(torch, tier, want, want)
    assert chip_smoke.step_violations(tier, readings) == []
    assert readings['max_abs_err'] == 0.0


@pytest.mark.parametrize('tier', ['fused', 'fused_int4'])
def test_step_bounds_catch_the_one_chunk_control(tier):
    """The plain step with one chunk in place of the function's three
    breaks the layer-1 code bound (read here: 34% int8, 2.7% int4)."""
    args = _step_args(tier)
    want = fd.fused_decode_step_reference(*args)
    ctrl = fd.fused_decode_step_reference(*args[:-1], 1024)
    readings = chip_smoke.compare_step(torch, tier, want, ctrl)
    print(tier, readings)
    caught = chip_smoke.step_violations(tier, readings)
    assert any(v.startswith('layer1_codes_unequal') for v in caught)


@pytest.mark.parametrize('tier', ['fused_bf16', 'fused_int4'])
def test_step_loop_drives_the_wrapper_as_the_plain_loop(tier):
    """step_loop through fused_decode_step (here its plain version) and
    through the plain version directly give the same tokens; on the CPU
    no kernel launch is counted."""
    model = init_params(MT3(CFG), seed=0).eval()
    dp = stack_decode_params(model, quantize=tier)
    enc = torch.randn((3, 16, CFG.d_model),
                      generator=torch.Generator().manual_seed(2))
    cross = fd.precompute_cross_kv_fused(dp, CFG, enc)
    before = dict(fd.STEP_LAUNCHES)
    toks, _ = chip_smoke.step_loop(torch, fd, CFG, dp, cross, 3, 12)
    plain, logits = chip_smoke.step_loop(torch, fd, CFG, dp, cross, 3, 12,
                                         plain=True)
    assert toks.shape == (3, 12) and len(logits) == 12
    assert torch.equal(toks, plain)
    assert fd.STEP_LAUNCHES == before


def test_grouped_rows_map_to_the_window_layout():
    """grouped_as_window puts the grouped plain version's emitted codes
    where the window's plain version puts them (same tokens, one chunk)."""
    from mr_mt3_tpu_torch.ops import group_axis_kernel as gk
    model = init_params(MT3(CFG), seed=0).eval()
    dp = stack_decode_params(model, quantize='fused')
    enc = torch.randn((16, 16, CFG.d_model),
                      generator=torch.Generator().manual_seed(3))
    cross = fd.precompute_cross_kv_fused(dp, CFG, enc)
    tokens = torch.arange(3, 19, dtype=torch.int32)
    fin = torch.zeros(16, dtype=torch.bool)
    pos_rows = fd.window_pos_rows(dp, 0, 4)
    want = fd.fused_decode_window_reference(
        CFG, dp.fused, pos_rows, tokens, fin, 0,
        fd.init_fused_cache(CFG, 16, 16, 'cpu', 'fused'), cross, 4)
    got = gk.fused_decode_window_grouped_reference(
        CFG, dp.fused, pos_rows, tokens, fin, 0,
        gk.init_fused_cache_grouped(CFG, 2, 16, 'cpu'),
        gk.regroup_cross_kv(cross, 2), 4, 16)
    rows = chip_smoke.grouped_as_window(got[2], 2, 2, CFG.num_heads)
    assert torch.equal(got[0], want[0])
    for key in ('kq', 'vq'):
        assert torch.equal(rows[key], want[2][key])
    for key in ('ks', 'vs'):
        assert torch.equal(rows[key], want[2][key].to(torch.bfloat16).float())


def test_grouped_decode_on_the_cpu():
    """grouped_decode's two routes at B 16 run their plain versions on the
    CPU, chained over two windows, and count no launch."""
    from mr_mt3_tpu_torch.ops import group_axis_kernel as gk
    model = init_params(MT3(CFG), seed=0).eval()
    dp = stack_decode_params(model, quantize='fused')
    enc = torch.randn((16, 16, CFG.d_model),
                      generator=torch.Generator().manual_seed(4))
    cross = fd.precompute_cross_kv_fused(dp, CFG, enc)
    before = dict(gk.LAUNCHES), dict(fd.LAUNCHES)
    got = chip_smoke.grouped_decode(torch, CFG, dp,
                                    gk.regroup_cross_kv(cross, 2), 16, 64,
                                    True)
    want = chip_smoke.grouped_decode(torch, CFG, dp, cross, 16, 64, False)
    assert got.shape == want.shape == (16, 64)
    assert (got[:, :32] == want[:, :32]).float().mean() > 0.9
    assert (dict(gk.LAUNCHES), dict(fd.LAUNCHES)) == before


def test_first_eos_cut():
    t = torch.tensor([[5, 1, 7, 0], [4, 6, 8, 9]])
    assert chip_smoke.first_eos_cut(torch, t, 1) == [[5, 1], [4, 6, 8, 9]]


def test_malformed_flac_streams_are_refused(monkeypatch, tmp_path):
    """Every stream chip_smoke's native phase requires to be refused raises
    ValueError in the port's decoder and in the JAX package's."""
    from test_torch_native_flac import jax_codec

    from mr_mt3_tpu_torch.native import flac
    decoders = [flac.decode_flac_bytes,
                jax_codec(monkeypatch, tmp_path).decode_flac_bytes]
    streams = chip_smoke.malformed_flac_streams()
    assert len(streams) == 15
    for name, data in streams:
        for decode in decoders:
            with pytest.raises(ValueError):
                decode(data)


def test_slakh_corpus_is_prepared_and_tokenized(tmp_path):
    """The training main path's corpus at a small size: Slakh's published
    layout, prepared by the port's scripts, its songs' native tokens equal
    to the Python path's."""
    splits = [str(tmp_path / 'train'), str(tmp_path / 'validation')]
    chip_smoke.slakh_corpus(splits[0], 2, 4.0, [True, False], seed=1)
    chip_smoke.slakh_corpus(splits[1], 1, 4.0, [True], seed=2)
    assert sorted(os.listdir(os.path.join(splits[0], 'Track01000'))) == [
        'MIDI', 'metadata.yaml', 'mix.flac']
    seconds = chip_smoke.prepare_slakh(str(tmp_path), splits)
    assert set(seconds) == {'generate_inst_names', 'merge_slakh_midi',
                            'resample_slakh'}
    tokens = chip_smoke.tokenizer_check(splits)
    assert tokens['songs'] == 3 and min(tokens['note_events']) > 0


def test_leakage_counts_the_ground_truth(tmp_path):
    songs, out = str(tmp_path / 'songs'), str(tmp_path / 'out')
    files = chip_smoke.eval_set(songs, *chip_smoke.tone_songs((2.0, 3.0),
                                                              seed=3))
    for i, f in enumerate(files):
        d = os.path.join(out, os.path.basename(os.path.dirname(f)))
        os.makedirs(d)
        chip_smoke.write_song(os.path.join(d, 'mix.mid'), [(0.1, 0.5, 60)],
                              program=33 * i)
    got = chip_smoke.leakage(out, songs)
    assert got['ground_truth_programs'] == {'Track00000': 1, 'Track00001': 1}
    assert got['presence']['precision'] == 0.5



# multi_card's rank legs at a tiny width on the CPU: training_configs and
# training_model swapped for these, the CPU for the card
MULTI_TINY = ['model.config.d_model=32', 'model.config.d_kv=8',
              'model.config.d_ff=48', 'model.config.num_heads=4',
              'model.config.num_layers=1', 'model.config.num_decoder_layers=1',
              'model.config.dropout_rate=0.0']


def tiny_training_configs():
    from mr_mt3_tpu_torch.utils.config import load_config

    def load(extra):
        return load_config(os.path.join(chip_smoke.REPO, 'configs'),
                           'config_slakh_segmem', extra + MULTI_TINY)
    return load(chip_smoke.TRAIN_ARGS[1:]), load(chip_smoke.TRAIN_ARGS[1:4])


def tiny_training_model(torch, config, kernel, seed):
    from mr_mt3_tpu_torch.utils import builders
    model = MT3(builders.build_model(config).cfg.replace(
        attention_kernel=kernel))
    return builders.init_params(model, seed=seed)


MULTI_PRELUDE = """
import sys, torch
sys.path.insert(0, {repo!r})
import chip_smoke
from tests.test_torch_chip_smoke import (tiny_training_configs,
                                         tiny_training_model)
chip_smoke.MULTI_DIR = {out!r}
chip_smoke.training_configs = tiny_training_configs
chip_smoke.training_model = tiny_training_model
torch.set_num_threads(1)
"""


def test_multi_card_rank_legs_on_the_cpu(tmp_path, monkeypatch):
    """multi_card_rank's three children (a one-rank group, two ranks) on
    gloo on the CPU: the one-rank DDP steps equal the plain ones bit for
    bit, the two ranks agree, fp32_readings holds its bounds, and the two
    ranks' scores equal one process's."""
    import json
    import subprocess
    import sys
    import types
    out = str(tmp_path)
    chip_smoke.eval_set(os.path.join(out, 'parity'),
                        *chip_smoke.parity_corpus(), subtype='FLOAT')
    prelude = MULTI_PRELUDE.format(repo=chip_smoke.REPO, out=out)
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, '-c', prelude + (
            f'chip_smoke.multi_card_rank({leg!r}, {r}, {w}, '
            f'{os.path.join(out, leg + ".store")!r}, backend="gloo", '
            f'kind="cpu")')],
        cwd=chip_smoke.REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for leg, r, w in (('nccl', 0, 1), ('gloo', 0, 2), ('gloo', 1, 2))]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    nccl = json.load(open(os.path.join(out, 'nccl_rank0.json')))
    gloo = [json.load(open(os.path.join(out, f'gloo_rank{r}.json')))
            for r in range(2)]
    assert nccl['fp32']['metrics_equal'] and not nccl['fp32'][
        'params_unequal']
    assert gloo[0]['bf16'] == gloo[1]['bf16']
    assert gloo[0]['fp32'] == gloo[1]['fp32']
    assert gloo[0]['eval']['scores'] == gloo[1]['eval']['scores'] == \
        nccl['eval']['scores']
    monkeypatch.setattr(chip_smoke, 'MULTI_DIR', out)
    monkeypatch.setattr(chip_smoke, 'training_configs', tiny_training_configs)
    monkeypatch.setattr(chip_smoke, 'training_model', tiny_training_model)
    on_cpu = types.SimpleNamespace(
        load=lambda path, map_location=None: torch.load(path))
    read = chip_smoke.fp32_readings(on_cpu, gloo[0]['fp32']['ddp'],
                                    nccl['fp32']['plain'])
    assert read['params_apart_share'] == 0.0
