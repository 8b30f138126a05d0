"""The step-by-step decode loops as the JAX package runs them on the
device (device='cpu' here): the position a 0-d int32 tensor, the steps in
the JAX loop's phases, the state in a DecodeRunner's static buffers.

  * decode_step_fast with a device position against JAX's
    decode_step_fast / _decode_step_int8_kv, step by step for 72 steps
    across the first 64-position phase (the JAX cache grown from 64 to
    72 positions between the phases), per tier and dtype;
  * int8_decode_attention_reference with a 0-d tensor position equal to
    the int form, garbage codes past it;
  * one runner decoding A, then B, then A: nothing of B reaches A;
  * _greedy_loop (the module path) with a device position against JAX's
    model-apply loop on the v1 parity golden.

On the card the same blocks are captured as CUDA graphs; the GPU tests
(tests/test_torch_fused_decode_gpu.py) hold the graphed loop against the
eager one. Run with -s to see the readings behind each tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mr_mt3_tpu.models import MT3 as JaxMT3
from mr_mt3_tpu.ops import decode as jax_decode
from mr_mt3_tpu.ops import fast_decode as jax_fast
from mr_mt3_tpu_torch.ops import decode
from mr_mt3_tpu_torch.ops import fast_decode
from mr_mt3_tpu_torch.ops import int8_attention as i8a
from tests.parity_common import V1_CFG, load_golden
from tests.test_fused_decode import SMALL_CFG
from tests.test_torch_int8_decode import (  # noqa: F401 (small: fixture)
    MAX_GAP_STEPS,
    _port_model,
    small,
)
from tests.test_torch_segmem import port_model
from tests.torch_threads import two_torch_threads  # noqa: F401

STEPS = 72               # past the JAX loop's first 64-position phase
# fp32: each step's largest logit difference over its largest |logit|
# (both sum in f32 in other orders) within F32_LOGIT_RTOL: read at most
# 1.4e-6 on SMALL_CFG seed 1 in 'none' and 'int8_kv'. 'int8' rounds its
# feed-forward's intermediate to bf16 in every layer, where an f32 value
# within an ulp of a rounding midpoint lands a bf16 step apart
# (tests/test_torch_int8_decode.py's F32_RTOL['gated_ff']): read 3.9e-4,
# at 11 of the 72 steps. 'int8_kv' requantizes q and the probabilities to
# int8 codes: at a step where a value lands on the other side of a code's
# rounding midpoint the logits move by up to a code's worth, at most
# F32_TIE_STEPS of the steps, each within F32_TIE_RTOL (read 2.4e-3 at one
# step)
F32_LOGIT_RTOL = {'none': 1e-5, 'int8': 2e-3, 'int8_kv': 1e-5}
F32_TIE_STEPS = {'none': 0, 'int8': 0, 'int8_kv': 3}
F32_TIE_RTOL = 1e-2
CASES = [('none', 'float32'), ('none', 'bfloat16'), ('int8', 'float32'),
         ('int8', 'bfloat16'), ('int8_kv', 'float32'),
         ('int8_kv', 'bfloat16')]


def _jax_steps(params, jcfg, enc, quantize):
    """JAX's greedy decode step by step: (tokens (B, STEPS + 1), logits
    (STEPS, B, vocab)), its cache grown as its loop grows it: 64
    positions, then padded to 72."""
    dp = jax_fast.stack_decode_params(
        params, jcfg, quantize='int8' if quantize == 'int8' else 'none')
    cross = jax_fast.precompute_cross_kv_stacked(dp, jcfg, enc)
    batch = enc.shape[0]
    bounds = fast_decode.phase_bounds(STEPS)
    if quantize == 'int8_kv':
        cross = jax_fast.quantize_cross_kv(cross)
        cache = jax_fast.init_int8_cache_stacked(jcfg, batch, bounds[0])
    else:
        cache = jax_fast.init_cache_stacked(jcfg, batch, bounds[0])
    step = jax.jit(lambda dp, tok, pos, cache, cross:
                   jax_fast.decode_step_fast(jcfg, dp, tok, pos, cache,
                                             cross, quantize=quantize))
    tokens = np.full((batch, STEPS + 1), jcfg.pad_token_id, np.int32)
    tokens[:, 0] = jcfg.decoder_start_token_id
    finished = np.zeros(batch, bool)
    out = []
    for i in range(STEPS):
        if i == bounds[0]:
            cache = jax.tree.map(
                lambda a: jnp.pad(a, [(0, 0)] * 4 + [(0, STEPS - i)]), cache)
        logits, cache = step(dp, jnp.asarray(tokens[:, i]), jnp.int32(i),
                             cache, cross)
        out.append(np.asarray(logits, np.float32))
        nxt = np.where(finished, jcfg.pad_token_id, out[-1].argmax(-1))
        finished |= nxt == jcfg.eos_token_id
        tokens[:, i + 1] = nxt
    return tokens, np.stack(out)


def _port_steps(model, enc, tokens, quantize):
    """The port's logits of the same steps: decode_step_fast with the
    position a 0-d int32 tensor and the phase bound, on caches of 72."""
    cfg = model.cfg
    dp = fast_decode.stack_decode_params(model, quantize=quantize)
    cross = fast_decode.precompute_cross_kv_stacked(dp, cfg, enc)
    batch = enc.shape[0]
    if quantize == 'int8_kv':
        cross = fast_decode.quantize_cross_kv(cross)
        cache = fast_decode.init_int8_cache_stacked(cfg, batch, STEPS, 'cpu')
    else:
        cache = fast_decode.init_cache_stacked(cfg, batch, STEPS, 'cpu')
    bounds = fast_decode.phase_bounds(STEPS)
    out = []
    for i in range(STEPS):
        bound = next(b for b in bounds if i < b)
        position = torch.tensor(i, dtype=torch.int32)
        logits = fast_decode.decode_step_fast(
            cfg, dp, torch.from_numpy(tokens[:, i]), position, cache, cross,
            quantize=quantize, bound=bound)
        out.append(logits.float().numpy())
    return np.stack(out)


@pytest.mark.parametrize('quantize,dtype', CASES)
def test_device_position_step_equals_jax(small, quantize, dtype):
    """JAX's greedy decode step by step, the port's steps teacher-forced
    on JAX's tokens: fp32 logits within F32_LOGIT_RTOL (but at int8_kv's
    rounding ties) and every argmax equal; bf16 argmaxes equal but
    where JAX scores the two tokens within MAX_GAP_STEPS bf16 steps."""
    params, mel = small
    jcfg = SMALL_CFG.replace(dtype=dtype)
    enc = JaxMT3(jcfg).apply({'params': params}, jnp.asarray(mel),
                             method=JaxMT3.encode_audio)
    tokens, want = _jax_steps(params, jcfg, enc, quantize)
    got = _port_steps(_port_model(params, jcfg),
                      torch.from_numpy(np.array(enc, np.float32)).to(
                          getattr(torch, dtype)), tokens, quantize)
    rel = np.abs(got - want).max(-1) / np.abs(want).max(-1)
    parted = np.argwhere(got.argmax(-1) != want.argmax(-1))
    print(f'{quantize} {dtype}: largest logit rel {rel.max():.3g}, '
          f'{len(parted)} of {want.shape[0] * want.shape[1]} argmaxes '
          f'apart')
    if dtype == 'float32':
        ties = np.flatnonzero(rel.max(-1) > F32_LOGIT_RTOL[quantize])
        print(f'  steps past {F32_LOGIT_RTOL[quantize]}: {ties.tolist()}')
        assert len(ties) <= F32_TIE_STEPS[quantize]
        assert rel.max() <= F32_TIE_RTOL
        assert len(parted) == 0
        return
    for i, b in parted:
        row = want[i, b]
        top = float(row.max())
        step = 2.0 ** (np.floor(np.log2(abs(top))) - 7)   # bf16 spacing
        gap = (top - float(row[got[i, b].argmax()])) / step
        print(f'  step {i} row {b}: JAX margin {gap:g} bf16 steps')
        assert 0 <= gap <= MAX_GAP_STEPS, (i, b, gap)


@pytest.mark.parametrize('position', [0, 17, 63])
def test_attention_tensor_position_equals_the_int(position):
    """The plain version with a 0-d int32 tensor position (and the phase
    bound) gives the int form's output, bit for bit, with random codes and
    scales in every position past it; a position at or past n_max
    raises."""
    rng = np.random.default_rng(position)
    q = torch.from_numpy(rng.normal(size=(3, 4, 8)).astype(np.float32))
    (kq, ks), (vq, vs) = (i8a.quantize_kv_rows(torch.from_numpy(
        rng.normal(size=(3, 4, 8, 64)).astype(np.float32))) for _ in range(2))
    want = i8a.int8_decode_attention(q, kq, ks, vq, vs, position)
    for t in (kq, vq):
        t[..., position + 1:] = torch.from_numpy(rng.integers(
            -127, 128, size=t[..., position + 1:].shape).astype(np.int8))
    for t in (ks, vs):
        t[..., position + 1:] = torch.from_numpy(rng.uniform(
            0, 10, size=t[..., position + 1:].shape).astype(np.float32))
    pos = torch.tensor(position, dtype=torch.int32)
    got = i8a.int8_decode_attention(q, kq, ks, vq, vs, pos, 64)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match='outside'):
        i8a.int8_decode_attention(q, kq, ks, vq, vs, pos, position)


@pytest.mark.parametrize('quantize', ['none', 'int8_kv'])
def test_runner_state_does_not_leak(small, quantize):
    """One runner (dp.runners, as on the card) decodes A, then B, then A:
    A's tokens are the same both times and equal a fresh runner's, and
    the second A reused the runner."""
    params, mel = small
    model = _port_model(params, SMALL_CFG)
    dp = fast_decode.stack_decode_params(model, quantize=quantize)
    assert dp.runners is None          # the CPU keeps none by default
    dp = dp._replace(runners={})
    mel_t = torch.from_numpy(mel)
    a, b = model.encode_audio(mel_t), model.encode_audio(mel_t.flip(0))
    first = fast_decode.greedy_loop_fast(model.cfg, dp, a, 40, quantize)
    runner = next(iter(dp.runners.values()))
    other = fast_decode.greedy_loop_fast(model.cfg, dp, b, 40, quantize,
                                         valid_mask=torch.tensor(
                                             [True, False, True]))
    again = fast_decode.greedy_loop_fast(model.cfg, dp, a, 40, quantize)
    fresh = fast_decode.greedy_loop_fast(
        model.cfg, dp._replace(runners=None), a, 40, quantize)
    assert list(dp.runners.values()) == [runner]
    assert not torch.equal(first, other)
    assert (other[1, 1:] == model.cfg.pad_token_id).all()
    torch.testing.assert_close(again, first, rtol=0, atol=0)
    torch.testing.assert_close(fresh, first, rtol=0, atol=0)


def test_phased_blocks_cover_the_positions():
    """run_phased_decode's blocks: 8 steps, none crossing a phase bound,
    the last one cut short at max_length; the early exit read before each
    block."""
    blocks = []
    ran = fast_decode.run_phased_decode(
        fast_decode.phase_bounds(150), lambda b, n: blocks.append((b, n)),
        lambda: False)
    assert ran == 150 and sum(n for _, n in blocks) == 150
    assert blocks[7] == (64, 8) and blocks[8] == (128, 8)
    assert blocks[-1] == (150, 6)
    reads = []
    ran = fast_decode.run_phased_decode(
        [64], lambda b, n: None, lambda: reads.append(1) or len(reads) > 3)
    assert ran == 24 and len(reads) == 4


def test_module_loop_equals_jax_on_the_v1_golden():
    """_greedy_loop, the v1 (decoder_prepend) model's exact path, with its
    device position and phases against JAX's model-apply loop on the same
    encoder states and memory prefix: the trained parity model's tokens
    equal, over 300 steps (phases 256 and 300: a last block of 4)."""
    params, _ = load_golden('parity_v1.npz')
    jmodel = JaxMT3(V1_CFG)
    variables = {'params': params}
    rng = np.random.default_rng(7)
    mel = jnp.asarray(rng.normal(size=(2, 256, V1_CFG.mel_bins)) * 0.5,
                      jnp.float32)
    enc = jmodel.apply(variables, mel, method=JaxMT3.encode_audio)
    mem = jax_decode.initial_segmem_tokens(V1_CFG, 2, 300)
    prefix = jmodel.apply(variables, mem, method=JaxMT3.compute_segmem)
    want = np.asarray(jax_decode._greedy_loop(
        jmodel, variables, enc, 300, decoder_prefix_embeds=prefix))
    model = port_model(params, V1_CFG)
    got = decode._greedy_loop(
        model, torch.from_numpy(np.array(enc)), 300,
        decoder_prefix_embeds=torch.from_numpy(np.array(prefix))).numpy()
    eos = [int(np.flatnonzero(r == V1_CFG.eos_token_id)[0])
           if (r == V1_CFG.eos_token_id).any() else None for r in want]
    print(f'v1 module loop: first EOS per row {eos}')
    np.testing.assert_array_equal(got, want)


def test_graphs_only_on_the_card():
    """graphs=True on the CPU raises; nothing captures there."""
    with pytest.raises(ValueError, match='CUDA graphs'):
        fast_decode.use_graphs(torch.device('cpu'), True)
    assert not fast_decode.use_graphs(torch.device('cpu'), None)
    assert fast_decode.use_graphs(torch.device('cuda'), None)
    assert not fast_decode.use_graphs(torch.device('cuda'), False)
