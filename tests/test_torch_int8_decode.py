"""The 'int8' and 'int8_kv' decode tiers of the port (device='cpu')
against the JAX package: the plain versions of the three kernels
(int8_matmul, int8_gated_ff, int8_decode_attention) against the JAX
kernels run with interpret=True, the K/V row quantizer, the decode-param
stacking, greedy_loop_fast against JAX's greedy_decode (fp32 and bf16
models, past a 64-step cache phase of the JAX loop) and the with-prev
segment-memory chain at both tiers.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held against those on the card (tests/test_torch_fused_decode_gpu.py,
chip_smoke.py). Run with -s to see the readings behind each tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mr_mt3_tpu.models import MT3 as JaxMT3
from mr_mt3_tpu.ops import decode as jax_decode
from mr_mt3_tpu.ops import fast_decode as jax_fast
from mr_mt3_tpu.ops.int8_attention import (
    int8_decode_attention as jax_attention,
)
from mr_mt3_tpu.ops.int8_attention import quantize_kv_rows as jax_quantize_kv
from mr_mt3_tpu.ops.int8_matmul import int8_gated_ff as jax_gated_ff
from mr_mt3_tpu.ops.int8_matmul import int8_matmul as jax_matmul
from mr_mt3_tpu.ops.int8_matmul import quantize_columns as jax_quantize
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.ops import decode
from mr_mt3_tpu_torch.ops import fast_decode
from mr_mt3_tpu_torch.ops import fused_decode as fd
from mr_mt3_tpu_torch.ops import int8_attention as i8a
from mr_mt3_tpu_torch.ops import int8_matmul as i8m
from mr_mt3_tpu_torch.utils.checkpoint_import import state_dict_from_jax_params
from tests.test_fused_decode import SMALL_CFG
from tests.test_torch_segmem import SMALL_SEGMEM
from tests.torch_threads import two_torch_threads  # noqa: F401

# (d_model, vocab, d_ff, heads, d_kv): SMALL_CFG and the parity models
# (tests/parity_common.py:36)
WIDTHS = {'small': (32, 256, 48, 4, 8), 'parity': (96, 1536, 192, 4, 24)}
DTYPES = {'float32': (jnp.float32, torch.float32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16)}
SEEDS = [0, 1, 2]

# Plain versions against the JAX kernels (interpreted), largest |difference|
# over the largest |JAX output|. Both sum in f32 in other orders (XLA's CPU
# dot vs torch's), so f32 outputs differ in their last bits: read at most
# 5.5e-7 (int8_matmul) and 6.1e-7 (int8_decode_attention: the softmax sums
# and exps, no requantized code apart) over seeds 0-2 at both widths. The
# feed-forward rounds its intermediate to bf16, and an f32 value within an
# ulp of a bf16 rounding midpoint can land one bf16 step apart: read
# 5.4e-4 (seed 1, parity widths), 2.2e-7 otherwise. bf16 inputs: every
# output was equal (0 of 12 cases per kernel with a difference); a bound of
# one bf16 step of the largest output and 1% of the outputs unequal
# leaves room for such a tie.
F32_RTOL = {'matmul': 2e-6, 'gated_ff': 2e-3, 'attention': 2e-6}
BF16_RTOL = 2 ** -8
BF16_UNEQUAL = 0.01
# the attention case of each width, (cache length, position): at
# SMALL_CFG a self-attention midway through a 64-row cache phase, at the
# parity widths a cross-attention over all of 260 rows
ATTN_CASES = {'small': (64, 31), 'parity': (260, 259)}

# Greedy decodes against JAX's greedy_decode on the same weights. fp32
# models: every token equal (read on SMALL_CFG seeds 0-2, 72 steps, and
# on the parity model, both tiers). bf16 models: the two frameworks round
# their bf16 matmul outputs after sums in other orders, so a logit may
# land a bf16 step or two from JAX's, and at random weights the top bf16
# logits of a step are often that close: a row may part from JAX's where
# JAX scores the two tokens within MAX_GAP_STEPS bf16 steps of each other
# (steps at the size of JAX's top logit). Read on SMALL_CFG seeds 0-2,
# bf16: int8 parts 3 times, all at exact ties (0 steps); int8_kv 6 times,
# at 0, 1 and 2 steps; and the exact tier ('none') parts from JAX's
# exact tier 7 times on the same seeds, at 0, 1 and 2 steps: the bf16
# class, not the int8 tiers.
MAX_GAP_STEPS = 3
MAX_LENGTH = 72          # past the JAX loop's first 64-step cache phase


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a, np.float32)))


def _inputs(seed, dtype, *shapes):
    """Normal inputs of each shape from one numpy generator, rounded to the
    dtype: (JAX arrays, port tensors)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrs = [jnp.asarray(rng.normal(size=s).astype(np.float32), jdt)
            for s in shapes]
    return arrs, [_t(a).to(tdt) for a in arrs]


def _quantized(seed, *shapes, scale=1.0):
    """Weights quantized per column by JAX: (JAX (codes, scales), port)."""
    rng = np.random.default_rng(100 + seed)
    jq = [jax_quantize(jnp.asarray(rng.normal(size=s) * scale, jnp.float32))
          for s in shapes]
    tq = [(torch.from_numpy(np.array(c)), _t(s)) for c, s in jq]
    return jq, tq


def _agree(name, got: torch.Tensor, want, dtype, rtol_key):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    unequal = float((got != want).mean())
    print(f'{name}: rel {rel:.3g}, unequal {unequal:.4f}')
    if dtype == 'float32':
        assert rel <= F32_RTOL[rtol_key], (name, rel)
    else:
        assert rel <= BF16_RTOL and unequal <= BF16_UNEQUAL, (name, rel,
                                                              unequal)


class TestPlainVersionsAgainstJax:
    @pytest.mark.parametrize('dtype', list(DTYPES))
    @pytest.mark.parametrize('seed', SEEDS)
    def test_int8_matmul(self, seed, dtype):
        for width, (d, vocab, *_) in WIDTHS.items():
            (xj,), (xt,) = _inputs(seed, dtype, (3, d))
            [(wq, s)], [(wt, st)] = _quantized(seed, (d, vocab), scale=0.05)
            want = jax_matmul(xj, wq, s, interpret=True)
            got = i8m.int8_matmul(xt, wt, st)
            assert got.dtype == xt.dtype and got.shape == (3, vocab)
            _agree(f'int8_matmul {width} seed {seed} {dtype}', got, want,
                   dtype, 'matmul')

    @pytest.mark.parametrize('dtype', list(DTYPES))
    @pytest.mark.parametrize('seed', SEEDS)
    def test_int8_gated_ff(self, seed, dtype):
        for width, (d, _, f, *_) in WIDTHS.items():
            (hj,), (ht,) = _inputs(seed, dtype, (3, d))
            jq, tq = _quantized(seed, (d, f), (d, f), (f, d), scale=0.2)
            want = jax_gated_ff(hj, *[a for pair in jq for a in pair],
                                interpret=True)
            got = i8m.int8_gated_ff(ht, *[a for pair in tq for a in pair])
            assert got.dtype == ht.dtype and got.shape == (3, d)
            _agree(f'int8_gated_ff {width} seed {seed} {dtype}', got, want,
                   dtype, 'gated_ff')

    @pytest.mark.parametrize('dtype', list(DTYPES))
    @pytest.mark.parametrize('seed', SEEDS)
    def test_int8_decode_attention(self, seed, dtype):
        for width, (*_, heads, dk) in WIDTHS.items():
            k_len, position = ATTN_CASES[width]
            (qj, kj, vj), (qt, _, _) = _inputs(
                seed, dtype, (2, heads, dk), (2, heads, dk, k_len),
                (2, heads, dk, k_len))
            (kq, ks), (vq, vs) = jax_quantize_kv(kj), jax_quantize_kv(vj)
            want = jax_attention(qj, kq, ks, vq, vs, position,
                                 interpret=True)
            got = i8a.int8_decode_attention(
                qt, *[torch.from_numpy(np.array(a))
                      for a in (kq, ks, vq, vs)], position)
            assert got.dtype == qt.dtype and got.shape == (2, heads * dk)
            _agree(f'int8_decode_attention {width} K {k_len} position '
                   f'{position} seed {seed} {dtype}', got, want, dtype,
                   'attention')


class TestKvQuantizer:
    def test_equals_jax_with_an_all_zero_row(self):
        """The port's quantize_kv_rows gives JAX's codes and scales, the
        all-zero position included (scale 1e-12: floored after the
        division). The window kernel's quantize_rows floors before
        dividing, so on a copy of the same rows (in its (..., dk) layout)
        it gives that position another scale."""
        x = np.random.default_rng(0).normal(size=(2, 3, 8, 5)).astype(
            np.float32)
        x[1, 2, :, 3] = 0.0
        want_codes, want_scale = (np.asarray(a) for a in
                                  jax_quantize_kv(jnp.asarray(x)))
        codes, scale = i8a.quantize_kv_rows(torch.from_numpy(x.copy()))
        np.testing.assert_array_equal(codes.numpy(), want_codes)
        np.testing.assert_array_equal(scale.numpy(), want_scale)
        assert want_scale[1, 2, 0, 3] == np.float32(1e-12)
        _, window_scale = fd.quantize_rows(
            torch.from_numpy(x.copy()).transpose(-1, -2), 127)
        window_scale = window_scale.numpy()
        zero = np.ravel_multi_index((1, 2, 3), window_scale.shape)
        np.testing.assert_array_equal(
            np.delete(window_scale.reshape(-1), zero),
            np.delete(want_scale.reshape(-1), zero))
        assert window_scale[1, 2, 3] != want_scale[1, 2, 0, 3]


class TestAttentionSemantics:
    def test_positions_past_the_query_are_never_read(self):
        """Codes and scales past `position` (garbage here) change nothing:
        a full-length cache equals the JAX loop's phase-grown one."""
        rng = np.random.default_rng(3)
        q = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
        kv = [torch.from_numpy(rng.normal(size=(2, 4, 8, 64)).astype(
            np.float32)) for _ in range(2)]
        (kq, ks), (vq, vs) = (i8a.quantize_kv_rows(t) for t in kv)
        want = i8a.int8_decode_attention(q, kq[..., :24], ks[..., :24],
                                         vq[..., :24], vs[..., :24], 20)
        for t in (kq, vq):
            t[..., 21:] = 127
        for t in (ks, vs):
            t[..., 21:] = 1e6
        got = i8a.int8_decode_attention(q, kq, ks, vq, vs, 20)
        np.testing.assert_array_equal(got.numpy(), want.numpy())

    def test_no_quiet_fallback_off_the_cpu(self):
        """A tensor neither on the CPU nor on a card raises; nothing falls
        back to the plain versions."""
        q = torch.zeros((1, 4, 8), device='meta')
        codes = torch.zeros((1, 4, 8, 8), dtype=torch.int8, device='meta')
        scales = torch.zeros((1, 4, 1, 8), device='meta')
        with pytest.raises(ValueError, match='unsupported device'):
            i8a.int8_decode_attention(q, codes, scales, codes, scales, 3)
        with pytest.raises(ValueError, match='unsupported device'):
            i8m.int8_matmul(torch.zeros((1, 8), device='meta'),
                            codes[0, 0], scales[0, 0])


def _port_model(params, jax_cfg) -> MT3:
    cfg = MT3Config(**{f: getattr(jax_cfg, f)
                       for f in MT3Config.__dataclass_fields__})
    model = MT3(cfg).eval()
    model.load_state_dict(state_dict_from_jax_params(params, cfg))
    return model


@pytest.fixture(scope='module')
def small():
    """SMALL_CFG with the JAX package's seed-1 init (its greedy tokens are
    varied: 19 distinct in 72 steps) and 3 rows of random mel."""
    params = JaxMT3(SMALL_CFG).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, 16)),
        decoder_input_ids=jnp.zeros((1, 4), jnp.int32))['params']
    mel = np.random.default_rng(1).normal(size=(3, 256, 16)).astype(
        np.float32)
    return params, mel


def test_int8_stack_quantizes_the_f32_parameters(small):
    """A bf16 model's int8 codes and scales equal JAX's, which quantizes
    the f32 parameters (rounding through bf16 first would move codes)."""
    params, _ = small
    jcfg = SMALL_CFG.replace(dtype='bfloat16')
    jdp = jax_fast.stack_decode_params(params, jcfg, quantize='int8')
    model = _port_model(params, jcfg)
    dp = fast_decode.stack_decode_params(model, 'int8')
    for name in ('wi_0', 'wi_1', 'wo'):
        want = jdp.layers['ff_i8'][name]
        np.testing.assert_array_equal(dp.layers[name + '_q'].numpy(),
                                      np.asarray(want['w']))
        np.testing.assert_array_equal(dp.layers[name + '_s'].numpy(),
                                      np.asarray(want['s']))
        assert name not in dp.layers
    np.testing.assert_array_equal(dp.lm_head_q.numpy(),
                                  np.asarray(jdp.lm_head_q))
    np.testing.assert_array_equal(dp.lm_head_scale.numpy(),
                                  np.asarray(jdp.lm_head_scale))
    assert dp.layers['q'].dtype == torch.bfloat16
    with pytest.raises(ValueError, match='not stacked'):
        fast_decode.greedy_loop_fast(model.cfg, dp, torch.zeros((1, 8, 32)),
                                     4, quantize='int8_kv')


def _jax_logits(params, jcfg, mel, tokens, quantize, steps):
    """JAX's own logits of steps 0..steps-1, teacher-forced on its greedy
    tokens (its decode_step_fast, jitted, on a cache of MAX_LENGTH rows)."""
    enc = JaxMT3(jcfg).apply({'params': params}, jnp.asarray(mel),
                             method=JaxMT3.encode_audio)
    dp = jax_fast.stack_decode_params(
        params, jcfg, quantize='int8' if quantize == 'int8' else 'none')
    cross = jax_fast.precompute_cross_kv_stacked(dp, jcfg, enc)
    batch = mel.shape[0]
    if quantize == 'int8_kv':
        cross = jax_fast.quantize_cross_kv(cross)
        cache = jax_fast.init_int8_cache_stacked(jcfg, batch, MAX_LENGTH)
    else:
        cache = jax_fast.init_cache_stacked(jcfg, batch, MAX_LENGTH)
    step = jax.jit(lambda dp, tok, pos, cache, cross:
                   jax_fast.decode_step_fast(jcfg, dp, tok, pos, cache,
                                             cross, quantize=quantize))
    out = []
    for i in range(steps):
        logits, cache = step(dp, jnp.asarray(tokens[:, i]), jnp.int32(i),
                             cache, cross)
        out.append(np.asarray(logits, np.float32))
    return np.stack(out)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('quantize', ['int8', 'int8_kv'])
def test_greedy_decode_equals_jax(small, quantize, dtype):
    """72 greedy steps of 3 rows through both tiers: fp32 tokens equal;
    bf16 rows equal up to a first difference where JAX's logits of the
    two tokens are within MAX_GAP_STEPS bf16 steps."""
    params, mel = small
    jcfg = SMALL_CFG.replace(dtype=dtype)
    want = np.asarray(jax_decode.greedy_decode(
        JaxMT3(jcfg), {'params': params}, jnp.asarray(mel),
        max_length=MAX_LENGTH, quantize=quantize))
    got = decode.greedy_decode(_port_model(params, jcfg),
                               torch.from_numpy(mel), MAX_LENGTH,
                               quantize=quantize).numpy()
    assert got.shape == want.shape == (3, MAX_LENGTH + 1)
    first = [int(np.flatnonzero(g != w)[0]) if (g != w).any() else None
             for g, w in zip(got, want)]
    print(f'{quantize} {dtype}: first difference per row {first}')
    if dtype == 'float32':
        np.testing.assert_array_equal(got, want)
        return
    parted = [(b, d) for b, d in enumerate(first) if d is not None]
    if not parted:
        return
    logits = _jax_logits(params, jcfg, mel, want, quantize,
                         max(d for _, d in parted))
    for b, d in parted:
        row = logits[d - 1, b]           # the step that chose token d
        top = float(row[want[b, d]])
        step = 2.0 ** (np.floor(np.log2(abs(top))) - 7)   # bf16 spacing
        gap = (top - float(row[got[b, d]])) / step
        print(f'  row {b} parts at token {d}: JAX margin {gap:g} bf16 '
              f'steps (top logit {top})')
        assert 0 <= gap <= MAX_GAP_STEPS, (b, d, gap)


@pytest.mark.parametrize('quantize', ['int8', 'int8_kv'])
def test_withprev_chain_equals_jax(quantize):
    """segmem_greedy_decode of an 'encoder_append' (with-prev) model, 2
    chains of 3 segments, 24 steps (the memory rows raise Lenc to 264):
    the port's tokens equal JAX's at both tiers."""
    params = JaxMT3(SMALL_SEGMEM).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 256, 512)),
        decoder_input_ids=jnp.zeros((1, 4), jnp.int32),
        targets_prev=jnp.zeros((1, 4), jnp.int32))['params']
    mel = (np.random.default_rng(11).normal(size=(2, 3, 256, 512))
           * 0.5).astype(np.float32)
    want = np.asarray(jax_decode.segmem_greedy_decode(
        JaxMT3(SMALL_SEGMEM), {'params': params}, jnp.asarray(mel),
        max_length=24, quantize=quantize))
    got = decode.segmem_greedy_decode(
        _port_model(params, SMALL_SEGMEM), torch.from_numpy(mel),
        max_length=24, quantize=quantize).numpy()
    assert got.shape == (2, 3, 25)
    np.testing.assert_array_equal(got, want)
