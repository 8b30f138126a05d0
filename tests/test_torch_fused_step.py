"""The decoder step of the port (mr_mt3_tpu_torch.ops.fused_decode.
fused_decode_step) against the JAX fused_decode_step in its three modes:
exact (fused_bf16), int8 (fused) and int4 (fused_int4).

On the CPU the port's wrapper runs its plain PyTorch version (the CUDA
kernel csrc/fused_decode_step.cu is held against that version on the card
by chip_smoke.py and tests/test_torch_fused_decode_gpu.py); the JAX kernel
runs in interpret mode. Unlike the port's window, the step keeps the JAX
kernel's cache chunks (chunk_base_for: 256 positions here): each live chunk
is one flash update, and in the integer modes each requantizes its
probabilities with its own max, so a cache holding rows in two chunks
tells the function from a one-chunk softmax.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mr_mt3_tpu.ops import fused_decode as jax_fd
from mr_mt3_tpu_torch.ops import fused_decode as fd
from mr_mt3_tpu_torch.ops.int8_matmul import pack_int4, unpack_int4
from tests.parity_common import VANILLA_CFG, load_golden
from tests.test_fused_decode import SMALL_CFG
from tests.test_torch_fused_decode import (  # noqa: F401 (fixture)
    Pair,
    _parity_enc,
    codes,
    small,
)
from tests.torch_threads import two_torch_threads  # noqa: F401

# Logits against JAX, over the largest |logit|. Measured at SMALL_CFG, B 3,
# one step at position 300 of a 512 cache filled from a numpy seed (two
# live chunks), model and fill seeds 0-2: integer modes within 8e-8 (the
# same integer dots; f32 sums in other orders), bf16 within 1.44e-3 (seed
# 0; 8e-8 on seeds 1-2: one bf16 rounding of an activation at a tie, as in
# the window's tests). The tests' own cases (model seed 0, fill seed 5, and
# two steps from an empty cache) read 0-8e-8 in every mode. The bounds are
# about 3x the bf16 reading and, in the integer modes, far below the
# one-chunk control's 7.3e-3-2.4e-2, which they must catch (in bf16 the
# control moves the logits only when a later chunk holds the larger max).
LOGIT_RTOL = {'fused_bf16': 5e-3, 'fused': 1e-6, 'fused_int4': 1e-6}
# emitted rows: equal codes (read: all equal) and scales within 1.5e-7
SCALE_RTOL = 1e-6
# bf16 K/V rows: one bf16 ulp (2^-8 relative) if a sum order flips a
# rounding (read: bit-equal)
KV_RTOL = 2 ** -8
TIERS = list(fd.FUSED_TIERS)
INT_TIERS = ['fused', 'fused_int4']


# the JAX step, interpreted, compiled once per operand shapes (the
# interpreter's grid loop costs ~1.5 s a step uncompiled)
_jax_step = jax.jit(jax_fd.fused_decode_step, static_argnums=(0,),
                    static_argnames=('interpret',))


def jax_step(pair, tokens, pos):
    logits, pair.cache_j = _jax_step(
        pair.cfg, pair.fp_j, pair.dp_j, jnp.asarray(tokens), jnp.int32(pos),
        pair.cache_j, pair.cross_j, interpret=True)
    return np.asarray(logits)


def port_step(pair, tokens, pos):
    logits, pair.cache_t = fd.fused_decode_step(
        pair.tcfg, pair.dp_t.fused, pair.dp_t, torch.from_numpy(tokens), pos,
        pair.cache_t, pair.cross_t)
    return logits.numpy()


def step_input(pair, tokens, pos):
    """The step's f32 input row, as the wrapper gathers it."""
    return pair.dp_t.token_embed[torch.from_numpy(tokens).long()].float() \
        + pair.dp_t.pos_table[pos].float()


def rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_cache_equal(pair, positions):
    """The cache rows (and scales) at positions agree with JAX's."""
    tier = pair.tier
    for key in ('kq', 'vq'):
        if tier == 'fused_bf16':
            a = pair.cache_t[key][..., positions].float().numpy()
            b = np.asarray(pair.cache_j[key], np.float32)[..., positions]
            assert np.abs(a - b).max() <= KV_RTOL * np.abs(b).max(), key
        else:
            np.testing.assert_array_equal(
                codes(pair.cache_t[key])[..., positions],
                codes(pair.cache_j[key])[..., positions], key)
    if tier != 'fused_bf16':
        for key in ('ks', 'vs'):
            a = pair.cache_t[key][..., positions].numpy()
            b = np.asarray(pair.cache_j[key])[..., positions]
            assert rel(a, b) <= SCALE_RTOL, key


def fill_cache(pair, upto: int, seed: int):
    """The same cache on both sides: rows < upto from a numpy generator
    (bf16 values, or codes in +-qmax with scales 0.5-1.5 / qmax)."""
    rng = np.random.default_rng(seed)
    L, H, dk = SMALL_CFG.num_decoder_layers, SMALL_CFG.num_heads, \
        SMALL_CFG.d_kv
    B, P = pair.cache_t['kq'].shape[2], pair.cache_len
    for key in ('k', 'v'):
        if pair.tier == 'fused_bf16':
            v = torch.from_numpy(rng.normal(size=(L, H, B, dk, P)).astype(
                np.float32)).to(torch.bfloat16)
            v[..., upto:] = 0
            pair.cache_t[key + 'q'] = v
            pair.cache_j[key + 'q'] = jnp.asarray(v.float().numpy()).astype(
                jnp.bfloat16)
            continue
        qmax = fd.QMAX[pair.tier]
        c = rng.integers(-qmax, qmax + 1, size=(L, H, B, dk, P)).astype(
            np.int8)
        s = (rng.uniform(0.5, 1.5, size=(L, H, B, P)) / qmax).astype(
            np.float32)
        c[..., upto:] = 0
        s[..., upto:] = 0
        ct = torch.from_numpy(c)
        pair.cache_t[key + 'q'] = pack_int4(ct) \
            if pair.tier == 'fused_int4' else ct
        pair.cache_t[key + 's'] = torch.from_numpy(s)
        pair.cache_j[key + 'q'] = jnp.asarray(c).astype(
            jnp.int4 if pair.tier == 'fused_int4' else jnp.int8)
        pair.cache_j[key + 's'] = jnp.asarray(s)


class TestStepAgainstJax:
    @pytest.mark.parametrize('tier', TIERS)
    def test_two_steps_from_an_empty_cache(self, small, tier):
        """Steps at positions 0 and 1 (the second reads the row the first
        wrote): logits and the cache rows each wrote."""
        params, enc = small
        pair = Pair(params, SMALL_CFG, enc, 16, tier)
        for pos, tokens in enumerate(([3, 77, 5], [7, 9, 200])):
            tokens = np.array(tokens, np.int32)
            want = jax_step(pair, tokens, pos)
            got = port_step(pair, tokens, pos)
            print(f'{tier} step {pos}: logits within {rel(got, want):.3g}')
            assert rel(got, want) <= LOGIT_RTOL[tier], pos
        assert_cache_equal(pair, [0, 1])

    @pytest.mark.parametrize('tier', TIERS)
    def test_two_live_chunks(self, small, tier):
        """One step at position 300 of a 512 cache filled from a seed:
        chunks 0-255 and 256-299 are live. In the integer modes the
        one-chunk control (the same plain version with chunk 512, the
        port's window's softmax) must break the bound."""
        params, enc = small
        pair = Pair(params, SMALL_CFG, enc, 512, tier)
        assert fd.cache_chunk(pair.cache_t, pair.cross_t) == 256
        fill_cache(pair, 300, seed=5)
        tokens = np.array([3, 77, 5], np.int32)
        x = step_input(pair, tokens, 300)
        control = fd.fused_decode_step_reference(
            pair.tcfg, pair.dp_t.fused, x, 300, pair.cache_t, pair.cross_t,
            512)[0].numpy()
        want = jax_step(pair, tokens, 300)
        got = port_step(pair, tokens, 300)
        print(f'{tier}: logits within {rel(got, want):.3g}, one-chunk '
              f'control {rel(control, want):.3g}')
        assert rel(got, want) <= LOGIT_RTOL[tier]
        if tier in INT_TIERS:
            assert rel(control, want) > LOGIT_RTOL[tier]
        assert_cache_equal(pair, [300])
        assert (pair.cache_t['kq'].float()[..., 301:] == 0).all()

    def test_cache_length_must_be_a_chunk_multiple(self, small):
        params, enc = small
        pair = Pair(params, SMALL_CFG, enc, 300)
        with pytest.raises(ValueError, match='multiple'):
            port_step(pair, np.zeros(3, np.int32), 0)
        with pytest.raises(ValueError, match='multiple'):
            jax_step(pair, np.zeros(3, np.int32), 0)


class TestStepSemantics:
    def test_int4_odd_position_keeps_the_other_nibble(self, small):
        """An int4 step at odd position 5 writes the high nibble of byte 2
        and keeps its low nibble (position 4); no other position moves.
        JAX's step writes the same codes."""
        params, enc = small
        pair = Pair(params, SMALL_CFG, enc, 16, 'fused_int4')
        fill_cache(pair, 16, seed=3)
        before = unpack_int4(pair.cache_t['kq']).clone()
        tokens = np.array([3, 77, 5], np.int32)
        port_step(pair, tokens, 5)
        jax_step(pair, tokens, 5)
        after = unpack_int4(pair.cache_t['kq'])
        keep = [p for p in range(16) if p != 5]
        assert torch.equal(after[..., keep], before[..., keep])
        assert not torch.equal(after[..., 5], before[..., 5])
        assert_cache_equal(pair, list(range(16)))

    def test_rows_land_at_the_position(self, small):
        """bf16: the step's rows go to cache position p, nothing else."""
        params, enc = small
        pair = Pair(params, SMALL_CFG, enc, 16)
        pair.cache_t['kq'][...] = 1.0
        tokens = np.array([3, 77, 5], np.int32)
        x = step_input(pair, tokens, 4)
        _, rows = fd.fused_decode_step_reference(
            pair.tcfg, pair.dp_t.fused, x, 4, pair.cache_t, pair.cross_t, 16)
        port_step(pair, tokens, 4)
        L, H, dk = 2, 4, 8
        assert torch.equal(pair.cache_t['kq'][..., 4],
                           rows['kq'].reshape(L, H, 3, dk))
        assert (pair.cache_t['kq'][..., :4] == 1.0).all()
        assert (pair.cache_t['kq'][..., 5:] == 1.0).all()

    def test_position_past_the_cache_raises(self, small):
        params, enc = small
        pair = Pair(params, SMALL_CFG, enc, 16)
        with pytest.raises(ValueError, match='outside'):
            port_step(pair, np.zeros(3, np.int32), 16)

    def test_no_quiet_fallback_off_the_cpu(self, small):
        params, enc = small
        pair = Pair(params, SMALL_CFG, enc, 16)
        with pytest.raises(ValueError, match='device'):
            fd.fused_decode_step(
                pair.tcfg, pair.dp_t.fused, pair.dp_t,
                torch.zeros(3, dtype=torch.int32, device='meta'), 0,
                pair.cache_t, pair.cross_t)

    @pytest.mark.parametrize('tier', ['fused_bf16', 'fused'])
    def test_teacher_forced_rows_match_the_window(self, small, tier):
        """The same forced tokens through the step and through one-step
        windows (tests/test_fused_decode.py:187-223): the caches agree
        dequantized within 3% of their largest value (the window embeds
        through bf16 and attends in-window rows in bf16, the step gathers
        f32 rows and adds its f32 diagonal term). Read at 8 steps: 0.66% /
        0.78% (bf16 k / v) and 0.88% / 1.0% (int8); JAX's own test bounds
        its pair at 5%."""
        params, enc = small
        pair = Pair(params, SMALL_CFG, enc[:2], 16, tier)
        window = fd.init_fused_cache(pair.tcfg, 2, 16, 'cpu', tier)
        forced = np.random.default_rng(7).integers(1, 200, size=(2, 8))
        for step in range(8):
            tokens = forced[:, step].astype(np.int32)
            port_step(pair, tokens, step)
            fd.fused_decode_window(
                pair.tcfg, pair.dp_t.fused, pair.dp_t,
                torch.from_numpy(tokens), torch.zeros(2, dtype=torch.bool),
                step, window, pair.cross_t, t_window=1)
        for key in ('k', 'v'):
            a, b = pair.cache_t[key + 'q'].float(), window[key + 'q'].float()
            if tier != 'fused_bf16':
                a = a * pair.cache_t[key + 's'][..., None, :]
                b = b * window[key + 's'][..., None, :]
            err = float((a - b).abs().max() / b.abs().max())
            print(f'{tier} {key}: step vs window rows within {err:.3g}')
            assert err < 0.03, key


class TestParityModel:
    @pytest.mark.parametrize('tier', TIERS)
    def test_step_tokens_equal_window_and_jax(self, tier):
        """On the overfit parity model (decode margins ~2.0) 16 greedy
        steps through the step, the argmax taken outside, give the window's
        tokens (two windows of 8) and JAX's step-driven tokens, and the
        golden transcription's."""
        params, meta = load_golden('parity_vanilla.npz')
        pair = Pair(params, VANILLA_CFG, _parity_enc(params), 16, tier)
        tok_j = tok_t = np.zeros(2, np.int32)
        got, want = [], []
        for pos in range(16):
            tok_j = jax_step(pair, tok_j, pos).argmax(-1).astype(np.int32)
            tok_t = port_step(pair, tok_t, pos).argmax(-1).astype(np.int32)
            want.append(tok_j)
            got.append(tok_t)
        got, want = np.stack(got, 1), np.stack(want, 1)
        np.testing.assert_array_equal(got, want)
        window = fd.init_fused_cache(pair.tcfg, 2, 16, 'cpu', tier)
        tokens = torch.zeros(2, dtype=torch.int32)
        fin = torch.zeros(2, dtype=torch.bool)
        win = []
        for pos in (0, 8):
            w, fin, window = fd.fused_decode_window(
                pair.tcfg, pair.dp_t.fused, pair.dp_t, tokens, fin, pos,
                window, pair.cross_t, t_window=8)
            win.append(w.numpy())
            tokens = w[:, -1].contiguous()
        np.testing.assert_array_equal(got, np.concatenate(win, 1))
        np.testing.assert_array_equal(got, meta['tokens'][0][:2, 1:17])
