"""The grouped int8 window of the port (mr_mt3_tpu_torch.ops.
group_axis_kernel) against the JAX benchmarks/group_axis_kernel.py.

On the CPU the port's wrapper runs its plain PyTorch version (the CUDA
kernel, fdw_grouped_launch of csrc/fused_decode_window.cu, is held against
that version on the card by chip_smoke.py and
tests/test_torch_fused_decode_gpu.py); the JAX kernel runs in interpret
mode, compiled once per operand shapes. The grouped window attends the
cache rows before it in the JAX kernel's chunks and rounds the emitted
K/V scales to bf16; its in-window rows are bf16, as the window's are.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks import group_axis_kernel as jax_gk
from mr_mt3_tpu_torch.ops import fused_decode as fd
from mr_mt3_tpu_torch.ops import group_axis_kernel as gk
from tests.parity_common import VANILLA_CFG, load_golden
from tests.test_fused_decode import SMALL_CFG
from tests.test_torch_fused_decode import (
    Pair,
    _parity_enc,
    _small_inputs,
    assert_tokens_agree,
    codes,
)
from tests.torch_threads import two_torch_threads  # noqa: F401

# Against JAX over three chained 8-step windows at SMALL_CFG, B 16 (two
# groups), chunk 8 (the third window reads two live chunks), seeds 0-2:
# tokens equal; cache codes unequal in at most 0.043% of entries and at
# most 3 apart (seed 2; seed 1 bit-exact), scales within 4.6e-3 of the
# largest (a bf16-rounded scale one bf16 step apart, 2^-8 = 3.9e-3). The
# mechanism is the window's (tests/test_torch_fused_decode.py: f32 sums in
# other orders break a bf16 rounding tie differently). Bounds about 3x
# the readings; the code difference is the reading, a count of steps.
CODE_SHARE = 0.9985
CODE_DIFF = 3
SCALE_RTOL = 1.5e-2
# teacher-forced grouped rows against the port's step, dequantized, over
# the largest value (read: 1.18% k, 1.32% v; JAX's own test bounds its
# pair at 5%)
STEP_RTOL = 4e-2

_jax_grouped = jax.jit(jax_gk.fused_decode_window_grouped,
                       static_argnums=(0,),
                       static_argnames=('t_window', 'interpret',
                                        'chunk_base'))


class GroupPair:
    """Grouped operands of one int8 model on both sides."""

    def __init__(self, params, cfg, enc, cache_len, n_groups):
        self.pair = Pair(params, cfg, enc, cache_len, 'fused')
        self.cfg, self.tcfg, self.g = cfg, self.pair.tcfg, n_groups
        self.cross_j = jax_gk.regroup_cross_kv(self.pair.cross_j, n_groups)
        self.cross_t = gk.regroup_cross_kv(self.pair.cross_t, n_groups)
        self.cache_j = jax_gk.init_fused_cache_grouped(cfg, n_groups,
                                                       cache_len)
        self.cache_t = gk.init_fused_cache_grouped(self.tcfg, n_groups,
                                                   cache_len, 'cpu')

    def jax_window(self, tokens, finished, pos, t_window, chunk_base):
        toks, fin, self.cache_j = _jax_grouped(
            self.cfg, self.pair.fp_j, self.pair.dp_j, jnp.asarray(tokens),
            jnp.asarray(finished), jnp.int32(pos), self.cache_j,
            self.cross_j, t_window=t_window, interpret=True,
            chunk_base=chunk_base)
        return np.asarray(toks), np.asarray(fin)

    def port_window(self, tokens, finished, pos, t_window, chunk_base):
        """The port's wrapper, and the plain version's per-step logits on
        the same inputs (read before the wrapper writes the cache)."""
        dp = self.pair.dp_t
        logits = gk.fused_decode_window_grouped_reference(
            self.tcfg, dp.fused, fd.window_pos_rows(dp, pos, t_window),
            torch.from_numpy(tokens), torch.from_numpy(finished), pos,
            self.cache_t, self.cross_t, t_window,
            fd.cache_chunk(self.cache_t, self.cross_t, chunk_base),
            return_logits=True)[3]
        toks, fin, self.cache_t = gk.fused_decode_window_grouped(
            self.tcfg, dp.fused, dp, torch.from_numpy(tokens),
            torch.from_numpy(finished), pos, self.cache_t, self.cross_t,
            t_window=t_window, chunk_base=chunk_base)
        return toks.numpy(), fin.numpy(), logits.numpy()


def _small_group(seed=0, cache_len=32) -> GroupPair:
    params = _small_inputs(seed)[0]
    enc = np.random.default_rng(seed).normal(size=(16, 8, 32)).astype(
        np.float32)
    return GroupPair(params, SMALL_CFG, enc, cache_len, 2)


@pytest.fixture(scope='module')
def group():
    return _small_group()


class TestLayouts:
    def test_regroup_matches_jax_and_inverts(self):
        """regroup_cross_kv equals JAX's on one array; ungroup inverts it."""
        a = np.random.default_rng(0).normal(size=(2, 4, 16, 8, 5)).astype(
            np.float32)
        want = np.asarray(jax_gk.regroup_cross_kv({'x': jnp.asarray(a)},
                                                  2)['x'])
        got = gk.regroup_cross_kv({'x': torch.from_numpy(a)}, 2)['x']
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.shape == (4, 4, 8, 8, 5)
        np.testing.assert_array_equal(gk.ungroup(got, 2).numpy(), a)

    def test_cache_layout_matches_jax(self, group):
        for key in ('kq', 'ks', 'vq', 'vs'):
            assert tuple(group.cache_t[key].shape) == \
                group.cache_j[key].shape
            assert str(group.cache_t[key].dtype).split('.')[-1] == \
                str(group.cache_j[key].dtype)


class TestInputChecks:
    @pytest.mark.parametrize('tier', ['fused_bf16', 'fused_int4'])
    def test_int8_only(self, group, tier):
        dp = fd.FusedParams(**{**group.pair.dp_t.fused._asdict(),
                               'wqkv': group.pair.dp_t.fused.wqkv.to(
                                   fd._TIER_DTYPE[tier])})
        with pytest.raises(NotImplementedError, match='int8'):
            gk.fused_decode_window_grouped(
                group.tcfg, dp, group.pair.dp_t, torch.zeros(16,
                                                             dtype=torch.int32),
                torch.zeros(16, dtype=torch.bool), 0, group.cache_t,
                group.cross_t)

    def test_rows_must_be_whole_groups(self, group):
        with pytest.raises(ValueError, match='groups'):
            gk.fused_decode_window_grouped(
                group.tcfg, group.pair.dp_t.fused, group.pair.dp_t,
                torch.zeros(12, dtype=torch.int32),
                torch.zeros(12, dtype=torch.bool), 0, group.cache_t,
                group.cross_t)

    def test_cache_length_must_be_a_chunk_multiple(self, group):
        cache = gk.init_fused_cache_grouped(group.tcfg, 2, 300, 'cpu')
        with pytest.raises(ValueError, match='multiple'):
            gk.fused_decode_window_grouped(
                group.tcfg, group.pair.dp_t.fused, group.pair.dp_t,
                torch.zeros(16, dtype=torch.int32),
                torch.zeros(16, dtype=torch.bool), 0, cache, group.cross_t)


class TestAgainstJax:
    @pytest.mark.parametrize('seed', [0, 2])
    def test_three_chained_windows(self, seed):
        """Windows at 0, 8 and 16 of a 32 cache with chunk 8 (the third
        reads two live chunks), row 5 starting finished: tokens up to a
        near-tie divergence, codes and scales within the bounds above, and
        every cache scale bf16-representable."""
        group = _small_group(seed)
        rng = np.random.default_rng(seed)
        tok_j = tok_t = rng.integers(3, 200, size=16).astype(np.int32)
        fin_j = fin_t = np.zeros(16, bool)
        fin_j[5] = fin_t[5] = True
        got, want, logits = [], [], []
        for pos in (0, 8, 16):
            tj, fin_j = group.jax_window(tok_j, fin_j, pos, 8, 8)
            tt, fin_t, lg = group.port_window(tok_t, fin_t, pos, 8, 8)
            got.append(tt)
            want.append(tj)
            logits.append(lg)
            tok_j, tok_t = tj[:, -1].copy(), tt[:, -1].copy()
        got, want = np.concatenate(got, 1), np.concatenate(want, 1)
        last = assert_tokens_agree(got, want, np.concatenate(logits, 0))
        assert (got[5] == SMALL_CFG.pad_token_id).all()
        if min(last) == 24:
            np.testing.assert_array_equal(fin_t, fin_j)
        for key in ('kq', 'vq'):
            a, b = codes(group.cache_t[key]), codes(group.cache_j[key])
            print(f'seed {seed} {key}: codes unequal in '
                  f'{(a != b).mean():.4%}, at most {np.abs(a - b).max()} '
                  f'apart')
            assert (a == b).mean() >= CODE_SHARE, key
            assert np.abs(a - b).max() <= CODE_DIFF, key
        for key in ('ks', 'vs'):
            a = group.cache_t[key]
            b = np.asarray(group.cache_j[key])
            err = np.abs(a.numpy() - b).max() / np.abs(b).max()
            print(f'seed {seed} {key}: scales within {err:.3g}')
            assert err <= SCALE_RTOL, key
            assert torch.equal(a, a.to(torch.bfloat16).float()), key


class TestSemantics:
    def test_teacher_forced_rows_match_the_step(self):
        """The same forced tokens through one-step grouped windows and
        through the port's step (tests/test_fused_decode.py:347-376): the
        caches agree dequantized within STEP_RTOL."""
        group = _small_group(cache_len=16)
        pair = group.pair
        forced = np.random.default_rng(7).integers(1, 200, size=(16, 8))
        for step in range(8):
            t = torch.from_numpy(forced[:, step].astype(np.int32))
            fd.fused_decode_step(pair.tcfg, pair.dp_t.fused, pair.dp_t, t,
                                 step, pair.cache_t, pair.cross_t)
            gk.fused_decode_window_grouped(
                group.tcfg, pair.dp_t.fused, pair.dp_t, t,
                torch.zeros(16, dtype=torch.bool), step, group.cache_t,
                group.cross_t, t_window=1)
        for key in ('k', 'v'):
            want = pair.cache_t[key + 'q'].float() \
                * pair.cache_t[key + 's'][..., None, :]
            got = gk.ungroup(group.cache_t[key + 'q'].float()
                             * group.cache_t[key + 's'][..., None, :], 2)
            err = float((got - want).abs().max() / want.abs().max())
            print(f'{key}: grouped vs step rows within {err:.3g}')
            assert err < STEP_RTOL, key

    def test_finished_rows_pad_and_flags_propagate(self, group):
        """Rows already finished (3 in group 0, 12 in group 1) emit only
        pads and stay finished (tests/test_fused_decode.py:440-455)."""
        fin = torch.zeros(16, dtype=torch.bool)
        fin[3] = fin[12] = True
        toks, fin_out, _ = gk.fused_decode_window_grouped(
            group.tcfg, group.pair.dp_t.fused, group.pair.dp_t,
            torch.zeros(16, dtype=torch.int32), fin, 0,
            gk.init_fused_cache_grouped(group.tcfg, 2, 32, 'cpu'),
            group.cross_t, t_window=4)
        assert (toks[3] == SMALL_CFG.pad_token_id).all()
        assert (toks[12] == SMALL_CFG.pad_token_id).all()
        assert bool(fin_out[3]) and bool(fin_out[12])
        want = (toks == SMALL_CFG.eos_token_id).any(1) | fin
        assert torch.equal(fin_out, want)

    def test_no_quiet_fallback_off_the_cpu(self, group):
        with pytest.raises(ValueError, match='device'):
            gk.fused_decode_window_grouped(
                group.tcfg, group.pair.dp_t.fused, group.pair.dp_t,
                torch.zeros(16, dtype=torch.int32, device='meta'),
                torch.zeros(16, dtype=torch.bool, device='meta'), 0,
                group.cache_t, group.cross_t)


def test_parity_model_tiled_equals_the_window():
    """The parity model's two confident rows tiled to 16 (two groups):
    two chained grouped windows of 8 give the port's window's tokens
    (tests/test_fused_decode.py:377-438) and the golden's."""
    params, meta = load_golden('parity_vanilla.npz')
    enc = np.tile(_parity_enc(params), (8, 1, 1))
    group = GroupPair(params, VANILLA_CFG, enc, 16, 2)
    pair = group.pair
    tok_g = tok_w = np.zeros(16, np.int32)
    fin_g = fin_w = np.zeros(16, bool)
    got, want = [], []
    for pos in (0, 8):
        tg, fin_g, _ = group.port_window(tok_g, fin_g, pos, 8, None)
        tw, fin_w, _ = pair.port_window(tok_w, fin_w, pos, 8)
        got.append(tg)
        want.append(tw)
        tok_g, tok_w = tg[:, -1].copy(), tw[:, -1].copy()
    got, want = np.concatenate(got, 1), np.concatenate(want, 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:2], meta['tokens'][0][:2, 1:17])
