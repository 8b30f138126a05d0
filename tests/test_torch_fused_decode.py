"""The decode window of the port (mr_mt3_tpu_torch.ops.fused_decode)
against the JAX fused_decode_window in its three modes: exact
(fused_bf16), int8 (fused) and int4 (fused_int4).

On the CPU the port's wrapper runs its plain PyTorch version (the CUDA
kernel is held against that version on the card by chip_smoke.py and
tests/test_torch_fused_decode_gpu.py); the JAX kernel runs in interpret
mode. The JAX kernel streams the self-K/V cache in chunks, which moves
its bf16 probability roundings; chunk_base = cache length gives it the
single-chunk softmax that the port computes (in the integer modes it
also decides the scale of the requantized probabilities).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mr_mt3_tpu.models import MT3 as JaxMT3
from mr_mt3_tpu.ops import fast_decode as jax_fast
from mr_mt3_tpu.ops import fused_decode as jax_fd
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.ops import fused_decode as fd
from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params
from mr_mt3_tpu_torch.ops.int8_matmul import (
    pack_int4,
    quantize_columns,
    unpack_int4,
)
from mr_mt3_tpu_torch.utils.checkpoint_import import state_dict_from_jax_params
from tests.parity_common import VANILLA_CFG, load_golden, parity_corpus
from tests.test_fused_decode import SMALL_CFG
from tests.torch_threads import two_torch_threads  # noqa: F401

# K/V rows are bf16: two f32 sums in different orders may round one bf16
# ulp (2^-8 relative) apart, and a flipped input moves the next layer's
# rows by about as much. Such flips stay rare at this size (the two sides
# agree bit for bit here today); a cast point moved would flip many.
KV_RTOL = 2e-2
KV_FLIP_SHARE = 0.05
# a token may differ from JAX's only where the plain version scores the
# two tokens within this fraction of the step's largest |logit| (both
# sides are f32 on the CPU: their logits agree to ~1e-5 relative)
MARGIN_RTOL = 1e-3

# The integer modes against JAX. Their integer dots are exact on both
# sides, but the f32 projections sum in another order (XLA's CPU dot vs
# torch's), so the two sides' f32 values differ by ~1e-7 relative from the
# first step. Now and then such a value sits at a rounding midpoint, and a
# bf16-rounded activation (or a requantized probability) lands one step
# apart (test_int_window_first_difference_is_a_rounding_tie); the next
# layer's K/V rows then move by up to ~1%, which moves a code by one step
# (int4: 1/7 of the row's max) or two (int8: 1/127), and later steps see
# it. Measured at SMALL_CFG over two chained 32-step windows, seeds 0-2:
# unequal codes at most 0.106% (int8) and 0.016% (int4) of entries, at
# most 2 (int8) and 1 (int4) apart, scales within 3.3e-3 and last-step
# logits within 6.4e-3 of the largest |value|, seed 1 (int8) and seed 2
# (int4) bit-exact (ROADMAP C). The bounds are about 3x those readings;
# the code differences are the readings, since a value that moves by
# less than one int4 step moves its code by at most one.
CODE_SHARE = {'fused': 0.997, 'fused_int4': 0.9995}
CODE_DIFF = {'fused': 2, 'fused_int4': 1}
SCALE_RTOL = 1e-2
INT_LOGIT_RTOL = 2e-2
INT_TIERS = ['fused', 'fused_int4']
_JAX_MODE = {'fused_bf16': dict(exact=True), 'fused': dict(wbits=8),
             'fused_int4': dict(wbits=4)}


def port_model(params, jax_cfg) -> MT3:
    cfg = MT3Config(**{f: getattr(jax_cfg, f)
                       for f in MT3Config.__dataclass_fields__})
    model = MT3(cfg).eval()
    model.load_state_dict(state_dict_from_jax_params(params, cfg))
    return model


def codes(t) -> np.ndarray:
    """Integer codes as int32: a port tensor (int4 unpacked) or a JAX
    array (ml_dtypes int4 cast through int8)."""
    if isinstance(t, torch.Tensor):
        return (unpack_int4(t) if t.dtype == torch.uint8 else t).numpy() \
            .astype(np.int32)
    return np.asarray(t).astype(np.int8).astype(np.int32)


class Pair:
    """One model on both sides: JAX operands of a tier and the port's."""

    def __init__(self, params, jax_cfg, enc: np.ndarray, cache_len: int,
                 tier: str = 'fused_bf16'):
        self.cfg = jax_cfg
        self.cache_len = cache_len
        self.tier = tier
        batch = enc.shape[0]
        mode = _JAX_MODE[tier]
        exact = tier == 'fused_bf16'
        self.dp_j = jax_fast.stack_decode_params(params, jax_cfg,
                                                 dtype=jnp.float32)
        self.fp_j = jax_fd.pack_fused_params(params, jax_cfg, **mode)
        self.cross_j = jax_fd.precompute_cross_kv_fused(
            self.dp_j, jax_cfg, jnp.asarray(enc), exact=exact,
            qmax=fd.QMAX.get(tier, 127))
        self.cache_j = jax_fd.init_fused_cache(
            jax_cfg, batch, cache_len, exact=exact,
            kv_dtype=jnp.int4 if tier == 'fused_int4' else None)
        self.model = port_model(params, jax_cfg)
        self.tcfg = self.model.cfg
        self.dp_t = stack_decode_params(self.model, quantize=tier)
        self.cross_t = fd.precompute_cross_kv_fused(
            self.dp_t, self.tcfg, torch.from_numpy(enc))
        self.cache_t = fd.init_fused_cache(self.tcfg, batch, cache_len,
                                           'cpu', tier)

    def jax_window(self, tokens, finished, pos, t_window):
        toks, fin, self.cache_j = jax_fd.fused_decode_window(
            self.cfg, self.fp_j, self.dp_j, jnp.asarray(tokens),
            jnp.asarray(finished), jnp.int32(pos), self.cache_j,
            self.cross_j, t_window=t_window, interpret=True,
            chunk_base=self.cache_len)
        return np.asarray(toks), np.asarray(fin)

    def port_window(self, tokens, finished, pos, t_window):
        """The port's wrapper; also the plain version's per-step logits
        on the same inputs (read before the wrapper writes the cache)."""
        pos_rows = fd.window_pos_rows(self.dp_t, pos, t_window)
        logits = fd.fused_decode_window_reference(
            self.tcfg, self.dp_t.fused, pos_rows,
            torch.from_numpy(tokens), torch.from_numpy(finished), pos,
            self.cache_t, self.cross_t, t_window, return_logits=True)[3]
        toks, fin, self.cache_t = fd.fused_decode_window(
            self.tcfg, self.dp_t.fused, self.dp_t, torch.from_numpy(tokens),
            torch.from_numpy(finished), pos, self.cache_t, self.cross_t,
            t_window=t_window)
        return toks.numpy(), fin.numpy(), logits.numpy()


def assert_tokens_agree(got, want, logits):
    """Rows equal up to a first divergence, allowed only at a near-tie of
    the plain version's scores for the two tokens. Returns the first
    diverging step per row (or the window length)."""
    last = []
    for b in range(want.shape[0]):
        diff = np.flatnonzero(got[b] != want[b])
        if len(diff):
            d = int(diff[0])
            row = logits[d, b]
            gap = abs(float(row[got[b, d]] - row[want[b, d]]))
            assert gap < MARGIN_RTOL * np.abs(row).max(), (
                f'row {b} diverges at step {d} with score gap {gap}')
        last.append(int(diff[0]) if len(diff) else want.shape[1])
    return last


def _parity_enc(params) -> np.ndarray:
    """Encoder states of the first two segments of the first parity song
    under the golden model (JAX)."""
    from mr_mt3_tpu.infer import InferenceHandler
    jmodel = JaxMT3(VANILLA_CFG)
    handler = InferenceHandler(model=jmodel, variables={'params': params},
                               max_length=16, batch_size=4)
    segments, _, valid = handler._audio_to_segments(parity_corpus()[0][0])
    mel = np.asarray(handler._compute_mel(segments, valid))[:2]
    return np.array(jmodel.apply({'params': params}, jnp.asarray(mel),
                                 method=JaxMT3.encode_audio))


def _small_inputs(seed: int):
    """SMALL_CFG with the JAX package's init of this seed and 3 rows of
    encoder states (Lenc 8) from a numpy generator of the same seed."""
    params = JaxMT3(SMALL_CFG).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, 16)),
        decoder_input_ids=jnp.zeros((1, 4), jnp.int32))['params']
    enc = np.random.default_rng(seed).normal(size=(3, 8, 32)).astype(
        np.float32)
    return params, enc


@pytest.fixture(scope='module')
def small():
    """_small_inputs(0)."""
    return _small_inputs(0)


class TestPacking:
    def test_operands_match_jax_exact_mode(self, small):
        """Packed bf16 weights are bit-equal to the JAX package's; the
        bf16 cross K/V agree to within one bf16 rounding."""
        params, enc = small
        pair = Pair(params, SMALL_CFG, enc, 16)
        fp_t, fp_j = pair.dp_t.fused, pair.fp_j
        for name in ('wqkv', 'wo', 'wqc', 'woc', 'wff_in', 'wff_out',
                     'norms'):
            np.testing.assert_array_equal(
                getattr(fp_t, name).float().numpy(),
                np.asarray(getattr(fp_j, name), np.float32), name)
        np.testing.assert_array_equal(fp_t.lm.float().numpy(),
                                      np.asarray(fp_j.lm_q, np.float32))
        np.testing.assert_array_equal(fp_t.final_norm.numpy(),
                                      np.asarray(fp_j.final_norm)[0])
        np.testing.assert_array_equal(
            fp_t.embed.float().numpy(),
            np.asarray(jnp.asarray(pair.dp_j.token_embed, jnp.bfloat16),
                       np.float32))
        for key in ('ckq', 'cvq'):
            a = pair.cross_t[key].float().numpy()
            b = np.asarray(pair.cross_j[key], np.float32)
            np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=1e-6)
        assert pair.cache_t['kq'].shape == pair.cache_j['kq'].shape
        assert pair.cache_t['kq'].dtype == torch.bfloat16


    @pytest.mark.parametrize('tier', INT_TIERS)
    def test_int_operands_match_jax(self, small, tier):
        """Integer tiers: the packed weight codes (int4 unpacked) equal
        JAX's pack_fused_params(wbits=8|4), the column scales agree within
        1e-6 relative, and the cache takes the tier's layout."""
        params, enc = small
        pair = Pair(params, SMALL_CFG, enc, 16, tier)
        fp_t, fp_j = pair.dp_t.fused, pair.fp_j
        assert fd.fused_tier(fp_t) == tier
        for (name, sname), jname, jsname in zip(
                fd._WEIGHTS, ('wqkv', 'wo', 'wqc', 'woc', 'wff_in',
                              'wff_out', 'lm_q'),
                ('sqkv', 'so', 'sqc', 'soc', 'sff_in', 'sff_out', 'lm_s')):
            np.testing.assert_array_equal(
                codes(getattr(fp_t, name)), codes(getattr(fp_j, jname)),
                name)
            want = np.asarray(getattr(fp_j, jsname)).reshape(
                getattr(fp_t, sname).shape)
            np.testing.assert_allclose(getattr(fp_t, sname).numpy(), want,
                                       rtol=1e-6, err_msg=sname)
        np.testing.assert_array_equal(fp_t.norms.numpy(),
                                      np.asarray(fp_j.norms))
        per_byte = 2 if tier == 'fused_int4' else 1
        L, H, B, dk = 2, 4, 3, 8
        assert pair.cache_t['kq'].shape == (L, H, B, dk, 16 // per_byte)
        assert pair.cache_t['ks'].shape == pair.cache_j['ks'].shape

    @pytest.mark.parametrize('tier', INT_TIERS)
    def test_cross_kv_quantization_matches_jax(self, small, tier):
        """precompute_cross_kv_fused on one shared f32 K/V tensor (the
        cross k kernels set to the identity and the v kernels to twice it,
        so both sides' K/V equal the encoder states exactly): identical
        codes and per-position scales within 1e-6 relative."""
        params, enc = small
        eye = np.eye(SMALL_CFG.d_model, dtype=np.float32)
        dec = {**params['decoder']}
        for i in range(SMALL_CFG.num_decoder_layers):
            blk = {**dec[f'block_{i}']}
            cross = {**blk['cross_attn'], 'k': {'kernel': jnp.asarray(eye)},
                     'v': {'kernel': jnp.asarray(2 * eye)}}
            dec[f'block_{i}'] = {**blk, 'cross_attn': cross}
        pair = Pair({**params, 'decoder': dec}, SMALL_CFG, enc, 16, tier)
        for key in ('ckq', 'cvq'):
            np.testing.assert_array_equal(codes(pair.cross_t[key]),
                                          codes(pair.cross_j[key]), key)
        for key in ('cks', 'cvs'):
            np.testing.assert_allclose(pair.cross_t[key].numpy(),
                                       np.asarray(pair.cross_j[key]),
                                       rtol=1e-6, err_msg=key)


class TestIntQuantizers:
    @pytest.mark.parametrize('qmax', [127, 7])
    def test_zero_columns_and_rows_floor_the_scale(self, qmax):
        """An all-zero column (or K/V row) gets the 1e-12 scale floor and
        code 0, never a NaN; a ±max column maps to ±qmax."""
        w = torch.zeros((4, 3))
        w[:, 1] = torch.tensor([1.0, -2.0, 0.5, 2.0])
        c, s = quantize_columns(w, qmax)
        assert torch.isfinite(s).all()
        assert float(s[0]) == pytest.approx(1e-12 / qmax)
        assert (c[:, 0] == 0).all() and (c[:, 2] == 0).all()
        assert int(c[1, 1]) == -qmax and int(c[3, 1]) == qmax
        rc, rs = fd.quantize_rows(torch.zeros((2, 8)), qmax)
        assert (rc == 0).all() and torch.isfinite(rs).all()

    def test_round_half_to_even(self):
        """Ties round to the even code, as jnp.round does: 0.5 -> 0,
        1.5 -> 2, 2.5 -> 2 at scale 1."""
        w = torch.tensor([[0.5, 1.5, 2.5, -2.5, 7.0]])
        c, _ = quantize_columns(torch.cat([w, torch.full_like(w, 7.0)]), 7)
        assert c[0].tolist() == [0, 2, 2, -2, 7]

    def test_int4_pack_round_trip(self):
        """Two codes per byte along the last axis, low nibble first."""
        c = torch.arange(-7, 8, dtype=torch.int8).repeat(2)[:-2].reshape(
            2, 14)
        packed = pack_int4(c)
        assert packed.dtype == torch.uint8 and packed.shape == (2, 7)
        assert int(packed[0, 0]) == ((-7) & 0xF) | (((-6) & 0xF) << 4)
        assert torch.equal(unpack_int4(packed), c)


class TestWindowAgainstJax:
    def test_two_chained_windows_small_config(self, small):
        """Windows at positions 0 and 8 (the second reads the cache rows
        the first wrote): tokens, finished flags and K/V cache rows. Row
        2 starts finished and must emit only pad."""
        params, enc = small
        pair = Pair(params, SMALL_CFG, enc, 16)
        tokens = np.array([3, 77, 5], np.int32)
        finished = np.array([False, False, True])
        toks_j, toks_t, logits = [], [], []
        fin_j, fin_t = finished, finished
        for pos in (0, 8):
            tj, fin_j = pair.jax_window(tokens, fin_j, pos, 8)
            tt, fin_t, lg = pair.port_window(tokens, fin_t, pos, 8)
            toks_j.append(tj)
            toks_t.append(tt)
            logits.append(lg)
            tokens = tj[:, -1].copy()
        got, want = np.concatenate(toks_t, 1), np.concatenate(toks_j, 1)
        last = assert_tokens_agree(got, want, np.concatenate(logits, 0))
        assert (got[2] == SMALL_CFG.pad_token_id).all()
        assert bool(fin_t[2]) and bool(fin_j[2])
        if min(last) == 16:
            np.testing.assert_array_equal(fin_t, fin_j)
        for key in ('kq', 'vq'):
            a = pair.cache_t[key].float().numpy()
            b = np.asarray(pair.cache_j[key], np.float32)
            scale = np.abs(b).max()
            for row, n in enumerate(last):
                err = np.abs(a[:, :, row, :, :n] - b[:, :, row, :, :n])
                assert err.max() <= KV_RTOL * scale, (key, row)
                assert (err > 0).mean() <= KV_FLIP_SHARE, (key, row)

    def test_confident_model_two_windows_identical(self):
        """On the overfit parity model (decode margins ~2.0) two chained
        windows of 8 give identical tokens on both sides, equal to the
        golden transcription's first 16 tokens."""
        params, meta = load_golden('parity_vanilla.npz')
        pair = Pair(params, VANILLA_CFG, _parity_enc(params), 16)
        tokens = np.zeros(2, np.int32)
        fin_j = fin_t = np.zeros(2, bool)
        got, want = [], []
        for pos in (0, 8):
            tj, fin_j = pair.jax_window(tokens, fin_j, pos, 8)
            tt, fin_t, _ = pair.port_window(tokens, fin_t, pos, 8)
            want.append(tj)
            got.append(tt)
            tokens = tt[:, -1].copy()
        got, want = np.concatenate(got, 1), np.concatenate(want, 1)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, meta['tokens'][0][:2, 1:17])
        np.testing.assert_array_equal(fin_t, fin_j)


    @staticmethod
    def _two_int_windows(params, enc, tier, monkeypatch):
        """Integer tiers, windows at positions 0 and 32 of a 64-row cache
        (the second reads the codes and scales the first wrote): identical
        tokens; cache codes, cache scales and each window's last-step
        logits within the bounds above. JAX's logits are read out of its
        lm_head projection inside the interpreted kernel."""
        recorded = []
        helpers = jax_fd._math_helpers

        def recording_helpers(cfg, batch, exact=False, qmax=127):
            out = list(helpers(cfg, batch, exact=exact, qmax=qmax))
            proj = out[2]

            def int8_proj(h, w, s):
                y = proj(h, w, s)
                if w.shape[-1] == cfg.vocab_size:
                    jax.debug.callback(
                        lambda v: recorded.append(np.asarray(v)), y)
                return y
            out[2] = int8_proj
            return tuple(out)

        monkeypatch.setattr(jax_fd, '_math_helpers', recording_helpers)
        pair = Pair(params, SMALL_CFG, enc, 64, tier)
        tokens = np.array([3, 77, 5], np.int32)
        fin_j = fin_t = np.array([False, False, True])
        for pos in (0, 32):
            recorded.clear()
            tj, fin_j = pair.jax_window(tokens, fin_j, pos, 32)
            tt, fin_t, logits = pair.port_window(tokens, fin_t, pos, 32)
            np.testing.assert_array_equal(tt, tj)
            want = recorded[-1]
            err = np.abs(logits[-1] - want).max() / np.abs(want).max()
            print(f'{tier} window at {pos}: last-step logits within '
                  f'{err:.3g}')
            assert err <= INT_LOGIT_RTOL, (pos, err)
            tokens = tj[:, -1].copy()
        np.testing.assert_array_equal(fin_t, fin_j)
        assert (tt[2] == SMALL_CFG.pad_token_id).all()
        for key in ('kq', 'vq'):
            a, b = codes(pair.cache_t[key]), codes(pair.cache_j[key])
            print(f'{tier} {key}: codes unequal in {(a != b).mean():.4%}, '
                  f'at most {np.abs(a - b).max()} apart')
            assert (a == b).mean() >= CODE_SHARE[tier], key
            assert np.abs(a - b).max() <= CODE_DIFF[tier], key
        for key in ('ks', 'vs'):
            a = pair.cache_t[key].numpy()
            b = np.asarray(pair.cache_j[key])
            err = np.abs(a - b).max() / np.abs(b).max()
            print(f'{tier} {key}: scales within {err:.3g}')
            assert err <= SCALE_RTOL, key

    @pytest.mark.parametrize('tier', INT_TIERS)
    def test_int_modes_two_chained_windows(self, small, tier, monkeypatch):
        """Two chained integer windows on the seed-0 model (see
        _two_int_windows)."""
        params, enc = small
        self._two_int_windows(params, enc, tier, monkeypatch)

    @pytest.mark.parametrize('tier', INT_TIERS)
    @pytest.mark.parametrize('seed', [1, 2])
    def test_int_modes_two_chained_windows_other_seeds(self, tier, seed,
                                                       monkeypatch):
        """The same on the JAX package's seed-1 and seed-2 inits with
        encoder states of the same seed: the bounds hold beyond seed 0."""
        self._two_int_windows(*_small_inputs(seed), tier, monkeypatch)

    @pytest.mark.parametrize('tier,seed', [('fused', 2), ('fused_int4', 0)])
    def test_int_window_first_difference_is_a_rounding_tie(self, tier,
                                                           seed,
                                                           monkeypatch):
        """Why the integer windows differ from JAX's at all. One window at
        position 0, on a seed where the two sides part inside it: every
        bf16 rounding of an activation (the inputs of the projections and
        of lm_head) and every requantized cross-attention q and probability
        code is equal up to the first bf16 rounding that differs, and that
        rounding's f32 input lies within 1% of a bf16 step of the rounding
        midpoint: a tie that the two sides' f32 sum orders (~1e-7 apart)
        break differently."""
        params, enc = _small_inputs(seed)
        lenc = enc.shape[1]
        jax_h, jax_codes = [], []
        helpers = jax_fd._math_helpers
        qmax_cross = 127                  # q and p stay int8 in every tier

        def requant(x, floor):            # (rows, n) -> int8 codes
            s = np.maximum(np.abs(x).max(-1, keepdims=True), floor) / 127
            return np.clip(np.round(x / s), -qmax_cross, qmax_cross)

        def recording_helpers(cfg, batch, exact=False, qmax=127):
            out = list(helpers(cfg, batch, exact=exact, qmax=qmax))
            scores, values, proj = out[0], out[1], out[2]

            def rec(store, v):
                jax.debug.callback(
                    lambda a: store.append(np.asarray(a, np.float32)), v)

            def scores2(q, kq, ks):
                if kq.shape[-1] == lenc:          # the cross-attention
                    rec(jax_codes, q)
                return scores(q, kq, ks)

            def values2(p, vq, vs):
                if vq.shape[-1] == lenc:
                    rec(jax_codes, p * vs)
                return values(p, vq, vs)

            def proj2(h, w, s):
                rec(jax_h, h)
                return proj(h, w, s)
            out[0], out[1], out[2] = scores2, values2, proj2
            return tuple(out)

        monkeypatch.setattr(jax_fd, '_math_helpers', recording_helpers)
        pair = Pair(params, SMALL_CFG, enc, 32, tier)
        tokens = np.array([3, 77, 5], np.int32)
        finished = np.array([False, False, True])
        pair.jax_window(tokens, finished, 0, 32)

        port_h, port_codes = [], []
        bf16r, int_scores, int_values = fd._bf16r, fd._int_scores, \
            fd._int_values

        def bf16_recording(x):
            port_h.append(x.numpy().copy())
            return bf16r(x)

        def scores_recording(q, c, s):
            port_codes.append(q.numpy().copy())
            return int_scores(q, c, s)

        def values_recording(p, c, s):
            port_codes.append((p * s.transpose(0, 1)).numpy())
            return int_values(p, c, s)
        monkeypatch.setattr(fd, '_bf16r', bf16_recording)
        monkeypatch.setattr(fd, '_int_scores', scores_recording)
        monkeypatch.setattr(fd, '_int_values', values_recording)
        fd.fused_decode_window_reference(
            pair.tcfg, pair.dp_t.fused, fd.window_pos_rows(pair.dp_t, 0, 32),
            torch.from_numpy(tokens), torch.from_numpy(finished), 0,
            pair.cache_t, pair.cross_t, 32)
        # both sides run the same roundings in the same order: per step
        # and layer the inputs of wqkv, wo, wqc, woc, wff_in, wff_out, then
        # lm_head; q then p of the cross-attention (rows h*B + b in JAX)
        assert len(jax_h) == len(port_h) and \
            len(jax_codes) == len(port_codes)
        first = None
        for i, (jh, ph) in enumerate(zip(jax_h, port_h)):
            rounded = ph.astype(np.float32)
            rounded = torch.from_numpy(rounded).to(torch.bfloat16).float() \
                .numpy()
            if not np.array_equal(rounded, jh):
                first = i
                break
        assert first is not None, 'the two sides never part on this seed'
        per_step = len(jax_h) // 32
        step = first // per_step
        layers = SMALL_CFG.num_decoder_layers
        for i in range(2 * layers * step):       # q, p per earlier layer
            jq = jax_codes[i]
            pq = port_codes[i].transpose(1, 0, 2).reshape(jq.shape)
            floor = 1e-12 if i % 2 == 0 else 1e-20
            np.testing.assert_array_equal(requant(pq, floor),
                                          requant(jq, floor))
        x = port_h[first]
        row, col = np.argwhere(torch.from_numpy(x).to(torch.bfloat16)
                               .float().numpy() != jax_h[first])[0]
        v = float(x[row, col])
        ulp = 2.0 ** (np.floor(np.log2(abs(v))) - 7)   # bf16 spacing at v
        midpoint = (np.floor(v / ulp) + 0.5) * ulp
        print(f'{tier} seed {seed}: first rounding apart at step {step}, '
              f'rounding {first % per_step} of the step, f32 {v!r}, '
              f'{abs(v - midpoint) / ulp:.3g} of a bf16 step from the '
              f'midpoint; JAX {float(jax_h[first][row, col])!r}')
        assert abs(v - midpoint) < 1e-2 * ulp, (
            step, first % per_step, v, abs(v - midpoint) / ulp)

    @pytest.mark.parametrize('tier', INT_TIERS)
    def test_int_modes_confident_model_identical(self, tier):
        """On the overfit parity model two chained windows of 8 give
        identical tokens on both sides in each integer tier, equal to the
        golden transcription's first 16 tokens."""
        params, meta = load_golden('parity_vanilla.npz')
        pair = Pair(params, VANILLA_CFG, _parity_enc(params), 16, tier)
        tokens = np.zeros(2, np.int32)
        fin_j = fin_t = np.zeros(2, bool)
        got, want = [], []
        for pos in (0, 8):
            tj, fin_j = pair.jax_window(tokens, fin_j, pos, 8)
            tt, fin_t, _ = pair.port_window(tokens, fin_t, pos, 8)
            want.append(tj)
            got.append(tt)
            tokens = tt[:, -1].copy()
        got, want = np.concatenate(got, 1), np.concatenate(want, 1)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, meta['tokens'][0][:2, 1:17])


class TestWindowSemantics:
    def _model(self, params):
        return port_model(params, SMALL_CFG)

    def test_argmax_ties_pick_the_lowest_index(self, small):
        """lm_head rows 5 and 9 equal w, rows 7 and 11 equal -w, all others
        zero: the largest logit is attained twice, at 5 and 9 or at 7 and
        11, and the window must emit the lower index of the pair."""
        params, enc = small
        model = self._model(params)
        w = torch.from_numpy(np.random.default_rng(4).normal(
            size=SMALL_CFG.d_model).astype(np.float32))
        with torch.no_grad():
            model.lm_head.weight.zero_()
            model.lm_head.weight[5] = model.lm_head.weight[9] = w
            model.lm_head.weight[7] = model.lm_head.weight[11] = -w
        dp = stack_decode_params(model, quantize='fused_bf16')
        cfg = model.cfg
        cross = fd.precompute_cross_kv_fused(dp, cfg, torch.from_numpy(enc))
        cache = fd.init_fused_cache(cfg, 3, 8, 'cpu', 'fused_bf16')
        tokens = torch.tensor([3, 77, 200])
        pos_rows = fd.window_pos_rows(dp, 0, 8)
        toks, _, _, logits = fd.fused_decode_window_reference(
            cfg, dp.fused, pos_rows, tokens, torch.zeros(3, dtype=bool), 0,
            cache, cross, 8, return_logits=True)
        for t in range(8):
            for b in range(3):
                row = logits[t, b]
                top = torch.nonzero(row == row.max()).flatten().tolist()
                assert top in ([5, 9], [7, 11]), top
                assert int(toks[t, b]) == top[0]

    def test_argmax_lowest(self):
        x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [-1.0, -1.0, -2.0, -1.0],
                          [1.0, float('nan'), 3.0, 2.0]])
        assert fd.argmax_lowest(x).tolist() == [1, 0, 4]

    def test_nan_logits_match_jax_and_raise(self, small):
        """A NaN in lm_head column 7 makes every logit row hold a NaN: both
        the JAX kernel and the plain version emit the vocabulary size (the
        max is NaN, so no index equals it), embed that token as zeros and
        go on doing so; a finished row still emits pad. The port's wrapper
        raises instead of handing such tokens on."""
        params, enc = small
        lm = np.array(params['lm_head']['kernel'])
        lm[:, 7] = np.nan
        params = {**params, 'lm_head': {'kernel': jnp.asarray(lm)}}
        pair = Pair(params, SMALL_CFG, enc, 16)
        tokens = np.array([3, 77, 5], np.int32)
        finished = np.array([False, False, True])
        want, _ = pair.jax_window(tokens, finished, 0, 8)
        got = fd.fused_decode_window_reference(
            pair.tcfg, pair.dp_t.fused, fd.window_pos_rows(pair.dp_t, 0, 8),
            torch.from_numpy(tokens), torch.from_numpy(finished), 0,
            pair.cache_t, pair.cross_t, 8)[0].numpy().T
        np.testing.assert_array_equal(got, want)
        assert (got[:2] == SMALL_CFG.vocab_size).all()
        assert (got[2] == SMALL_CFG.pad_token_id).all()
        with pytest.raises(FloatingPointError, match='NaN'):
            pair.port_window(tokens, finished, 0, 8)

    def test_eos_finishes_and_pads(self, small):
        """A row whose argmax is EOS finishes there and emits pad after:
        lm_head scores EOS highest for every input."""
        params, enc = small
        model = self._model(params)
        with torch.no_grad():
            # x = embed + pos with a dominant positive component d0 (no
            # layer writes the residual: every output projection is zero)
            for blk in model.decoder.block:
                for lin in (blk.self_attn.o, blk.cross_attn.o, blk.ff.wo):
                    lin.weight.zero_()
            model.decoder_embed_tokens.weight[:, 0] = 50.0
            model.decoder.final_layer_norm.weight.zero_()
            model.decoder.final_layer_norm.weight[0] = 1.0
            model.lm_head.weight.zero_()
            model.lm_head.weight[SMALL_CFG.eos_token_id, 0] = 1.0
        dp = stack_decode_params(model, quantize='fused_bf16')
        cross = fd.precompute_cross_kv_fused(dp, model.cfg,
                                             torch.from_numpy(enc))
        cache = fd.init_fused_cache(model.cfg, 3, 8, 'cpu',
                                     'fused_bf16')
        toks, fin, _ = fd.fused_decode_window(
            model.cfg, dp.fused, dp, torch.tensor([3, 77, 200]),
            torch.zeros(3, dtype=bool), 0, cache, cross, t_window=8)
        assert toks[:, 0].tolist() == [SMALL_CFG.eos_token_id] * 3
        assert (toks[:, 1:] == SMALL_CFG.pad_token_id).all()
        assert fin.all()

    def test_window_rows_land_in_the_cache(self, small):
        """The wrapper scatters the window's K/V rows into cache positions
        pos..pos+T-1 and leaves the other positions alone."""
        params, enc = small
        model = self._model(params)
        dp = stack_decode_params(model, quantize='fused_bf16')
        cfg = model.cfg
        cross = fd.precompute_cross_kv_fused(dp, cfg, torch.from_numpy(enc))
        cache = fd.init_fused_cache(cfg, 3, 16, 'cpu', 'fused_bf16')
        cache['kq'][..., :8] = 1.0
        tokens, fin = torch.tensor([3, 77, 200]), torch.zeros(3, dtype=bool)
        _, _, rows = fd.fused_decode_window_reference(
            cfg, dp.fused, fd.window_pos_rows(dp, 8, 4), tokens, fin, 8,
            cache, cross, 4)
        kw, vw = rows['kq'], rows['vq']
        fd.fused_decode_window(cfg, dp.fused, dp, tokens, fin, 8, cache,
                               cross, t_window=4)
        L, H, B, dk = cfg.num_decoder_layers, cfg.num_heads, 3, cfg.d_kv
        want = kw.reshape(4, L, H, B, dk).permute(1, 2, 3, 4, 0)
        assert torch.equal(cache['kq'][..., 8:12], want)
        assert torch.equal(cache['vq'][..., 8:12],
                           vw.reshape(4, L, H, B, dk).permute(1, 2, 3, 4, 0))
        assert (cache['kq'][..., :8] == 1.0).all()
        assert (cache['kq'][..., 12:] == 0).all()

    def test_no_quiet_fallback_off_the_cpu(self, small):
        """A tensor that is neither on the CPU nor on a card raises; the
        wrapper never reroutes it to the plain version."""
        params, enc = small
        model = self._model(params)
        dp = stack_decode_params(model, quantize='fused_bf16')
        cross = fd.precompute_cross_kv_fused(dp, model.cfg,
                                             torch.from_numpy(enc))
        cache = fd.init_fused_cache(model.cfg, 3, 8, 'cpu',
                                     'fused_bf16')
        with pytest.raises(ValueError, match='device'):
            fd.fused_decode_window(
                model.cfg, dp.fused, dp,
                torch.zeros(3, dtype=torch.int32, device='meta'),
                torch.zeros(3, dtype=bool, device='meta'), 0, cache, cross,
                t_window=8)
