"""The fused_bf16 decode window of the port (mr_mt3_tpu_torch.ops.
fused_decode) against the JAX fused_decode_window in its exact mode.

On the CPU the port's wrapper runs its plain PyTorch version (the CUDA
kernel is held against that version on the card by chip_smoke.py and
tests/test_torch_fused_decode_gpu.py); the JAX kernel runs in interpret
mode. The JAX kernel streams the self-K/V cache in chunks, which moves
its bf16 probability roundings; chunk_base = cache length gives it the
single-chunk softmax that the port computes.
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
from mr_mt3_tpu_torch.utils.checkpoint_import import state_dict_from_jax_params
from tests.parity_common import VANILLA_CFG, load_golden, parity_corpus
from tests.test_fused_decode import SMALL_CFG

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


def port_model(params, jax_cfg) -> MT3:
    cfg = MT3Config(**{f: getattr(jax_cfg, f)
                       for f in MT3Config.__dataclass_fields__})
    model = MT3(cfg).eval()
    model.load_state_dict(state_dict_from_jax_params(params, cfg))
    return model


class Pair:
    """One model on both sides: JAX exact-mode operands and the port's."""

    def __init__(self, params, jax_cfg, enc: np.ndarray, cache_len: int):
        self.cfg = jax_cfg
        self.cache_len = cache_len
        batch = enc.shape[0]
        self.dp_j = jax_fast.stack_decode_params(params, jax_cfg,
                                                 dtype=jnp.float32)
        self.fp_j = jax_fd.pack_fused_params(params, jax_cfg, exact=True)
        self.cross_j = jax_fd.precompute_cross_kv_fused(
            self.dp_j, jax_cfg, jnp.asarray(enc), exact=True)
        self.cache_j = jax_fd.init_fused_cache(jax_cfg, batch, cache_len,
                                               exact=True)
        self.model = port_model(params, jax_cfg)
        self.tcfg = self.model.cfg
        self.dp_t = stack_decode_params(self.model, quantize='fused_bf16')
        self.cross_t = fd.precompute_cross_kv_fused(
            self.dp_t, self.tcfg, torch.from_numpy(enc))
        self.cache_t = fd.init_fused_cache(self.tcfg, batch, cache_len,
                                           'cpu')

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
            self.cache_t, self.cross_t, t_window, return_logits=True)[4]
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


@pytest.fixture(scope='module')
def small():
    """SMALL_CFG with the JAX package's seed-0 init, 3 rows of seeded
    encoder states, a 16-row cache."""
    params = JaxMT3(SMALL_CFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
        decoder_input_ids=jnp.zeros((1, 4), jnp.int32))['params']
    enc = np.random.default_rng(0).normal(size=(3, 8, 32)).astype(
        np.float32)
    return params, enc


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
        from mr_mt3_tpu.infer import InferenceHandler
        jmodel = JaxMT3(VANILLA_CFG)
        handler = InferenceHandler(model=jmodel, variables={'params': params},
                                   max_length=16, batch_size=4)
        segments, _, valid = handler._audio_to_segments(parity_corpus()[0][0])
        mel = np.asarray(handler._compute_mel(segments, valid))[:2]
        enc = np.array(jmodel.apply({'params': params}, jnp.asarray(mel),
                                    method=JaxMT3.encode_audio))
        pair = Pair(params, VANILLA_CFG, enc, 16)
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
        cache = fd.init_fused_cache(cfg, 3, 8, 'cpu')
        tokens = torch.tensor([3, 77, 200])
        pos_rows = fd.window_pos_rows(dp, 0, 8)
        toks, _, _, _, logits = fd.fused_decode_window_reference(
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
        cache = fd.init_fused_cache(model.cfg, 3, 8, 'cpu')
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
        cache = fd.init_fused_cache(cfg, 3, 16, 'cpu')
        cache['kq'][..., :8] = 1.0
        tokens, fin = torch.tensor([3, 77, 200]), torch.zeros(3, dtype=bool)
        _, _, kw, vw = fd.fused_decode_window_reference(
            cfg, dp.fused, fd.window_pos_rows(dp, 8, 4), tokens, fin, 8,
            cache, cross, 4)
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
        cache = fd.init_fused_cache(model.cfg, 3, 8, 'cpu')
        with pytest.raises(ValueError, match='device'):
            fd.fused_decode_window(
                model.cfg, dp.fused, dp,
                torch.zeros(3, dtype=torch.int32, device='meta'),
                torch.zeros(3, dtype=bool, device='meta'), 0, cache, cross,
                t_window=8)
