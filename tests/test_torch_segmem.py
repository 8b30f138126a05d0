"""The MR-MT3 segment memory in the port (device='cpu') against the JAX
package on the same weights: the memory encoder, encode and teacher-forced
logits (fp32, and bf16 with attention_kernel='fused' on both sides), the
weights bridge, the decode seed, the memory-chain decode and its options,
the contiguous parity goldens in every tier, the chained non-contiguous
handler path, the probe's margins and flip classification, the ladder and
the prewarm's chain buckets."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mr_mt3_tpu.infer import InferenceHandler as JaxHandler
from mr_mt3_tpu.infer import probe as jax_probe
from mr_mt3_tpu.models import MT3 as JaxMT3
from mr_mt3_tpu.ops import decode as jax_decode
from mr_mt3_tpu.utils.checkpoint_import import export_to_torch_state_dict
from mr_mt3_tpu_torch import serve
from mr_mt3_tpu_torch.infer import InferenceHandler
from mr_mt3_tpu_torch.infer import probe as probe_mod
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.ops import decode
from mr_mt3_tpu_torch.utils.checkpoint_import import (
    load_torch_checkpoint,
    state_dict_from_jax_params,
)
from tests.parity_common import (
    MAX_LENGTH,
    V1_CFG,
    WITHPREV_CFG,
    load_golden,
    parity_corpus,
)
from tests.test_inference import SMALL
from tests.torch_threads import two_torch_threads  # noqa: F401

# fp32 on both sides; the frameworks sum in other orders
F32_RTOL = 1e-5
# bf16 activations: the two frameworks round their matmul outputs to bf16
# after sums in other orders, so an activation may land one bf16 ulp
# apart, and the next layers see it. Read on the parity models at L 512:
# 1.28% / 1.32% of the largest logit, argmax equal at 99.2% / 99.3%
BF16_LOGIT_RTOL = 3e-2
BF16_ARGMAX_EQUAL = 0.975


def torch_cfg(jax_cfg, **kw) -> MT3Config:
    return MT3Config(**{f: getattr(jax_cfg, f)
                        for f in MT3Config.__dataclass_fields__}).replace(
        **kw)


def port_model(params, jax_cfg, **kw) -> MT3:
    model = MT3(torch_cfg(jax_cfg, **kw)).eval()
    model.load_state_dict(state_dict_from_jax_params(params, model.cfg),
                          strict=True)
    return model


@pytest.fixture(scope='module')
def withprev():
    params, meta = load_golden('parity_withprev.npz')
    return params, meta, port_model(params, WITHPREV_CFG)


@pytest.fixture(scope='module')
def v1():
    params, meta = load_golden('parity_v1.npz')
    return params, meta, port_model(params, V1_CFG)


SMALL_SEGMEM = SMALL.replace(segmem_variant='encoder_append',
                             segmem_length=8)


@pytest.fixture(scope='module')
def small():
    """A random-init JAX segmem model (tests/test_inference.py's) and its
    port twin."""
    params = JaxMT3(SMALL_SEGMEM).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 256, 512)),
        decoder_input_ids=jnp.zeros((1, 4), jnp.int32),
        targets_prev=jnp.zeros((1, 4), jnp.int32))['params']
    params = jax.device_get(params)
    return params, port_model(params, SMALL_SEGMEM)


def _mel(seed, n, bins=512):
    return (np.random.default_rng(seed).normal(size=(n, 256, bins))
            * 0.5).astype(np.float32)


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


class TestModel:
    @pytest.mark.parametrize('golden', ['withprev', 'v1'])
    def test_f32_segmem_encode_and_logits_match_jax(self, golden, request):
        params, _, model = request.getfixturevalue(golden)
        jcfg = WITHPREV_CFG if golden == 'withprev' else V1_CFG
        jm = JaxMT3(jcfg)
        v = {'params': params}
        rng = np.random.default_rng(5)
        mel = _mel(6, 2, jcfg.mel_bins)
        ids = rng.integers(3, jcfg.vocab_size, size=(2, 40)).astype(np.int32)
        ids[:, 0] = 0
        prev = rng.integers(3, jcfg.vocab_size, size=(2, 40)).astype(
            np.int32)
        prev[0, 30:] = -100
        with torch.no_grad():
            mem = model.compute_segmem(torch.from_numpy(prev)).numpy()
            logits = model(torch.from_numpy(mel), torch.from_numpy(ids),
                           targets_prev=torch.from_numpy(prev)).numpy()
            internal = model(torch.from_numpy(mel),
                             torch.from_numpy(ids)).numpy()
        want_mem = np.asarray(jm.apply(v, jnp.asarray(prev),
                                       method=JaxMT3.compute_segmem))
        assert mem.shape == (2, jcfg.segmem_length, jcfg.d_model)
        _close(mem, want_mem, F32_RTOL)
        _close(logits, np.asarray(jm.apply(
            v, jnp.asarray(mel), decoder_input_ids=jnp.asarray(ids),
            targets_prev=jnp.asarray(prev))), F32_RTOL)
        _close(internal, np.asarray(jm.apply(
            v, jnp.asarray(mel), decoder_input_ids=jnp.asarray(ids))),
            F32_RTOL)
        if golden == 'withprev':
            with torch.no_grad():
                enc = model.encode(torch.from_numpy(mel),
                                   torch.from_numpy(prev)).numpy()
            assert enc.shape[1] == 256 + jcfg.segmem_length
            _close(enc, np.asarray(jm.apply(
                v, jnp.asarray(mel), jnp.asarray(prev),
                method=JaxMT3.encode)), F32_RTOL)

    @pytest.mark.parametrize('golden', ['withprev', 'v1'])
    def test_bf16_fused_attention_logits_match_jax(self, golden, request):
        """L = 512 at bf16 with attention_kernel='fused' on both sides:
        the memory encoder and the decoder's causal self- and cross-
        attention take the kernel (the JAX one interpreted, the port's
        plain version)."""
        params, _, _ = request.getfixturevalue(golden)
        jcfg = (WITHPREV_CFG if golden == 'withprev' else V1_CFG).replace(
            dtype='bfloat16', attention_kernel='fused')
        model = port_model(params, jcfg)
        rng = np.random.default_rng(7)
        mel = _mel(8, 2, jcfg.mel_bins)
        ids = rng.integers(3, jcfg.vocab_size, size=(2, 512)).astype(
            np.int32)
        ids[:, 0] = 0
        with torch.no_grad():
            got = model(torch.from_numpy(mel), torch.from_numpy(ids)).float()
        want = np.asarray(JaxMT3(jcfg).apply(
            {'params': params}, jnp.asarray(mel),
            decoder_input_ids=jnp.asarray(ids)), np.float32)
        _close(got.numpy(), want, BF16_LOGIT_RTOL)
        assert np.mean(got.numpy().argmax(-1) == want.argmax(-1)) >= \
            BF16_ARGMAX_EQUAL


class TestWeightsBridge:
    def test_segmem_encoder_round_trips(self, withprev):
        params, _, model = withprev
        theirs = export_to_torch_state_dict(params, WITHPREV_CFG)
        mine = state_dict_from_jax_params(params, model.cfg)
        assert any(k.startswith('segmem_encoder.') for k in mine)
        assert set(mine) == set(theirs) == set(model.state_dict())
        for key, value in theirs.items():
            np.testing.assert_array_equal(mine[key].numpy(), value, key)

    def test_reference_checkpoint_keeps_the_memory_encoder(self, withprev,
                                                           tmp_path):
        """A reference .pth carries segmem_encoder.* (loaded) and the
        vestigial segmem_proj.weight (skipped)."""
        _, _, model = withprev
        blob = dict(model.state_dict())
        blob['segmem_proj.weight'] = torch.zeros(4, 4)
        blob['segmem_encoder.embed_tokens.weight'] = torch.zeros(3, 3)
        path = tmp_path / 'withprev.pth'
        torch.save(blob, path)
        loaded = load_torch_checkpoint(str(path))
        assert 'segmem_proj.weight' not in loaded
        twin = MT3(model.cfg)
        twin.load_state_dict(loaded, strict=True)
        for key, value in model.state_dict().items():
            assert torch.equal(twin.state_dict()[key], value), key


class TestSeed:
    @pytest.mark.parametrize('seed', ['tie_eos', 'eos'])
    def test_equals_jax(self, seed):
        jcfg = SMALL_SEGMEM.replace(segmem_seed=seed)
        got = decode.initial_segmem_tokens(torch_cfg(jcfg), 2, 8).numpy()
        want = np.asarray(jax_decode.initial_segmem_tokens(jcfg, 2, 8))
        np.testing.assert_array_equal(got, want)
        assert list(got[0, :3]) == ([1134, 1, 0] if seed == 'tie_eos'
                                    else [1, 0, 0])

    def test_custom_vocabulary_moves_the_tie_id(self):
        from mr_mt3_tpu_torch.codec import (
            VocabularyConfig,
            build_codec,
            vocabulary_from_codec,
        )
        codec = build_codec(VocabularyConfig(num_velocity_bins=127))
        got = decode.initial_segmem_tokens(
            torch_cfg(SMALL_SEGMEM), 1, 8, codec=codec,
            vocab=vocabulary_from_codec(codec)).numpy()
        assert got[0, 0] != 1134 and list(got[0, 1:3]) == [1, 0]


class TestChainDecode:
    @pytest.mark.parametrize('kw', [
        {}, {'chain_memory': False}, {'memory_format': 'train_aligned'},
        {'oracle': True}], ids=['chain', 'no_chain', 'train_aligned',
                                'oracle'])
    def test_equals_jax(self, small, kw):
        params, model = small
        mel = _mel(11, 6).reshape(2, 3, 256, 512)
        kw = dict(kw)
        if kw.pop('oracle', False):
            kw['oracle_memory'] = np.random.default_rng(12).integers(
                3, 1389, size=(2, 3, 24)).astype(np.int32)
        want = np.asarray(jax_decode.segmem_greedy_decode(
            JaxMT3(SMALL_SEGMEM), {'params': params}, jnp.asarray(mel),
            max_length=24, **{k: jnp.asarray(v) if k == 'oracle_memory'
                              else v for k, v in kw.items()}))
        got = decode.segmem_greedy_decode(
            model, torch.from_numpy(mel), max_length=24,
            **{k: torch.from_numpy(v) if k == 'oracle_memory' else v
               for k, v in kw.items()}).numpy()
        assert got.shape == (2, 3, 25)
        np.testing.assert_array_equal(got, want)

    def test_unknown_format_and_v1_quantize_raise(self, small, v1):
        mel = torch.zeros((1, 1, 256, 512))
        with pytest.raises(ValueError, match='memory_format'):
            decode.segmem_greedy_decode(small[1], mel, 4,
                                        memory_format='shifted')
        with pytest.raises(ValueError, match='decoder_prepend'):
            decode.segmem_greedy_decode(v1[2], mel[..., :96], 4,
                                        quantize='fused_bf16')


GOLDEN_TIERS = ['none', 'int8', 'int8_kv', 'fused_bf16', 'fused', 'fused_int4']


@pytest.mark.parametrize('quantize', GOLDEN_TIERS)
def test_withprev_contiguous_tokens_equal_the_goldens(withprev, quantize):
    """Both corpus songs, contiguous, segment_bucket 1, max_length 1024:
    the exact path, the int8 tiers and each window tier (their kernels'
    plain versions on the CPU) give the golden tokens (the JAX package
    pins int4 on this path too: tests/test_fused_decode.py:732)."""
    _, meta, model = withprev
    handler = InferenceHandler(model=model, max_length=MAX_LENGTH,
                               contiguous_inference=True, segment_bucket=1,
                               quantize=quantize, device='cpu')
    for audio, want in zip(parity_corpus()[0], meta['tokens']):
        segments, _, valid = handler._audio_to_segments(audio)
        tokens = handler._decode_all(handler._compute_mel(segments, valid))
        np.testing.assert_array_equal(tokens, want)


def test_v1_contiguous_tokens_equal_the_goldens(v1):
    _, meta, model = v1
    handler = InferenceHandler(model=model, max_length=MAX_LENGTH,
                               contiguous_inference=True, segment_bucket=1,
                               device='cpu')
    for audio, want in zip(parity_corpus()[0], meta['tokens']):
        segments, _, valid = handler._audio_to_segments(audio)
        tokens = handler._decode_all(handler._compute_mel(segments, valid))
        np.testing.assert_array_equal(tokens, want)


def _handlers(small, quantize='none', **kw):
    params, model = small
    kw.setdefault('max_length', 12)
    kw.setdefault('batch_size', 2)
    return (InferenceHandler(model=model, quantize=quantize, device='cpu',
                             **kw),
            JaxHandler(model=JaxMT3(SMALL_SEGMEM),
                       variables={'params': params}, quantize=quantize,
                       **kw))


class TestHandler:
    def test_chained_decode_equals_jax(self, small):
        """Non-contiguous encoder_append: 5 segments in chains of 2."""
        mine, theirs = _handlers(small)
        mel = _mel(13, 5)
        got = mine._decode_all(torch.from_numpy(mel))
        np.testing.assert_array_equal(got, theirs._decode_all(mel))
        assert got.shape == (5, 13)

    def test_transcribe_many_equals_jax(self, small):
        mine, theirs = _handlers(small, contiguous_inference=True,
                                 segment_bucket=2)
        rng = np.random.default_rng(14)
        audios = [rng.normal(size=16000 * n).astype(np.float32) * 0.1
                  for n in (3, 5)]
        for a, b in zip(mine.transcribe_many(audios),
                        theirs.transcribe_many(audios)):
            assert [(n.pitch, n.start_time, n.end_time) for n in a.notes] \
                == [(n.pitch, n.start_time, n.end_time) for n in b.notes]

    def test_call_sizes(self, small):
        """Uncapped (the exact tier): JAX's sizes. On a window tier every
        model takes up to FUSED_MAX_BATCH (64) rows per call: the JAX
        package's 8-row cap for encoder_append models follows a TPU
        measurement that does not apply to the one-launch CUDA kernel."""
        mine, theirs = _handlers(small)
        for n in (1, 3, 8, 9, 20, 70):
            for floor in (1, 4):
                assert mine._call_sizes(n, floor, False) == \
                    theirs._call_sizes(n, floor, False), (n, floor)
        mine = _handlers(small, quantize='fused')[0]
        assert [mine._call_sizes(n, 4, True)
                for n in (1, 3, 8, 9, 20, 64, 70, 130)] == \
            [[4], [4], [8], [16], [32], [64], [64, 8], [64, 64, 4]]

    def test_one_call_past_the_jax_cap_equals_jax(self, small):
        """10 one-segment chains on fused_bf16: one call of 16 rows in the
        port, calls of 8 and 4 in JAX; the same tokens."""
        mine, theirs = _handlers(small, quantize='fused_bf16', batch_size=1)
        assert mine._call_sizes(10, 4, True) == [16]
        assert theirs._call_sizes(10, 4, True) == [8, 4]
        mel = _mel(15, 10)
        got = mine._decode_all(torch.from_numpy(mel))
        np.testing.assert_array_equal(got, theirs._decode_all(mel))


class TestProbe:
    def test_teacher_forced_margins_equal_jax(self, small):
        for fmt in ('reference', 'train_aligned'):
            mine, theirs = _handlers(small, segmem_memory_format=fmt,
                                     contiguous_inference=True)
            mel = np.array(jax_probe.probe_mel(theirs))
            tokens = jax_probe._probe_twin(theirs, 'none', 12)._decode_all(
                mel)
            mj, gj, vj = jax_probe._teacher_forced_margins(theirs, mel,
                                                           tokens)
            mt, gt, vt = probe_mod._teacher_forced_margins(
                mine, torch.from_numpy(mel), tokens)
            np.testing.assert_allclose(mt, mj, atol=1e-4)
            np.testing.assert_array_equal(gt, gj)
            np.testing.assert_array_equal(vt, vj)

    @pytest.mark.parametrize('contiguous', [True, False])
    def test_classify_flips_equals_jax(self, small, contiguous):
        """Planted first flips in rows 0 and 1: a contiguous handler's
        rows are one chain, so row 1 is downstream there."""
        mine, theirs = _handlers(small, contiguous_inference=contiguous)
        mel = np.array(jax_probe.probe_mel(theirs))
        exact = jax_probe._probe_twin(theirs, 'none', 12)._decode_all(mel)
        quant = np.array(exact)
        quant[0, 3] ^= 1
        quant[1, 2] ^= 1
        want = jax_probe.classify_flips(theirs, quant, exact, mel)
        got = probe_mod.classify_flips(mine, quant, exact,
                                       torch.from_numpy(mel))
        assert got == want
        assert got['downstream_rows'] == int(contiguous)

    def test_parity_model_probe_equals_jax(self, withprev, monkeypatch):
        """The withprev parity model, contiguous, at fused_int4 on the
        same probe mel: the classified probe dict equals JAX's."""
        params, _, model = withprev
        kw = dict(max_length=MAX_LENGTH, contiguous_inference=True,
                  segment_bucket=1, quantize='fused_int4')
        jh = JaxHandler(model=JaxMT3(WITHPREV_CFG),
                        variables={'params': params}, **kw)
        th = InferenceHandler(model=model, device='cpu', **kw)
        mel = np.array(jax_probe.probe_mel(jh))
        monkeypatch.setattr(probe_mod, 'probe_mel',
                            lambda handler: torch.from_numpy(mel))
        assert probe_mod.quantize_probe(th, classify=True) == \
            jax_probe.quantize_probe(jh, classify=True)

    @pytest.mark.parametrize('scenario', ['walk', 'stop_bf16'])
    def test_ladder_walk_equals_jax(self, small, scenario, monkeypatch):
        """The same stubbed probe results through both ladders, on a
        chained segmem handler: the same info dict and final tier."""
        monkeypatch.setattr(probe_mod, 'PROBE_MAX_LENGTH', 8)
        monkeypatch.setattr(jax_probe, 'PROBE_MAX_LENGTH', 8)

        def probe(h, max_length=None, **kw):
            if scenario == 'stop_bf16' and h.quantize == 'fused_bf16':
                return (0, 26)
            return (2, 26)
        infos = []
        for mod, handler in zip((probe_mod, jax_probe),
                                _handlers(small, 'fused_int4')):
            info = mod.resolve_auto_quantize(handler, verbose=False,
                                             probe_fn=probe)
            infos.append((handler.quantize, info))
        assert infos[0] == infos[1]

    def test_decoder_prepend_goes_to_exact(self, v1):
        handler = InferenceHandler(model=v1[2], max_length=12,
                                   quantize='fused_int4', device='cpu')
        info = probe_mod.resolve_auto_quantize(
            handler, verbose=False,
            probe_fn=lambda h: pytest.fail('probed a decoder_prepend model'))
        assert handler.quantize == 'none' and info['quantize'] == 'none'
        assert 'error' in probe_mod.margin_stats(handler)


class TestServe:
    def test_segmem_cli_builds_the_paper_model(self):
        handler = serve.build_handler([
            'model=MT3NetSegMemV2WithPrev', 'trainer.precision=bf16',
            'device=cpu', 'model.config.num_layers=1',
            'model.config.num_decoder_layers=1', 'eval.max_length=8'])
        cfg = handler.cfg
        assert cfg.segmem_variant == 'encoder_append'
        assert (cfg.segmem_length, cfg.segmem_num_layers,
                cfg.segmem_seed) == (64, 1, 'tie_eos')
        assert cfg.dtype == 'bfloat16' and cfg.d_model == 512
        assert handler.batch_size == 8
        assert not handler.contiguous_inference
        assert hasattr(handler.model, 'segmem_encoder')
        info = serve.prepare_handler(handler)
        assert info['prewarmed'] and info['prewarm_buckets'] == [1, 8, 16,
                                                                 32, 64]

    @pytest.mark.parametrize('quantize,contiguous,batch_size,counts', [
        ('fused_int4', False, 8, [1, 8, 16, 32, 64]),
        ('none', False, 8, [1, 8, 16, 32, 64]),
        ('fused', True, 8, [1, 2, 4, 8]),
        ('none', False, 1, [1, 8, 16, 32, 64]),
        ('int8_kv', False, 8, [1, 8, 16, 32, 64]),
    ])
    def test_prewarm_plan(self, small, quantize, contiguous, batch_size,
                          counts):
        handler = _handlers(small, quantize, batch_size=batch_size,
                            contiguous_inference=contiguous)[0]
        audio, got = serve.prewarm_plan(handler)
        assert got == counts
        segments = len(handler._audio_to_segments(audio)[0])
        assert segments == (1 if batch_size < 2 else 2)
