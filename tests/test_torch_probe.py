"""The port's quantize probe ladder (mr_mt3_tpu_torch.infer.probe and
serve.prepare_handler) on the CPU, mirroring the JAX package's
tests/test_inference.py::TestAutoQuantize and
tests/test_serve.py::TestQuantizeGuard, and held against the JAX ladder:
the same stubbed probe results give the same info dicts, and on the same
weights the teacher-forced margins and a real probe's flip count agree."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mr_mt3_tpu.infer import InferenceHandler as JaxHandler
from mr_mt3_tpu.infer import probe as jax_probe
from mr_mt3_tpu.models import MT3 as JaxMT3
from mr_mt3_tpu_torch import serve
from mr_mt3_tpu_torch.infer import InferenceHandler
from mr_mt3_tpu_torch.infer import probe as probe_mod
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.utils.checkpoint_import import state_dict_from_jax_params
from tests.test_inference import SMALL
from tests.torch_threads import two_torch_threads  # noqa: F401

# teacher-forced logits of the two frameworks agree to ~1e-6 at this size
# (both f32 on the CPU); margins are differences of two of them
MARGIN_ATOL = 1e-4


@pytest.fixture(scope='module')
def weights():
    params = JaxMT3(SMALL).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 512)),
        decoder_input_ids=jnp.zeros((1, 4), jnp.int32))['params']
    cfg = MT3Config(**{f: getattr(SMALL, f)
                       for f in MT3Config.__dataclass_fields__})
    model = MT3(cfg).eval()
    model.load_state_dict(state_dict_from_jax_params(params, cfg))
    return params, model


def port_handler(weights, quantize='fused', max_length=12):
    return InferenceHandler(model=weights[1], max_length=max_length,
                            batch_size=4, quantize=quantize, device='cpu')


def jax_handler(weights, quantize='fused', max_length=12):
    return JaxHandler(model=JaxMT3(SMALL),
                      variables={'params': weights[0]},
                      max_length=max_length, batch_size=4,
                      quantize=quantize)


def _use_jax_mel(monkeypatch, weights):
    """Give the port's probe the JAX frontend's probe mel (the same
    inputs on both sides; the two frontends agree to 1e-3 in log-mel)."""
    mel = np.array(jax_probe.probe_mel(jax_handler(weights, 'none')))
    monkeypatch.setattr(probe_mod, 'probe_mel',
                        lambda handler: torch.from_numpy(mel))
    return mel


class TestLadder:
    def test_full_walk_from_int4(self, weights, monkeypatch):
        """Flips at every tier walk int4 -> int8 -> bf16 -> none."""
        handler = port_handler(weights, 'fused_int4')
        tiers = []
        monkeypatch.setattr(probe_mod, 'quantize_probe',
                            lambda h: tiers.append(h.quantize) or (1, 50))
        info = probe_mod.resolve_auto_quantize(handler, verbose=False)
        assert tiers == ['fused_int4', 'fused', 'fused_bf16']
        assert handler.quantize == 'none' and info['quantize'] == 'none'
        assert info['probe_flips'] == 1 and info['probe_tokens'] == 50
        assert len(info['demotions']) == 3

    def test_stops_at_bf16_when_its_probe_is_clean(self, weights,
                                                   monkeypatch):
        handler = port_handler(weights, 'fused_int4')
        monkeypatch.setattr(
            probe_mod, 'quantize_probe',
            lambda h: (0, 50) if h.quantize == 'fused_bf16' else (3, 50))
        info = probe_mod.resolve_auto_quantize(handler, verbose=False)
        assert handler.quantize == 'fused_bf16'
        assert info['probe_tier'] == 'fused_bf16'
        assert info['probe_flips'] == 0
        assert len(info['demotions']) == 2

    def test_clean_probe_keeps_int4(self, weights, monkeypatch):
        handler = port_handler(weights, 'fused_int4')
        handler._decode_params()
        monkeypatch.setattr(probe_mod, 'quantize_probe', lambda h: (0, 50))
        info = probe_mod.resolve_auto_quantize(handler, verbose=False)
        assert handler.quantize == 'fused_int4'
        assert handler.replicas[0].dp is not None       # nothing invalidated
        assert 'demotions' not in info

    def test_exception_demotes_and_drops_stale_counts(self, weights,
                                                      monkeypatch):
        handler = port_handler(weights, 'fused_int4')

        def probe(h, **kw):
            if h.quantize == 'fused_int4':
                return (7, 50)
            raise RuntimeError('kernel launch failed')
        monkeypatch.setattr(probe_mod, 'quantize_probe', probe)
        info = probe_mod.resolve_auto_quantize(handler, verbose=False)
        assert handler.quantize == 'none'
        for key in ('probe_flips', 'probe_tokens', 'probe_tier'):
            assert key not in info
        assert 'kernel launch failed' in info['probe_error']
        assert len(info['demotions']) == 3

    def test_demotion_drops_the_packed_weights(self, weights, monkeypatch):
        """A demoted handler re-packs for its new tier: _invalidate_compiled
        drops the old tier's packed decode params."""
        handler = port_handler(weights, 'fused_int4')
        assert handler._decode_params().fused.wqkv.dtype == torch.uint8
        monkeypatch.setattr(
            probe_mod, 'quantize_probe',
            lambda h: (0, 50) if h.quantize == 'fused' else (2, 50))
        probe_mod.resolve_auto_quantize(handler, verbose=False)
        assert handler.quantize == 'fused' and handler.replicas[0].dp is None
        assert handler._decode_params().fused.wqkv.dtype == torch.int8

    def test_probe_caches_exact_tokens_across_ladder(self, weights):
        handler = port_handler(weights, 'fused_int4')
        _, total1 = probe_mod.quantize_probe(handler)
        cached = dict(handler._probe_exact_tokens)
        assert len(cached) == 1
        handler.quantize = 'fused'
        handler._invalidate_compiled()
        _, total2 = probe_mod.quantize_probe(handler)
        assert len(handler._probe_exact_tokens) == 1
        assert all(handler._probe_exact_tokens[k] is cached[k]
                   for k in cached)
        assert total2 == total1

    def test_probe_length_clamps_and_overrides(self, weights):
        """The probe decodes min(max_length, PROBE_MAX_LENGTH) tokens per
        row of the 2-segment probe audio; an explicit length overrides."""
        assert probe_mod.PROBE_MAX_LENGTH == 256
        handler = port_handler(weights, 'fused')
        _, total = probe_mod.quantize_probe(handler)
        assert total == 2 * (12 + 1)
        _, total2 = probe_mod.quantize_probe(port_handler(weights, 'fused'),
                                             max_length=4)
        assert total2 == 2 * (4 + 1)

    def test_full_length_confirm_guards_winner(self, weights, monkeypatch):
        monkeypatch.setattr(probe_mod, 'PROBE_MAX_LENGTH', 4)
        handler = port_handler(weights, 'fused')
        calls = []

        def fake_probe(h, max_length=None):
            calls.append((h.quantize, max_length))
            if max_length is None:
                return (0, 15)
            return (0, 39) if h.quantize == 'fused_bf16' else (5, 39)
        info = probe_mod.resolve_auto_quantize(
            handler, verbose=False, probe_fn=fake_probe)
        assert handler.quantize == 'fused_bf16'
        assert calls == [('fused', None), ('fused', 12),
                         ('fused_bf16', None), ('fused_bf16', 12)]
        assert info['confirm_flips'] == 0 and info['confirm_tokens'] == 39

    def test_legacy_tuple_probe_is_strict(self, weights):
        handler = port_handler(weights, 'fused')
        info = probe_mod.resolve_auto_quantize(
            handler, verbose=False, probe_fn=lambda h: (1, 50))
        assert handler.quantize == 'none'
        assert len(info['demotions']) == 2

    def test_classify_error_falls_back_to_strict(self, weights, monkeypatch):
        handler = port_handler(weights, 'fused_bf16')
        monkeypatch.setattr(
            probe_mod, 'quantize_probe',
            lambda h, max_length=None, classify=False:
            {'flips': 2, 'total': 50, 'classify_error': 'boom'})
        info = probe_mod.resolve_auto_quantize(handler, verbose=False)
        assert handler.quantize == 'none'
        assert len(info['demotions']) == 1

    def test_material_flip_demotes_benign_does_not(self, weights,
                                                   monkeypatch):
        handler = port_handler(weights, 'fused_int4')

        def probe(h, max_length=None, classify=False):
            assert classify
            if h.quantize == 'fused_int4':
                return {'flips': 5, 'total': 50, 'material_rows': 1,
                        'benign_rows': 1, 'downstream_rows': 0, 'rows': 2,
                        'material_margin': 0.01, 'margin_noise': 0.002,
                        'first_flip_margins': [0.5, 0.001]}
            return {'flips': 3, 'total': 50, 'material_rows': 0,
                    'benign_rows': 2, 'downstream_rows': 0, 'rows': 2,
                    'material_margin': 0.01, 'margin_noise': 0.002,
                    'first_flip_margins': [0.004, 0.001]}
        monkeypatch.setattr(probe_mod, 'quantize_probe', probe)
        info = probe_mod.resolve_auto_quantize(handler, verbose=False)
        assert handler.quantize == 'fused'
        assert info['probe_benign_rows'] == 2
        assert 'material' in info['demotions'][0]

    def test_decoder_prepend_demoted_without_probe(self):
        """A decoder_prepend model has no window-kernel path: straight to
        'none', no probe (a stand-in handler; tests/test_torch_segmem.py
        runs a real one)."""
        demoted = []
        handler = types.SimpleNamespace(
            quantize='fused_int4',
            cfg=types.SimpleNamespace(segmem_variant='decoder_prepend'),
            _invalidate_compiled=lambda: demoted.append(True))
        info = probe_mod.resolve_auto_quantize(
            handler, verbose=False,
            probe_fn=lambda h: pytest.fail('probed a decoder_prepend model'))
        assert handler.quantize == 'none' and info['quantize'] == 'none'
        assert demoted == [True] and 'probe_flips' not in info


class TestPrepareHandler:
    def test_probe_flip_falls_back_to_exact(self, weights, monkeypatch):
        handler = port_handler(weights, 'fused_int4')
        handler._decode_params()
        monkeypatch.setattr(serve, 'quantize_probe', lambda h: (3, 100))
        info = serve.prepare_handler(handler)
        # the int4 weights were dropped; the prewarm stacked the exact ones
        assert handler.quantize == 'none' and handler.replicas[0].dp.fused is None
        assert info['quantize'] == 'none' and info['probe_flips'] == 3
        assert info['prewarmed'] is True

    def test_prewarm_failure_demotes(self, weights, monkeypatch):
        handler = port_handler(weights, 'fused_int4')
        monkeypatch.setattr(serve, 'quantize_probe', lambda h: (0, 100))
        real = InferenceHandler.transcribe_many

        def flaky(self, audios):
            if handler.quantize == 'fused_int4':
                raise RuntimeError('kernel launch failed at full length')
            return real(self, audios)
        monkeypatch.setattr(InferenceHandler, 'transcribe_many', flaky)
        info = serve.prepare_handler(handler)
        assert handler.quantize == 'fused'
        assert info['quantize'] == 'fused' and info['prewarmed'] is True
        assert info['prewarm_buckets'] == [1]
        assert any('prewarm failed' in d for d in info['demotions'])

    def test_prewarm_failure_at_exact_tier_raises(self, weights,
                                                  monkeypatch):
        handler = port_handler(weights, 'none')
        monkeypatch.setattr(
            InferenceHandler, 'transcribe_many',
            lambda self, audios: (_ for _ in ()).throw(
                RuntimeError('device lost')))
        with pytest.raises(RuntimeError, match='device lost'):
            serve.prepare_handler(handler, probe=False)


def _raise_kernel_fault(*args, **kwargs):
    raise RuntimeError('fused_decode_window launch failed: an illegal '
                       'memory access was encountered')


class TestKernelFaultsOnTheCard:
    """On the card a probe or prewarm exception is a fault of the kernel
    or the port: it propagates, and the server does not start, instead of
    demoting to a tier that hides the kernel. The handlers here run on the
    CPU with demotes_on_error patched to its card answer, and the window
    kernel stubbed to raise as a failed launch does."""

    def test_demotes_on_error_only_off_the_card(self, weights):
        assert probe_mod.demotes_on_error(port_handler(weights, 'fused'))
        card = types.SimpleNamespace(device=torch.device('cuda'))
        assert not probe_mod.demotes_on_error(card)

    @pytest.mark.parametrize('stage', ['probe', 'prewarm'])
    def test_kernel_fault_stops_the_server(self, weights, stage,
                                           monkeypatch):
        from mr_mt3_tpu_torch.ops import fused_decode as fd
        handler = port_handler(weights, 'fused_int4')
        monkeypatch.setattr(probe_mod, 'demotes_on_error', lambda h: False)
        monkeypatch.setattr(fd, 'fused_decode_window', _raise_kernel_fault)
        if stage == 'prewarm':
            monkeypatch.setattr(serve, 'quantize_probe',
                                lambda h, **kw: (0, 26))
        with pytest.raises(RuntimeError, match='launch failed'):
            serve.prepare_handler(handler)
        assert handler.quantize == 'fused_int4'

    @pytest.mark.parametrize('stage', ['probe', 'prewarm'])
    @pytest.mark.parametrize('tier,module,wrapper', [
        ('int8', 'int8_matmul', 'int8_gated_ff'),
        ('int8', 'int8_matmul', 'int8_matmul'),
        ('int8_kv', 'int8_attention', 'int8_decode_attention')])
    def test_int8_kernel_fault_stops_the_server(self, weights, tier, module,
                                                wrapper, stage,
                                                monkeypatch):
        """The same for the int8 tiers, each of their kernels' wrappers
        stubbed to raise as a failed launch does."""
        import importlib
        handler = port_handler(weights, tier)
        monkeypatch.setattr(probe_mod, 'demotes_on_error', lambda h: False)
        monkeypatch.setattr(importlib.import_module(
            f'mr_mt3_tpu_torch.ops.{module}'), wrapper, _raise_kernel_fault)
        if stage == 'prewarm':
            monkeypatch.setattr(serve, 'quantize_probe',
                                lambda h, **kw: (0, 26))
        with pytest.raises(RuntimeError, match='launch failed'):
            serve.prepare_handler(handler)
        assert handler.quantize == tier

    def test_confirm_fault_propagates(self, weights, monkeypatch):
        monkeypatch.setattr(probe_mod, 'PROBE_MAX_LENGTH', 4)
        monkeypatch.setattr(probe_mod, 'demotes_on_error', lambda h: False)
        handler = port_handler(weights, 'fused')

        def probe(h, max_length=None):
            if max_length is not None:
                _raise_kernel_fault()
            return (0, 10)
        with pytest.raises(RuntimeError, match='launch failed'):
            probe_mod.resolve_auto_quantize(handler, verbose=False,
                                            probe_fn=probe)
        assert handler.quantize == 'fused'


def _stub_results(scenario):
    """Probe stubs shared by both ladders: results keyed by tier and by
    short probe / full-length confirm."""
    table = {
        'walk': lambda tier, full: (2, 26),
        'stop_bf16': lambda tier, full: (0, 26) if tier == 'fused_bf16'
        else (4, 26),
        'confirm': lambda tier, full: (3, 300) if full and
        tier == 'fused_int4' else (0, 26),
        'benign': lambda tier, full: {
            'flips': 3, 'total': 26, 'material_rows': 0, 'benign_rows': 2,
            'downstream_rows': 0, 'rows': 2, 'material_margin': 0.001,
            'margin_noise': 0.0, 'first_flip_margins': [0.0004, 0.0]},
        'raise': lambda tier, full: (_ for _ in ()).throw(
            RuntimeError(f'{tier} failed')) if tier != 'fused_bf16'
        else (1, 26),
    }
    return table[scenario]


class TestAgainstJax:
    @pytest.mark.parametrize('scenario', ['walk', 'stop_bf16', 'confirm',
                                          'benign', 'raise'])
    def test_info_dicts_equal_jax(self, weights, scenario, monkeypatch):
        """The same stubbed probe results through both ladders give the
        same info dict and the same final tier."""
        monkeypatch.setattr(probe_mod, 'PROBE_MAX_LENGTH', 8)
        monkeypatch.setattr(jax_probe, 'PROBE_MAX_LENGTH', 8)
        result = _stub_results(scenario)

        def probe(h, max_length=None, **kw):
            return result(h.quantize, max_length is not None)
        infos = []
        for mod, handler in ((probe_mod, port_handler(weights, 'fused_int4')),
                             (jax_probe, jax_handler(weights, 'fused_int4'))):
            info = mod.resolve_auto_quantize(handler, verbose=False,
                                             probe_fn=probe)
            infos.append((handler.quantize, info))
        assert infos[0] == infos[1]

    def test_teacher_forced_margins_match_jax(self, weights):
        """Same weights, same mel, same tokens: margins within MARGIN_ATOL,
        identical greedy tokens and valid masks."""
        jh, ph = jax_handler(weights, 'none'), port_handler(weights, 'none')
        mel = np.array(jax_probe.probe_mel(jh))
        tokens = jax_probe._probe_twin(jh, 'none', 12)._decode_all(mel)
        mj, gj, vj = jax_probe._teacher_forced_margins(jh, mel, tokens)
        mt, gt, vt = probe_mod._teacher_forced_margins(
            ph, torch.from_numpy(mel), tokens)
        np.testing.assert_allclose(mt, mj, atol=MARGIN_ATOL)
        np.testing.assert_array_equal(gt, gj)
        np.testing.assert_array_equal(vt, vj)
        m32, _, _ = probe_mod._teacher_forced_margins(
            ph, torch.from_numpy(mel), tokens, dtype='bfloat16')
        assert np.abs(m32 - mt).max() > 0     # the dtype twin is distinct

    def test_classify_flips_equals_jax(self, weights):
        """Planted first flips in rows 0 and 1 classify the same way."""
        jh, ph = jax_handler(weights, 'none'), port_handler(weights, 'none')
        mel = np.array(jax_probe.probe_mel(jh))
        exact = jax_probe._probe_twin(jh, 'none', 12)._decode_all(mel)
        quant = np.array(exact)
        quant[0, 3] ^= 1
        quant[1, 2] ^= 1
        want = jax_probe.classify_flips(jh, quant, exact, mel)
        got = probe_mod.classify_flips(ph, quant, exact,
                                       torch.from_numpy(mel))
        assert got == want
        assert got['material_rows'] + got['benign_rows'] == 2

    @pytest.mark.parametrize('tier', ['fused', 'fused_int4'])
    def test_real_probe_equals_jax(self, weights, tier, monkeypatch):
        """A real quantize_probe at max_length 32 (the JAX window kernel
        interpreted, the port's plain version) on the same probe mel:
        the same (flips, total)."""
        _use_jax_mel(monkeypatch, weights)
        want = jax_probe.quantize_probe(jax_handler(weights, tier),
                                        max_length=32)
        got = probe_mod.quantize_probe(port_handler(weights, tier),
                                       max_length=32)
        assert got == want

    def test_parity_model_probe_equals_jax(self, monkeypatch):
        """The overfit parity model at fused_int4, on the same probe mel:
        the classified probe dict equals JAX's (17 of 514 probe tokens
        flip, one row materially, so both ladders demote int4 there)."""
        from tests.parity_common import VANILLA_CFG, load_golden
        params, _ = load_golden('parity_vanilla.npz')
        jh = JaxHandler(model=JaxMT3(VANILLA_CFG),
                        variables={'params': params}, max_length=1024,
                        batch_size=4, quantize='fused_int4')
        cfg = MT3Config(**{f: getattr(VANILLA_CFG, f)
                           for f in MT3Config.__dataclass_fields__})
        model = MT3(cfg).eval()
        model.load_state_dict(state_dict_from_jax_params(params, cfg))
        th = InferenceHandler(model=model, max_length=1024, batch_size=4,
                              quantize='fused_int4', device='cpu')
        mel = np.array(jax_probe.probe_mel(jh))
        monkeypatch.setattr(probe_mod, 'probe_mel',
                            lambda handler: torch.from_numpy(mel))
        want = jax_probe.quantize_probe(jh, classify=True)
        got = probe_mod.quantize_probe(th, classify=True)
        assert got == want
        assert got['material_rows'] == 1

    @pytest.mark.parametrize('tier', ['int8', 'int8_kv'])
    def test_parity_model_ladder_from_int8_tiers_equals_jax(self, tier,
                                                           monkeypatch):
        """The ladder started at each int8 tier on the overfit parity
        model, with real probes on the same probe mel (a 64-step probe,
        then the confirm at the 96-step serving length): the same info
        dict and the same final tier as JAX's ladder."""
        from tests.parity_common import VANILLA_CFG, load_golden
        params, _ = load_golden('parity_vanilla.npz')
        jh = JaxHandler(model=JaxMT3(VANILLA_CFG),
                        variables={'params': params}, max_length=96,
                        batch_size=4, quantize=tier)
        cfg = MT3Config(**{f: getattr(VANILLA_CFG, f)
                           for f in MT3Config.__dataclass_fields__})
        model = MT3(cfg).eval()
        model.load_state_dict(state_dict_from_jax_params(params, cfg))
        th = InferenceHandler(model=model, max_length=96, batch_size=4,
                              quantize=tier, device='cpu')
        mel = np.array(jax_probe.probe_mel(jh))
        monkeypatch.setattr(jax_probe, 'probe_mel', lambda handler: mel)
        monkeypatch.setattr(probe_mod, 'probe_mel',
                            lambda handler: torch.from_numpy(mel))
        for mod in (jax_probe, probe_mod):
            monkeypatch.setattr(mod, 'PROBE_MAX_LENGTH', 64)
        want = jax_probe.resolve_auto_quantize(jh, verbose=False)
        got = probe_mod.resolve_auto_quantize(th, verbose=False)
        print(f'{tier}: {got}')
        assert (th.quantize, got) == (jh.quantize, want)
        assert 'confirm_tokens' in got

    def test_margin_stats_equal_jax(self, weights, monkeypatch):
        """margin_stats of the exact decode on the same probe mel: the
        same token count and teacher-forced agreement, margins within
        MARGIN_ATOL (both sides round them to 4 decimals)."""
        mel = _use_jax_mel(monkeypatch, weights)
        jh = jax_handler(weights, 'none')
        monkeypatch.setattr(jax_probe, 'probe_mel', lambda handler: mel)
        want = jax_probe.margin_stats(jh)
        got = probe_mod.margin_stats(port_handler(weights, 'none'))
        assert set(got) == set(want)
        for key in ('tokens', 'teacher_forced_agreement'):
            assert got[key] == want[key], key
        for key in ('margin_min', 'margin_p1', 'margin_p5',
                    'margin_median'):
            assert abs(got[key] - want[key]) <= MARGIN_ATOL + 1e-4, key
