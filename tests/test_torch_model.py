"""The PyTorch MT3 (mr_mt3_tpu_torch.models) against the JAX MT3 on the
same weights: the weights bridge, teacher-forced logits at the parity
config and at full width, and the KV-cache decode step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mr_mt3_tpu.models import MT3 as JaxMT3
from mr_mt3_tpu.utils.checkpoint_import import export_to_torch_state_dict
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.utils.checkpoint_import import (
    load_torch_checkpoint,
    state_dict_from_jax_params,
)
from tests.parity_common import (
    FULL_CFG,
    VANILLA_CFG,
    full_scale_inputs,
    full_scale_params,
    load_golden,
    parity_corpus,
)

# fp32 on both sides; the two frameworks sum in different orders
LOGIT_RTOL = 1e-4
# the torch-oracle tolerance at full width (tests/test_parity_e2e.py:465)
FULL_RTOL = 2e-3


def torch_cfg(jax_cfg) -> MT3Config:
    """The port's config with the JAX config's fields."""
    return MT3Config(**{f: getattr(jax_cfg, f)
                        for f in MT3Config.__dataclass_fields__})


def port_model(params, jax_cfg) -> MT3:
    model = MT3(torch_cfg(jax_cfg)).eval()
    model.load_state_dict(state_dict_from_jax_params(
        params, model.cfg), strict=True)
    return model


@pytest.fixture(scope='module')
def vanilla():
    params, meta = load_golden('parity_vanilla.npz')
    return params, meta, port_model(params, VANILLA_CFG)


def corpus_mel():
    """Two normalized log-mel segments of the parity corpus, (2, 256, 512)."""
    from mr_mt3_tpu.audio import compute_logmel, normalize_logmel
    seg = parity_corpus()[0][0][:2 * 256 * 128].reshape(2, -1)
    return np.array(normalize_logmel(compute_logmel(jnp.asarray(seg))),
                    np.float32)


class TestWeightsBridge:
    def test_every_parameter_round_trips(self, vanilla):
        """The bridge is the JAX package's export mapping: the same keys,
        the same values, and every port parameter is filled."""
        params, _, model = vanilla
        theirs = export_to_torch_state_dict(params, VANILLA_CFG)
        mine = state_dict_from_jax_params(params, model.cfg)
        assert set(mine) == set(theirs) == set(model.state_dict())
        for key, value in theirs.items():
            np.testing.assert_array_equal(mine[key].numpy(), value, key)
            np.testing.assert_array_equal(
                model.state_dict()[key].numpy(), value, key)

    def test_reference_checkpoint_loads_natively(self, vanilla, tmp_path):
        """A Lightning .ckpt (weights under state_dict, 'model.' prefix,
        plus keys that carry nothing) loads strictly after import."""
        _, _, model = vanilla
        blob = {f'model.{k}': v for k, v in model.state_dict().items()}
        blob['model.encoder.embed_tokens.weight'] = torch.zeros(3, 3)
        path = tmp_path / 'ref.ckpt'
        torch.save({'state_dict': blob}, path)
        loaded = load_torch_checkpoint(str(path))
        twin = MT3(model.cfg)
        twin.load_state_dict(loaded, strict=True)
        for key, value in model.state_dict().items():
            assert torch.equal(twin.state_dict()[key], value), key


class TestTeacherForcedLogits:
    def test_parity_config_matches_jax(self, vanilla):
        params, _, model = vanilla
        mel = corpus_mel()
        ids = np.random.default_rng(3).integers(
            3, VANILLA_CFG.vocab_size, size=(2, 24)).astype(np.int32)
        ids[:, 0] = 0
        want = np.asarray(JaxMT3(VANILLA_CFG).apply(
            {'params': params}, jnp.asarray(mel),
            decoder_input_ids=jnp.asarray(ids), deterministic=True))
        with torch.no_grad():
            got = model(torch.from_numpy(mel),
                        torch.from_numpy(ids).long()).numpy()
        np.testing.assert_allclose(
            got, want, atol=LOGIT_RTOL * np.abs(want).max(), rtol=0)

    def test_full_width_reproduces_46m_golden(self):
        """d_model 512, 8+8 layers, 6 heads, vocab 1536 with the JAX
        package's seed-0 weights bridged in: the frozen logits slab."""
        golden = np.load('tests/goldens/parity_46m_logits.npz')
        _, params = full_scale_params()
        model = port_model(jax.device_get(params), FULL_CFG)
        mel, ids = full_scale_inputs()
        np.testing.assert_array_equal(ids, golden['decoder_ids'])
        with torch.no_grad():
            got = model(torch.tensor(mel), torch.tensor(ids).long()).numpy()
        want = golden['logits']
        assert got.shape == want.shape == (1, 64, 1536)
        np.testing.assert_allclose(
            got, want, atol=FULL_RTOL * np.abs(want).max(), rtol=0)


class TestDecodeStep:
    def test_cached_steps_match_jax(self, vanilla):
        """16 KV-cache steps: logits against the JAX decode_step on the
        same tokens and encoder states."""
        params, _, model = vanilla
        jmodel = JaxMT3(VANILLA_CFG)
        mel = corpus_mel()
        enc_j = jmodel.apply({'params': params}, jnp.asarray(mel),
                             method=JaxMT3.encode_audio)
        cross_j = jmodel.apply({'params': params}, enc_j,
                               method=JaxMT3.precompute_cross_kv)
        cache_j = jmodel.init_cache(2, 16)
        with torch.no_grad():
            enc_t = model.encode_audio(torch.from_numpy(mel))
            np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j),
                                       atol=1e-4, rtol=0)
            cross_t = model.precompute_cross_kv(enc_t)
            cache_t = model.init_cache(2, 16)
        toks = np.random.default_rng(5).integers(
            0, VANILLA_CFG.vocab_size, size=(16, 2)).astype(np.int32)
        for step in range(16):
            want, cache_j = jmodel.apply(
                {'params': params}, jnp.asarray(toks[step]),
                jnp.int32(step), cache_j, cross_j,
                method=JaxMT3.decode_step)
            with torch.no_grad():
                got, cache_t = model.decode_step(
                    torch.from_numpy(toks[step]).long(), step, cache_t,
                    cross_t)
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, atol=LOGIT_RTOL * np.abs(want).max(),
                rtol=0, err_msg=f'step {step}')
        for (k_t, v_t), (k_j, v_j) in zip(cache_t, cache_j):
            np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j),
                                       atol=1e-4, rtol=0)
            np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j),
                                       atol=1e-4, rtol=0)

    def test_decode_step_matches_teacher_forced(self, vanilla):
        """The port's own KV-cache steps reproduce its teacher-forced
        logits: cache writes, masking and positions line up."""
        _, _, model = vanilla
        mel = torch.from_numpy(corpus_mel()[:1])
        ids = torch.from_numpy(np.random.default_rng(9).integers(
            3, VANILLA_CFG.vocab_size, size=(1, 12))).long()
        with torch.no_grad():
            full = model(mel, ids)[0]
            enc = model.encode_audio(mel)
            cross = model.precompute_cross_kv(enc)
            cache = model.init_cache(1, 12)
            for step in range(12):
                got, cache = model.decode_step(ids[:, step], step, cache,
                                               cross)
                torch.testing.assert_close(got[0], full[step], atol=1e-4,
                                           rtol=0)
