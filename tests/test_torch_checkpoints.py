"""Weights from the JAX side into the port, on the CPU: Orbax checkpoints
the JAX trainer writes (utils/orbax_read.py through builders.load_weights)
and the official MT3 T5X layout converted by the port's
scripts/convert_weight.py, each held against the JAX package on the same
weights: logits within 1e-5, the step, strict loads, and the converter's
tree against tools/convert_weight.py's (mirroring
tests/test_scripts_tools.py:127-299)."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mr_mt3_tpu.models import MT3 as JaxMT3
from mr_mt3_tpu.models import MT3Config as JaxConfig
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.scripts import convert_weight
from mr_mt3_tpu_torch.utils import builders
from mr_mt3_tpu_torch.utils.checkpoint_import import load_torch_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))
import convert_weight as jax_convert  # noqa: E402  (tools/, the JAX one)

# tests/test_fused_decode.py:31 SMALL_CFG
SMALL = dict(vocab_size=256, d_model=32, d_kv=8, d_ff=48, num_heads=4,
             num_encoder_layers=1, num_decoder_layers=2, mel_bins=16,
             dropout_rate=0.0)
WITHPREV = dict(segmem_variant='encoder_append', segmem_length=8)
LOGIT_ATOL = 1e-5


def _jax_params(jcfg, seed=0):
    kw = ({'targets_prev': jnp.zeros((1, 8), jnp.int32)}
          if jcfg.has_segmem else {})
    # jitted: op-by-op dispatch compiles every primitive alone
    return jax.jit(JaxMT3(jcfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, jcfg.mel_bins)),
        decoder_input_ids=jnp.zeros((1, 4), jnp.int32), **kw)['params']


def _inputs(cfg, seed=2):
    rng = np.random.default_rng(seed)
    mel = rng.normal(size=(2, 8, cfg['mel_bins'])).astype(np.float32)
    dec = rng.integers(0, cfg['vocab_size'], (2, 5)).astype(np.int32)
    return mel, dec


def _jax_logits(jcfg, params, mel, dec, **kw):
    return np.asarray(jax.jit(JaxMT3(jcfg).apply)(
        {'params': params}, jnp.asarray(mel),
        decoder_input_ids=jnp.asarray(dec), **kw))


@torch.no_grad()
def _port_logits(model, mel, dec):
    return model.eval()(torch.from_numpy(mel),
                        decoder_input_ids=torch.from_numpy(
                            dec).long()).numpy()


@pytest.fixture(scope='module')
def jax_trainer(tmp_path_factory):
    """What the JAX Trainer.save_checkpoint reads of its trainer (the
    checkpoint directory and _checkpointer), without building a Trainer,
    whose metrics writer imports TensorFlow for TensorBoard."""
    import types

    from mr_mt3_tpu.train.optim import make_optimizer
    from mr_mt3_tpu.train.trainer import Trainer
    trainer = types.SimpleNamespace(
        _ckpt_dir=str(tmp_path_factory.mktemp('jax_run') / 'checkpoints'))
    trainer._checkpointer = lambda: Trainer._checkpointer(trainer)
    trainer.save_checkpoint = lambda state, name: Trainer.save_checkpoint(
        trainer, state, name)
    return trainer, make_optimizer(1e-3, use_schedule=False)


def _save_jax_checkpoint(jax_trainer, jcfg, name, step):
    """Trainer.save_checkpoint of a state at `step` with the JAX model's
    initial params, its AdamW state written beside them: (params, path)."""
    from mr_mt3_tpu.train.trainer import TrainState
    trainer, optimizer = jax_trainer
    params = _jax_params(jcfg)
    trainer.save_checkpoint(TrainState(step=jnp.asarray(step, jnp.int32),
                                       params=params,
                                       opt_state=optimizer.init(params)),
                            name)
    return params, os.path.join(trainer._ckpt_dir, name)


class TestOrbax:
    @pytest.mark.parametrize('variant', ['vanilla', 'withprev'])
    def test_jax_trainer_checkpoint_loads_to_the_same_logits(
            self, jax_trainer, variant):
        kw = dict(SMALL, **(WITHPREV if variant == 'withprev' else {}))
        jcfg = JaxConfig(**kw)
        params, path = _save_jax_checkpoint(jax_trainer, jcfg, variant, 3)
        model, step = builders.load_weights_and_step(
            path, MT3(MT3Config(**kw)), strict=True)
        assert step == 3
        mel, dec = _inputs(kw)
        if variant == 'withprev':
            prev = np.random.default_rng(3).integers(
                0, kw['vocab_size'], (2, 8)).astype(np.int32)
            want = _jax_logits(jcfg, params, mel, dec,
                               targets_prev=jnp.asarray(prev))
            with torch.no_grad():
                got = model.eval()(
                    torch.from_numpy(mel),
                    decoder_input_ids=torch.from_numpy(dec).long(),
                    targets_prev=torch.from_numpy(prev).long()).numpy()
        else:
            want = _jax_logits(jcfg, params, mel, dec)
            got = _port_logits(model, mel, dec)
        print(f'{variant}: max |logit diff| {np.abs(got - want).max():.3g}')
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)

    def test_strict_load_catches_a_hole(self, tmp_path, capsys):
        """A checkpoint without lm_head loads leniently (the model keeps
        its lm_head) and raises under strict=True; a leaf the model does
        not have is reported."""
        import orbax.checkpoint as ocp
        params = jax.tree.map(np.asarray, _jax_params(JaxConfig(**SMALL)))
        params.pop('lm_head')
        params['extra'] = {'kernel': np.ones((2, 2), np.float32)}
        path = str(tmp_path / 'holed')
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(path, {'params': params, 'step': np.asarray(7, np.int32)})
        ckptr.wait_until_finished()
        model = MT3(MT3Config(**SMALL))
        before = model.lm_head.weight.clone()
        _, step = builders.load_weights_and_step(path, model)
        assert step == 7 and torch.equal(model.lm_head.weight, before)
        assert 'extra/kernel' in capsys.readouterr().out
        with pytest.raises(ValueError, match='lm_head'):
            builders.load_weights(path, MT3(MT3Config(**SMALL)),
                                  strict=True)

    def test_without_tensorstore_raises(self, tmp_path, monkeypatch):
        path = tmp_path / 'ckpt'
        path.mkdir()
        (path / '_METADATA').write_text('{}')
        monkeypatch.setitem(sys.modules, 'tensorstore', None)
        with pytest.raises(RuntimeError, match='tensorstore'):
            builders.load_weights(str(path), MT3(MT3Config(**SMALL)))


def _t5x_flat(params, n_enc, n_dec):
    """The JAX parameter tree in the T5X layout (reversing
    tools/convert_weight.py's mapping), as tests/test_scripts_tools.py:
    239-272 builds it, with a state/ subtree the converter must skip."""
    flat = {}
    attn = (('q', 'query'), ('k', 'key'), ('v', 'value'), ('o', 'out'))
    for i in range(n_enc):
        blk, lyr = params['encoder'][f'block_{i}'], f'layers_{i}'
        for m, t in attn:
            flat[f'target/encoder/{lyr}/attention/{t}/kernel'] = \
                blk['self_attn'][m]['kernel']
        for w in ('wi_0', 'wi_1', 'wo'):
            flat[f'target/encoder/{lyr}/mlp/{w}/kernel'] = \
                blk['ff'][w]['kernel']
        flat[f'target/encoder/{lyr}/pre_attention_layer_norm/scale'] = \
            blk['self_norm']['weight']
        flat[f'target/encoder/{lyr}/pre_mlp_layer_norm/scale'] = \
            blk['ff_norm']['weight']
    for i in range(n_dec):
        blk, lyr = params['decoder'][f'block_{i}'], f'layers_{i}'
        for m, t in attn:
            flat[f'target/decoder/{lyr}/self_attention/{t}/kernel'] = \
                blk['self_attn'][m]['kernel']
            flat[f'target/decoder/{lyr}/encoder_decoder_attention/{t}/'
                 'kernel'] = blk['cross_attn'][m]['kernel']
        for w in ('wi_0', 'wi_1', 'wo'):
            flat[f'target/decoder/{lyr}/mlp/{w}/kernel'] = \
                blk['ff'][w]['kernel']
        for norm, mine in (('pre_self_attention_layer_norm', 'self_norm'),
                           ('pre_cross_attention_layer_norm', 'cross_norm'),
                           ('pre_mlp_layer_norm', 'ff_norm')):
            flat[f'target/decoder/{lyr}/{norm}/scale'] = blk[mine]['weight']
    flat['target/encoder/encoder_norm/scale'] = \
        params['encoder']['final_norm']['weight']
    flat['target/decoder/decoder_norm/scale'] = \
        params['decoder']['final_norm']['weight']
    flat['target/encoder/continuous_inputs_projection/kernel'] = \
        params['proj']['kernel']
    flat['target/decoder/token_embedder/embedding'] = \
        params['token_embed']['embedding']
    flat['target/decoder/logits_dense/kernel'] = params['lm_head']['kernel']
    flat['state/param_states/step'] = np.zeros((), np.int32)
    return {k: np.asarray(v) for k, v in flat.items()}


def _nested(flat):
    out = {}
    for key, value in flat.items():
        node, parts = out, key.split('/')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


class TestT5XConverter:
    @pytest.mark.parametrize('depths', [(2, 2), (3, 1)],
                             ids=['symmetric', 'asymmetric'])
    def test_tree_equals_the_jax_converters_and_maps_every_key(self,
                                                               depths):
        """The port's t5x_to_flax_params gives the JAX converter's tree
        (the depths counted per stack), and its state_dict holds exactly
        the port model's keys and shapes."""
        n_enc, n_dec = depths
        kw = dict(SMALL, num_encoder_layers=n_enc, num_decoder_layers=n_dec)
        params = jax.tree.map(np.asarray, _jax_params(JaxConfig(**kw)))
        flat = {k: v for k, v in _t5x_flat(params, n_enc, n_dec).items()
                if not k.startswith('state')}
        mine = convert_weight.t5x_to_flax_params(flat)
        theirs = jax_convert.t5x_to_flax_params(flat)
        assert jax.tree.structure(mine) == jax.tree.structure(theirs)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            np.testing.assert_array_equal(a, b)
        state_dict = convert_weight.state_dict_from_t5x(flat)
        want = MT3(MT3Config(**kw)).state_dict()
        assert set(state_dict) == set(want)
        for key, value in want.items():
            assert state_dict[key].shape == value.shape, key
        assert convert_weight.flatten_state_dict(_nested(flat)) == flat

    def test_cli_pth_gives_the_jax_converters_logits(self, tmp_path):
        """Pickled T5X tree -> `python -m
        mr_mt3_tpu_torch.scripts.convert_weight` -> .pth, loaded strictly
        (no missing, no unexpected key): logits within 1e-5 of the JAX
        converter's Orbax directory loaded by the JAX package."""
        from mr_mt3_tpu.utils import builders as jax_builders
        kw = dict(SMALL, vocab_size=1536, mel_bins=512, num_encoder_layers=2)
        jcfg = JaxConfig(**kw)
        params = jax.tree.map(np.asarray, _jax_params(jcfg, seed=1))
        pk = tmp_path / 't5x_state.pk'
        with open(pk, 'wb') as f:
            pickle.dump(_nested(_t5x_flat(params, 2, 2)), f)
        pth = tmp_path / 'converted.pth'
        out = subprocess.run(
            [sys.executable, '-m', 'mr_mt3_tpu_torch.scripts.convert_weight',
             str(pk), str(pth)], cwd=REPO, capture_output=True, text=True,
            timeout=120)
        assert out.returncode == 0, out.stderr
        model = MT3(MT3Config(**kw))
        model.load_state_dict(load_torch_checkpoint(str(pth)), strict=True)
        loaded = builders.load_weights(str(pth), MT3(MT3Config(**kw)),
                                       strict=True)
        for key, value in model.state_dict().items():
            assert torch.equal(loaded.state_dict()[key], value), key

        orbax_dir = tmp_path / 'jax_converted'
        jax_convert.main(str(pk), str(orbax_dir))
        jparams, step = jax_builders.load_weights(str(orbax_dir),
                                                  JaxMT3(jcfg))
        assert step == 0
        mel, dec = _inputs(kw)
        want = _jax_logits(jcfg, jparams, mel, dec)
        got = _port_logits(loaded, mel, dec)
        print(f'max |logit diff| {np.abs(got - want).max():.3g}')
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)
        # the JAX converter's Orbax directory reads into the port too
        _, step = builders.load_weights_and_step(
            str(orbax_dir), MT3(MT3Config(**kw)), strict=True)
        assert step == 0
