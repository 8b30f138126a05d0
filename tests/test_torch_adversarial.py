"""The port's FGSM and PGD-linf (models/adversarial.py) against the JAX
package's (mr_mt3_tpu/models/adversarial.py) on the CPU, on
tests/test_scripts_tools.py:309's TestAdversarial config and inputs, the
same weights in both: the FGSM step equal wherever |grad| > 1e-6, PGD
within 1e-6, the loss not lowered; vanilla and with the batch-internal
segment memory."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mr_mt3_tpu.models import MT3 as JaxMT3
from mr_mt3_tpu.models import MT3Config as JaxConfig
from mr_mt3_tpu.models import adversarial as jadv
from mr_mt3_tpu.train.losses import cross_entropy_loss as jax_ce
from mr_mt3_tpu_torch.models import MT3, MT3Config, adversarial
from mr_mt3_tpu_torch.utils.checkpoint_import import (
    state_dict_from_jax_params,
)

CFG = dict(vocab_size=64, d_model=16, d_kv=4, d_ff=24, num_heads=4,
           num_encoder_layers=1, num_decoder_layers=1, mel_bins=8,
           dropout_rate=0.0)
VARIANTS = {'vanilla': {},
            'withprev': dict(segmem_variant='encoder_append',
                             segmem_length=4)}
GRAD_FLOOR = 1e-6
PGD_ATOL = 1e-6


def _setup(variant):
    kw = dict(CFG, **VARIANTS[variant])
    jmodel = JaxMT3(JaxConfig(**kw))
    inputs = np.random.default_rng(0).normal(size=(2, 6, 8)).astype(
        np.float32)
    labels = np.random.default_rng(1).integers(3, 60, (2, 5))
    extra = ({'targets_prev': jnp.zeros((2, 3), jnp.int32)}
             if variant == 'withprev' else {})
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(inputs),
        decoder_input_ids=jnp.zeros((1, 3), jnp.int32), **extra)
    model = MT3(MT3Config(**kw))
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree.map(np.asarray, variables['params']), model.cfg),
        strict=True)
    return jmodel, variables, model, inputs, labels


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_fgsm_and_pgd_match_jax(variant):
    jmodel, variables, model, inputs, labels = _setup(variant)
    x, y = torch.from_numpy(inputs), torch.from_numpy(labels)
    jx, jy = jnp.asarray(inputs), jnp.asarray(labels)

    def jloss(v):
        return jax_ce(jmodel.apply(variables, v, labels=jy,
                                   deterministic=True), jy)

    # one jitted program: op-by-op dispatch compiles every primitive alone
    @jax.jit
    def jax_side(v):
        return (jax.grad(jloss)(v), jloss(v),
                jadv.fgsm(jmodel, variables, v, jy, epsilon=0.1),
                jadv.pgd_linf(jmodel, variables, v, jy, epsilon=0.05,
                              alpha=0.02, num_iter=3))
    jgrad, jbase, want, want2 = map(np.asarray, jax_side(jx))
    grad = adversarial.input_gradient(model, x, y).numpy()
    print(f'{variant}: max |grad diff| {np.abs(grad - jgrad).max():.3g} '
          f'of {np.abs(jgrad).max():.3g}')
    np.testing.assert_allclose(grad, jgrad, atol=1e-6)

    delta = adversarial.fgsm(model, x, y, epsilon=0.1).numpy()
    assert delta.shape == inputs.shape
    vals = np.abs(delta)
    assert np.all((vals < 1e-6) | (np.abs(vals - 0.1) < 1e-6))
    live = np.abs(jgrad) > GRAD_FLOOR
    assert live.mean() > 0.9
    np.testing.assert_array_equal(delta[live], want[live])

    delta2 = adversarial.pgd_linf(model, x, y, epsilon=0.05, alpha=0.02,
                                  num_iter=3).numpy()
    assert np.abs(delta2).max() <= 0.05 + 1e-6
    np.testing.assert_allclose(delta2, want2, atol=PGD_ATOL)

    base = float(adversarial.input_loss(model, x, y))
    assert base == pytest.approx(float(jbase), rel=1e-5)
    assert float(adversarial.input_loss(
        model, x + torch.from_numpy(delta), y)) >= base - 1e-3
    assert float(adversarial.input_loss(
        model, x + torch.from_numpy(delta2), y)) >= base - 1e-3


def test_keeps_no_parameter_gradient_and_the_mode():
    _, _, model, inputs, labels = _setup('vanilla')
    model.train()
    adversarial.fgsm(model, torch.from_numpy(inputs),
                     torch.from_numpy(labels))
    assert model.training
    assert all(p.grad is None for p in model.parameters())
