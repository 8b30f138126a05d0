"""The port's training math (mr_mt3_tpu_torch.train) against the JAX
package's (mr_mt3_tpu.train) on the CPU, on the same numpy inputs: losses,
schedules, AdamW / clip / MultiSteps against optax, and the train step of
the fp32 TINY model (tests/test_train.py:31, dropout 0), vanilla and with
the previous segment's memory: loss, every gradient (mapped through
state_dict_from_jax_params) and the parameters after three steps; and the
model's training-only surface: dropout, labels and remat. (The bf16 step
through the attention kernels is in test_torch_train_attention.py.)"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mr_mt3_tpu.models import MT3 as JaxMT3
from mr_mt3_tpu.models import MT3Config as JaxConfig
from mr_mt3_tpu.train import losses as jlosses
from mr_mt3_tpu.train import optim as joptim
from mr_mt3_tpu.train.trainer import create_train_state as jax_state
from mr_mt3_tpu.train.trainer import make_train_step as jax_train_step
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.models.mt3 import shift_right
from mr_mt3_tpu_torch.train import losses, optim
from mr_mt3_tpu_torch.train.trainer import (
    create_train_state,
    make_train_step,
)
from mr_mt3_tpu_torch.utils.checkpoint_import import (
    state_dict_from_jax_params,
)
from tests.torch_threads import two_torch_threads  # noqa: F401

TINY = dict(vocab_size=1536, d_model=32, d_kv=8, d_ff=48, num_heads=4,
            num_encoder_layers=1, num_decoder_layers=1, mel_bins=512,
            dropout_rate=0.0)
WITHPREV = dict(segmem_variant='encoder_append', segmem_length=8)

# fp32 step: the frontends and the models agree to ~1e-7 relative; the
# loss within 1e-5 relative (read 6e-8), each gradient within 1e-4 of its
# leaf's largest |value| (read 1.9e-6); the parameters after three AdamW
# steps within 1e-5 (read 9.7e-7); readings printed with -s
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5


def _batch(seed, rows=2, with_prev=False, length=1024, real=20):
    """tests/test_train.py's _tiny_batch: noise audio, `real` random
    tokens, EOS, -100 padding."""
    rng = np.random.default_rng(seed)
    batch = {
        'audio': rng.normal(size=(rows, 256 * 128)).astype(np.float32) * 0.1,
        'valid_frames': np.full((rows,), 256, np.int32),
        'targets': np.concatenate([
            rng.integers(3, 1391, (rows, real)),
            np.ones((rows, 1), np.int64),
            np.full((rows, length - real - 1), -100, np.int64)], axis=1),
    }
    if with_prev:
        batch['targets_prev'] = np.roll(batch['targets'], 3, axis=0)
    return batch


def _jax_params(jcfg, seed=0):
    kw = ({'targets_prev': jnp.zeros((1, 8), jnp.int32)}
          if jcfg.has_segmem else {})
    return JaxMT3(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 256, 512)),
        decoder_input_ids=jnp.zeros((1, 8), jnp.int32), **kw)['params']


def _port_model(params, cfg):
    model = MT3(cfg)
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), cfg), strict=True)
    return model


def _grads_by_name(jgrads, cfg):
    return state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads), cfg)


class TestLosses:
    def test_cross_entropy_matches_jax(self):
        rng = np.random.default_rng(0)
        logits = rng.normal(size=(3, 7, 1536)).astype(np.float32)
        targets = rng.integers(0, 1536, (3, 7))
        targets[0, 5:] = -100
        want = float(jlosses.cross_entropy_loss(jnp.asarray(logits),
                                                jnp.asarray(targets)))
        got = float(losses.cross_entropy_loss(torch.from_numpy(logits),
                                              torch.from_numpy(targets)))
        assert got == pytest.approx(want, rel=1e-6)

    def test_weighted_loss_and_logs_match_jax(self):
        rng = np.random.default_rng(1)
        logits = rng.normal(size=(2, 9, 1536)).astype(np.float32)
        targets = rng.integers(3, 1391, (2, 9))
        targets[:, 4] = 1140
        targets[:, 8] = -100
        want, wlogs = jlosses.weighted_instrument_loss(
            jnp.asarray(logits), jnp.asarray(targets))
        got, logs = losses.weighted_instrument_loss(
            torch.from_numpy(logits), torch.from_numpy(targets))
        assert float(got) == pytest.approx(float(want), rel=1e-6)
        assert set(logs) == set(wlogs) == {'loss_other', 'loss_inst'}
        for key in logs:
            assert float(logs[key]) == pytest.approx(float(wlogs[key]),
                                                     rel=1e-6)

    def test_constants_and_all_ignored(self):
        assert (losses.IGNORE_INDEX, losses.INSTRUMENT_TOKEN_LO,
                losses.INSTRUMENT_TOKEN_HI) == (
            jlosses.IGNORE_INDEX, jlosses.INSTRUMENT_TOKEN_LO,
            jlosses.INSTRUMENT_TOKEN_HI)
        logits = torch.zeros((1, 4, 8))
        targets = torch.full((1, 4), -100)
        assert float(losses.cross_entropy_loss(logits, targets)) == 0.0


class TestSchedules:
    @pytest.mark.parametrize('warmup,total,min_lr', [(10, 100, 1e-4),
                                                     (0, 50, 0.0),
                                                     (64500, 1031200, 1e-4)])
    def test_cosine_matches_jax(self, warmup, total, min_lr):
        mine = optim.cosine_schedule_with_warmup(2e-4, warmup, total,
                                                 min_lr_multiplier=min_lr)
        ref = joptim.cosine_schedule_with_warmup(2e-4, warmup, total,
                                                 min_lr_multiplier=min_lr)
        for step in list(range(0, 130)) + [warmup, total, total + 7]:
            assert mine(step) == pytest.approx(float(ref(step)), rel=1e-6,
                                               abs=1e-12), step

    def test_noam_and_warmup_constant_match_jax(self):
        for mine, ref in (
                (optim.noam_schedule(0.004, 100), joptim.noam_schedule(
                    0.004, 100)),
                (optim.linear_warmup_to_constant(10, 1e-3),
                 joptim.linear_warmup_to_constant(10, 1e-3))):
            for step in range(0, 40, 3):
                assert mine(step) == pytest.approx(float(ref(step)),
                                                   rel=1e-6), step


def _opt_case(seed, n_steps, shapes=((7, 5), (5,), (3, 4, 2))):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * (0.5 + i)
              for s in shapes] for i in range(n_steps)]
    return params, grads


def _run_optax(tx, params, grads):
    p = [jnp.asarray(a) for a in params]
    state = tx.init(p)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, p)
        p = optax.apply_updates(p, upd)
    return [np.asarray(a) for a in p]


def _run_port(opt, params, grads):
    p = [torch.tensor(a) for a in params]
    opt.init(p)
    for g in grads:
        opt.step([torch.tensor(a) for a in g])
    return [a.numpy() for a in p]


# AdamW against optax over 5 steps: the two round the same f32 operations
# in other places (bias correction in f64 here); at most ~1e-7 of a value
OPT_ATOL = 1e-6


class TestOptimizer:
    @pytest.mark.parametrize('clip', [None, 0.5, 1e3])
    @pytest.mark.parametrize('scheduled', [False, True])
    def test_adamw_matches_optax(self, clip, scheduled):
        params, grads = _opt_case(0, 5)
        sched = (optim.cosine_schedule_with_warmup(1e-2, 2, 10, 1e-4)
                 if scheduled else None)
        jsched = (joptim.cosine_schedule_with_warmup(1e-2, 2, 10, 1e-4)
                  if scheduled else None)
        want = _run_optax(joptim.make_optimizer(
            1e-2, use_schedule=scheduled, schedule=jsched, clip_norm=clip),
            params, grads)
        got = _run_port(optim.make_optimizer(
            1e-2, use_schedule=scheduled, schedule=sched, clip_norm=clip),
            params, grads)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=OPT_ATOL)

    def test_schedule_read_at_the_pre_increment_count(self):
        """The first update uses lr(0): with a warmup from 0 it moves
        nothing but the weight decay's zero share; the second uses lr(1)."""
        seen = []

        def sched(count):
            seen.append(count)
            return 1e-2 * count
        opt = optim.make_optimizer(1e-2, schedule=sched, weight_decay=0.0)
        p = [torch.ones(3)]
        opt.init(p)
        opt.step([torch.ones(3)])
        assert torch.equal(p[0], torch.ones(3))
        opt.step([torch.ones(3)])
        assert seen == [0, 1] and opt.count == 2
        assert not torch.equal(p[0], torch.ones(3))

    def test_clip_is_optax_formula_not_clip_grad_norm(self):
        """Above the threshold the gradients are g / |g| * c exactly
        (torch's clip_grad_norm_ adds 1e-6 to the norm)."""
        opt = optim.AdamW(1.0, clip_norm=0.5)
        g = [torch.tensor([3.0, 4.0])]
        opt.init([torch.zeros(2)])
        norm = optim.global_norm(g)
        assert float(norm) == 5.0
        opt.step(g)
        # Adam's first step is g_c / |g_c| elementwise (plus eps): the
        # clipped gradient entered it; its moment holds (1 - b1) g_c
        np.testing.assert_allclose(opt.mu[0].numpy(),
                                   0.1 * np.array([0.3, 0.4]), rtol=1e-6)

    @pytest.mark.parametrize('k', [2, 3])
    def test_multisteps_matches_optax(self, k):
        params, grads = _opt_case(1, 2 * k + 1)
        jsched = joptim.cosine_schedule_with_warmup(1e-2, 1, 8, 1e-4)
        tx = optax.MultiSteps(joptim.make_optimizer(
            1e-2, schedule=jsched, clip_norm=0.7), every_k_schedule=k)
        want = _run_optax(tx, params, grads)
        opt = optim.MultiSteps(optim.make_optimizer(
            1e-2, schedule=optim.cosine_schedule_with_warmup(1e-2, 1, 8,
                                                             1e-4),
            clip_norm=0.7), k)
        got = _run_port(opt, params, grads)
        assert opt.count == 2 and opt.mini_step == 1
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=OPT_ATOL)

    def test_state_dict_round_trip(self):
        params, grads = _opt_case(2, 4)
        opt = optim.MultiSteps(optim.make_optimizer(1e-2, use_schedule=False),
                               2)
        p = [torch.tensor(a) for a in params]
        opt.init(p)
        for g in grads[:3]:
            opt.step([torch.tensor(a) for a in g])
        saved = opt.state_dict()
        twin = optim.MultiSteps(optim.make_optimizer(1e-2,
                                                     use_schedule=False), 2)
        q = [t.clone() for t in p]
        twin.init(q)
        twin.load_state_dict(saved)
        for o in (opt, twin):
            o.step([torch.tensor(a) for a in grads[3]])
        for a, b in zip(p, q):
            assert torch.equal(a, b)


def _jax_loss_and_grads(jmodel, params, batch):
    from mr_mt3_tpu.audio import SpectrogramConfig
    from mr_mt3_tpu.train.trainer import batch_to_mel

    def fn(params):
        mel = batch_to_mel(jnp.asarray(batch['audio']),
                           jnp.asarray(batch['valid_frames']),
                           SpectrogramConfig())
        prev = batch.get('targets_prev')
        logits = jmodel.apply(
            {'params': params}, mel, labels=jnp.asarray(batch['targets']),
            targets_prev=None if prev is None else jnp.asarray(prev),
            deterministic=True)
        return jlosses.cross_entropy_loss(logits,
                                          jnp.asarray(batch['targets']))
    return jax.value_and_grad(fn)(params)


def _port_loss_and_grads(model, batch):
    from mr_mt3_tpu_torch.audio import SpectrogramConfig
    from mr_mt3_tpu_torch.train.trainer import batch_to_device, batch_to_mel
    b = batch_to_device(batch, torch.device('cpu'))
    mel = batch_to_mel(b['audio'], b['valid_frames'], SpectrogramConfig())
    logits = model(mel, labels=b['targets'],
                   targets_prev=b.get('targets_prev'))
    loss = losses.cross_entropy_loss(logits, b['targets'])
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    return loss, dict(zip(names, grads))


class TestTrainStepAgainstJax:
    @pytest.mark.parametrize('extra', [{}, WITHPREV],
                             ids=['vanilla', 'withprev'])
    def test_f32_loss_and_grads(self, extra):
        jcfg, cfg = JaxConfig(**TINY, **extra), MT3Config(**TINY, **extra)
        params = _jax_params(jcfg)
        batch = _batch(3, with_prev=bool(extra))
        jloss, jgrads = _jax_loss_and_grads(JaxMT3(jcfg), params, batch)
        loss, grads = _port_loss_and_grads(_port_model(params, cfg), batch)
        print('loss', float(loss.detach()), float(jloss))
        assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
        want = _grads_by_name(jgrads, cfg)
        assert set(want) == set(grads)
        worst = 0.0
        for name, w in want.items():
            err = float((grads[name] - w).abs().max())
            scale = float(w.abs().max())
            worst = max(worst, err / max(scale, 1e-30))
            assert err <= GRAD_RTOL * scale, name
        print('worst grad err / leaf max', worst)

    @pytest.mark.parametrize('extra', [{}, WITHPREV],
                             ids=['vanilla', 'withprev'])
    def test_three_adamw_steps_match_jax(self, extra):
        """make_train_step on both sides, the cosine schedule (warmup 2)
        and clip_norm 1.0 on: losses, pre-clip gradient norms, and the
        parameters after three steps."""
        jcfg, cfg = JaxConfig(**TINY, **extra), MT3Config(**TINY, **extra)
        params = _jax_params(jcfg, seed=1)
        lr = 1e-3
        jopt = joptim.make_optimizer(lr, warmup_steps=2, total_steps=10,
                                     clip_norm=1.0)
        state = jax_state(params, jopt)
        jstep = jax_train_step(JaxMT3(jcfg), jopt)
        model = _port_model(params, cfg)
        opt = optim.make_optimizer(lr, warmup_steps=2, total_steps=10,
                                   clip_norm=1.0)
        pstate = create_train_state(model, opt)
        step = make_train_step()
        for i in range(3):
            batch = _batch(10 + i, with_prev=bool(extra), length=128)
            state, jm = jstep(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                              jax.random.PRNGKey(0))
            pm = step(pstate, batch, None)
            assert float(pm['loss']) == pytest.approx(float(jm['loss']),
                                                      rel=LOSS_RTOL)
            assert float(pm['grad_norm']) == pytest.approx(
                float(jm['grad_norm']), rel=1e-4)
        assert pstate.step == int(state.step) == 3
        want = _grads_by_name(state.params, cfg)
        got = model.state_dict()
        worst = 0.0
        for name, w in want.items():
            err = float((got[name] - w).abs().max())
            worst = max(worst, err)
            assert err <= PARAM_ATOL, name
        print('worst param diff after 3 steps', worst)


class TestModelTrainingSurface:
    def test_shift_right_matches_jax(self):
        from mr_mt3_tpu.models.mt3 import shift_right as jshift
        labels = np.array([[5, 6, -100, 7], [-100, 1, 2, 3]])
        np.testing.assert_array_equal(
            shift_right(torch.from_numpy(labels)).numpy(),
            np.asarray(jshift(jnp.asarray(labels))))

    def test_labels_equal_shifted_decoder_inputs(self):
        model = MT3(MT3Config(**TINY)).eval()
        batch = _batch(6)
        mel = torch.rand((2, 256, 512))
        labels = torch.from_numpy(batch['targets'])
        with torch.no_grad():
            a = model(mel, labels=labels)
            b = model(mel, shift_right(labels))
        assert torch.equal(a, b)
        with pytest.raises(ValueError, match='labels'):
            model(mel)

    def test_dropout_only_with_a_generator_in_train_mode(self):
        cfg = MT3Config(**dict(TINY, dropout_rate=0.3))
        model = MT3(cfg)
        mel = torch.rand((2, 256, 512))
        labels = torch.from_numpy(_batch(7)['targets'][:, :32])
        with torch.no_grad():
            plain = model(mel, labels=labels)
            assert torch.equal(model(mel, labels=labels), plain)
            g1 = torch.Generator().manual_seed(4)
            g2 = torch.Generator().manual_seed(4)
            a = model(mel, labels=labels, generator=g1)
            b = model(mel, labels=labels, generator=g2)
            assert torch.equal(a, b) and not torch.equal(a, plain)
            model.eval()
            assert torch.equal(model(mel, labels=labels,
                                     generator=g1), plain)

    def test_dropout_keeps_one_minus_rate_scaled(self):
        from mr_mt3_tpu_torch.models.mt3 import dropout
        x = torch.ones(200_000)
        y = dropout(x, 0.1, torch.Generator().manual_seed(0))
        kept = y != 0
        assert abs(float(kept.float().mean()) - 0.9) < 5e-3
        torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))

    @pytest.mark.parametrize('extra', [{}, WITHPREV],
                             ids=['vanilla', 'withprev'])
    def test_remat_gradients_equal_non_remat(self, extra):
        """remat (torch.utils.checkpoint per block) with dropout on: the
        recomputation replays the masks, so loss and gradients equal the
        non-remat model's on the same generator seed."""
        cfg = MT3Config(**dict(TINY, dropout_rate=0.2, num_decoder_layers=2),
                        **extra)
        model = MT3(cfg)
        twin = MT3(cfg.replace(remat=True))
        twin.load_state_dict(model.state_dict())
        mel = torch.rand((2, 256, 512))
        labels = torch.from_numpy(_batch(8)['targets'][:, :48])
        out = []
        for m in (model, twin):
            gen = torch.Generator().manual_seed(9)
            loss = losses.cross_entropy_loss(
                m(mel, labels=labels, generator=gen), labels)
            grads = torch.autograd.grad(loss, list(m.parameters()))
            out.append((loss, grads, gen.get_state()))
        assert torch.equal(out[0][0], out[1][0])
        for a, b in zip(out[0][1], out[1][1]):
            assert torch.equal(a, b)
        assert torch.equal(out[0][2], out[1][2])

    def test_config_reads_dropout_and_remat(self):
        from mr_mt3_tpu_torch.models.config import config_from_dict
        assert MT3Config().dropout_rate == 0.1 and not MT3Config().remat
        cfg = config_from_dict({'dropout_rate': 0.25, 'remat': True})
        assert cfg.dropout_rate == 0.25 and cfg.remat
