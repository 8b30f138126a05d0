"""The port's Trainer (mr_mt3_tpu_torch.train.trainer) on the CPU: the
mirrors of tests/test_train.py's loop tests (overfit, checkpoints and their
policy, prune safety, monitor and cadence, validate weighting, resume) and
bucket_targets, on the fp32 TINY model (tests/test_train.py:31, dropout 0)
with seeded port weights."""

import os

import numpy as np
import pytest
import torch

from mr_mt3_tpu_torch.audio import SpectrogramConfig
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.train import losses, optim
from mr_mt3_tpu_torch.train.trainer import (
    CheckpointPolicy,
    Trainer,
    batch_to_device,
    batch_to_mel,
    bucket_targets,
    create_train_state,
    load_checkpoint,
    make_train_step,
)
from mr_mt3_tpu_torch.utils.builders import init_params

TINY = MT3Config(vocab_size=1536, d_model=32, d_kv=8, d_ff=48, num_heads=4,
                 num_encoder_layers=1, num_decoder_layers=1, mel_bins=512,
                 dropout_rate=0.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tier-1 run puts six test files at once on one machine's cores,
    where torch's default of one intra-op thread per core oversubscribes
    them many times over and slows these small steps tens of times: one
    thread per test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_batch(rng, rows=4, with_prev=False, length=128):
    """tests/test_train.py's _tiny_batch (20 random tokens, EOS, -100
    padding), its targets `length` long: 128, the bucket Trainer.fit trims
    them to, unless a test needs the datasets' 1024."""
    batch = {
        'audio': rng.normal(size=(rows, 256 * 128)).astype(np.float32) * 0.1,
        'valid_frames': np.full((rows,), 256, np.int32),
        'targets': np.concatenate([
            rng.integers(3, 1391, (rows, 20)),
            np.ones((rows, 1), np.int64),
            np.full((rows, length - 21), -100, np.int64)], axis=1),
    }
    if with_prev:
        batch['targets_prev'] = batch['targets'].copy()
    return batch


def _state(lr=1e-3, cfg=TINY, seed=0, **kw):
    model = init_params(MT3(cfg), seed=seed)
    return create_train_state(model, optim.make_optimizer(
        lr, use_schedule=False, **kw))


def _trainer(state, tmp_path, name='run', **kw):
    return Trainer(state.model, state.optimizer,
                   out_dir=str(tmp_path / name), **kw)


class TestTrainStep:
    def test_loss_decreases_overfit(self):
        state = _state(3e-3)
        step = make_train_step()
        batch = _tiny_batch(np.random.default_rng(2))
        first = float(step(state, batch, None)['loss'])
        for _ in range(29):
            metrics = step(state, batch, None)
        last = float(metrics['loss'])
        assert state.step == 30
        assert last < first * 0.5, (first, last)

    def test_clip_norm_bounds_update_and_logs_grad_norm(self):
        batch = _tiny_batch(np.random.default_rng(5))
        deltas = {}
        for name, clip in (('unclipped', None), ('clipped', 1e-4)):
            state = _state(1e-3, weight_decay=0.0, clip_norm=clip)
            before = [p.detach().clone() for p in state.model.parameters()]
            metrics = make_train_step()(state, batch, None)
            gnorm = float(metrics['grad_norm'])
            assert np.isfinite(gnorm) and gnorm > 0
            deltas[name] = float(optim.global_norm(
                [p.detach() - b for p, b in zip(state.model.parameters(),
                                                before)]))
        assert deltas['clipped'] <= deltas['unclipped'] * 1.001
        assert gnorm > 1e-4 * 10      # the logged norm is pre-clip

    def test_segmem_model_train_step(self):
        state = _state(cfg=TINY.replace(segmem_variant='encoder_append',
                                        segmem_length=8))
        metrics = make_train_step()(
            state, _tiny_batch(np.random.default_rng(3), with_prev=True),
            None)
        assert np.isfinite(float(metrics['loss']))

    def test_dropout_masks_follow_seed_and_step(self):
        """One seed at one step draws the same masks; another step or
        another seed draws others; no seed, no dropout."""
        cfg = TINY.replace(dropout_rate=0.2)
        batch = _tiny_batch(np.random.default_rng(6), rows=2)

        def first_loss(seed, step):
            state = _state(cfg=cfg)
            state.step = step
            return float(make_train_step()(state, batch, seed)['loss'])
        assert first_loss(3, 0) == first_loss(3, 0)
        assert first_loss(3, 1) != first_loss(3, 0)
        assert first_loss(4, 0) != first_loss(3, 0)
        model = _state(cfg=cfg).model.eval()
        b = batch_to_device(batch, torch.device('cpu'))
        mel = batch_to_mel(b['audio'], b['valid_frames'], SpectrogramConfig())
        with torch.no_grad():
            plain = losses.cross_entropy_loss(
                model(mel, labels=b['targets']), b['targets'])
        assert first_loss(None, 0) == float(plain)

    def test_weighted_loss_logs(self):
        state = _state()
        metrics = make_train_step(loss_type='weighted')(
            state, _tiny_batch(np.random.default_rng(4)), None)
        assert {'loss', 'grad_norm', 'loss_other', 'loss_inst'} == \
            set(metrics)


class TestBucketTargets:
    def test_trim_is_loss_and_grad_identical(self):
        model = init_params(MT3(TINY), seed=0)
        batch = _tiny_batch(np.random.default_rng(31), rows=2, length=1024)
        trimmed = bucket_targets(batch)
        assert trimmed['targets'].shape[1] == 128  # 21 real -> bucket 128
        assert batch['targets'].shape[1] == 1024   # input untouched
        b = batch_to_device(batch, torch.device('cpu'))
        mel = batch_to_mel(b['audio'], b['valid_frames'],
                           SpectrogramConfig())

        def loss_of(targets):
            t = torch.from_numpy(targets)
            loss = losses.cross_entropy_loss(model(mel, labels=t), t)
            return loss, torch.autograd.grad(loss, list(model.parameters()))
        full_loss, full_grad = loss_of(batch['targets'])
        trim_loss, trim_grad = loss_of(trimmed['targets'])
        assert full_loss.item() == pytest.approx(trim_loss.item(), rel=1e-6)
        for a, b in zip(full_grad, trim_grad):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)

    def test_targets_prev_not_trimmed(self):
        batch = _tiny_batch(np.random.default_rng(32), rows=2,
                            with_prev=True, length=1024)
        assert bucket_targets(batch)['targets_prev'].shape[1] == 1024

    def test_all_pad_batch(self):
        batch = {'targets': np.full((2, 1024), -100, np.int64)}
        assert bucket_targets(batch)['targets'].shape[1] == 128

    def test_batch_internal_segmem_not_bucketed(self, tmp_path):
        state = _state(cfg=TINY.replace(segmem_variant='encoder_append',
                                        segmem_length=8))
        trainer = _trainer(state, tmp_path)
        assert not trainer._can_bucket(
            _tiny_batch(np.random.default_rng(33), rows=2))
        assert trainer._can_bucket(
            _tiny_batch(np.random.default_rng(34), rows=2, with_prev=True))
        vanilla = _state()
        assert _trainer(vanilla, tmp_path, 'run2')._can_bucket(
            _tiny_batch(np.random.default_rng(33), rows=2))


class TestTrainerLoop:
    def test_fit_with_val_and_checkpoints(self, tmp_path):
        state = _state()
        rng = np.random.default_rng(7)
        batches = [_tiny_batch(rng, rows=2) for _ in range(2)]
        trainer = _trainer(state, tmp_path, log_every_n_steps=1)
        state = trainer.fit(state, batches, val_loader=batches, num_epochs=2)
        assert state.step == 4
        ckpts = os.listdir(trainer._ckpt_dir)
        assert 'last' in ckpts
        assert any(c.startswith('epoch=') for c in ckpts)
        lines = open(tmp_path / 'run' / 'logs' / 'metrics.jsonl').readlines()
        assert any('val_loss' in ln for ln in lines)
        assert sum('train_loss' in ln for ln in lines) == 4
        last = load_checkpoint(os.path.join(trainer._ckpt_dir, 'last'))
        assert last['step'] == 4
        for name, value in state.model.state_dict().items():
            assert torch.equal(last['params'][name], value)

    def test_lr_logged_is_the_one_applied(self, tmp_path):
        sched = optim.cosine_schedule_with_warmup(1e-3, 2, 10)
        model = init_params(MT3(TINY), seed=0)
        state = create_train_state(model, optim.make_optimizer(
            1e-3, schedule=sched))
        trainer = Trainer(model, state.optimizer,
                          out_dir=str(tmp_path / 'run'),
                          log_every_n_steps=1, lr_schedule=sched)
        trainer.fit(state, [_tiny_batch(np.random.default_rng(8), rows=2)],
                    num_epochs=3)
        import json
        lrs = [json.loads(ln)['lr'] for ln in
               open(tmp_path / 'run' / 'logs' / 'metrics.jsonl')]
        assert lrs == pytest.approx([sched(0), sched(1), sched(2)])


class TestCheckpointPolicy:
    def test_prune_spares_foreign_checkpoints(self, tmp_path):
        """A resumed run starts with empty top-k state; pruning removes
        only the top-k files THIS run created."""
        state = _state()
        trainer = _trainer(state, tmp_path,
                           checkpoint_policy=CheckpointPolicy(save_top_k=1))
        os.makedirs(trainer._ckpt_dir)
        for foreign in ('epoch=9-val_loss=0.1000', 'final'):
            open(os.path.join(trainer._ckpt_dir, foreign), 'wb').close()
        trainer._maybe_save_topk(state, epoch=0, metrics={'val_loss': 0.5})
        trainer._maybe_save_topk(state, epoch=1, metrics={'val_loss': 0.4})
        ckpts = set(os.listdir(trainer._ckpt_dir))
        assert {'epoch=9-val_loss=0.1000', 'final', 'last',
                'epoch=1-val_loss=0.4000'} == ckpts

    def test_missing_monitor_skips_ranking(self, tmp_path, capsys):
        state = _state(1e-5)
        trainer = _trainer(state, tmp_path,
                           checkpoint_policy=CheckpointPolicy(
                               monitor='val_f1_flat', mode='max',
                               save_top_k=1))
        trainer._maybe_save_topk(state, epoch=0, metrics={'val_loss': 1.0})
        assert 'skipping top-k' in capsys.readouterr().out
        assert set(os.listdir(trainer._ckpt_dir)) == {'last'}

    def test_every_n_epochs_matches_lightning(self, tmp_path):
        """(epoch + 1) % n == 0: with n = 2 over 3 epochs, epoch 1 only."""
        state = _state()
        batches = [_tiny_batch(np.random.default_rng(7), rows=2)]
        trainer = _trainer(state, tmp_path,
                           checkpoint_policy=CheckpointPolicy(
                               every_n_epochs=2))
        trainer.fit(state, batches, val_loader=batches, num_epochs=3)
        saved = sorted(c for c in os.listdir(trainer._ckpt_dir)
                       if c.startswith('epoch='))
        assert saved and all(c.startswith('epoch=1-') for c in saved)


class TestValidateWeighting:
    def test_val_loss_weights_tokens(self, tmp_path):
        state = _state()
        rng = np.random.default_rng(21)
        b1 = _tiny_batch(rng, rows=4)
        b2 = _tiny_batch(rng, rows=1)
        b2['targets'][:, 10:] = -100
        got = _trainer(state, tmp_path).validate(state, [b1, b2])
        model = state.model.eval()

        def ce_and_count(batch):
            b = batch_to_device(batch, torch.device('cpu'))
            mel = batch_to_mel(b['audio'], b['valid_frames'],
                               SpectrogramConfig())
            with torch.no_grad():
                logits = model(mel, labels=b['targets'])
            n = int((batch['targets'] != -100).sum())
            return float(losses.cross_entropy_loss(logits,
                                                   b['targets'])) * n, n
        s1, n1 = ce_and_count(b1)
        s2, n2 = ce_and_count(b2)
        assert got == pytest.approx((s1 + s2) / (n1 + n2), rel=1e-5)


class TestResume:
    def test_full_state_resume(self, tmp_path):
        """Params, optimizer state and step survive save/restore, and
        training continues exactly as without the interruption."""
        state = _state()
        trainer = _trainer(state, tmp_path)
        step = make_train_step()
        batch = _tiny_batch(np.random.default_rng(9))
        for _ in range(3):
            step(state, batch, None)
        trainer.save_checkpoint(state, 'resume_test')
        assert set(load_checkpoint(os.path.join(
            trainer._ckpt_dir, 'resume_test'))) == {'params', 'step',
                                                    'opt_state'}
        fresh = _state(seed=5)
        restored = trainer.restore_state('resume_test', fresh)
        assert restored.step == 3
        assert restored.optimizer.count == 3
        assert any(float(m.abs().sum()) > 0 for m in restored.optimizer.mu)
        m1 = make_train_step()(restored, batch, None)
        m2 = step(state, batch, None)
        assert float(m1['loss']) == float(m2['loss'])
        for a, b in zip(restored.model.parameters(),
                        state.model.parameters()):
            assert torch.equal(a, b)

    def test_resume_with_dropout_equals_uninterrupted(self, tmp_path):
        """Dropout 0.1: 2 steps, 'last', a resume into fresh weights and 2
        more steps give the parameters of 4 steps straight (each step's
        masks follow from the seed and the step)."""
        cfg = TINY.replace(dropout_rate=0.1)
        rng = np.random.default_rng(12)
        batches = [_tiny_batch(rng, rows=2) for _ in range(2)]
        straight = _state(cfg=cfg)
        _trainer(straight, tmp_path, 'straight').fit(straight, batches,
                                                     num_epochs=2)
        first = _state(cfg=cfg)
        _trainer(first, tmp_path, 'resumed').fit(first, batches, num_epochs=1)
        resumed = _state(cfg=cfg, seed=5)
        trainer = _trainer(resumed, tmp_path, 'resumed')
        trainer.restore_state('last', resumed)
        trainer.fit(resumed, batches, num_epochs=2, start_epoch=1)
        assert straight.step == resumed.step == 4
        for a, b in zip(straight.model.parameters(),
                        resumed.model.parameters()):
            assert torch.equal(a, b)

    def test_grad_accum_counts_optimizer_steps(self, tmp_path):
        """MultiSteps(k=2): four train steps are four micro-steps of the
        state and two optimizer steps; the checkpoint carries both."""
        model = init_params(MT3(TINY), seed=0)
        opt = optim.MultiSteps(optim.make_optimizer(1e-3,
                                                    use_schedule=False), 2)
        state = create_train_state(model, opt)
        step = make_train_step()
        batch = _tiny_batch(np.random.default_rng(10), rows=2)
        before = [p.detach().clone() for p in model.parameters()]
        step(state, batch, None)
        assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                     before))
        for _ in range(3):
            step(state, batch, None)
        assert state.step == 4 and opt.count == 2
        trainer = _trainer(state, tmp_path)
        trainer.save_checkpoint(state, 'acc')
        twin = create_train_state(init_params(MT3(TINY), seed=3),
                                  optim.MultiSteps(optim.make_optimizer(
                                      1e-3, use_schedule=False), 2))
        trainer.restore_state('acc', twin)
        assert twin.step == 4 and twin.optimizer.count == 2
