"""Data-parallel training and evaluation of the port across processes, on
the CPU: two gloo ranks (tests/ddp_rank.py, started as subprocesses that
meet through a file store) against the JAX package's one program over a
two-device mesh (tests/conftest.py's virtual CPU devices) on the same
global batches, and against the port in one process.

  * DDP steps: fp32, dropout 0, a partial batch (3 rows, padded to 4) whose
    two slices hold 61 and 6 real tokens; 'ce' and 'weighted' losses: loss,
    grad_norm and the parameters after three AdamW steps within
    tests/test_torch_train.py's tolerances, and equal on both ranks;
  * validation sums equal to one process's; the checkpoint written once;
  * get_scores on two ranks: the same dict on both, equal to one process's
    and to the JAX get_scores; a rank whose song cannot be read does not
    hold the other at the barrier; a rank whose decodes raise makes every
    rank raise.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from mr_mt3_tpu.infer.scores import get_scores as jax_get_scores
from mr_mt3_tpu.models import MT3 as JaxMT3
from mr_mt3_tpu.models import MT3Config as JaxConfig
from mr_mt3_tpu.parallel import make_mesh as jax_make_mesh
from mr_mt3_tpu.parallel import param_shardings as jax_param_shardings
from mr_mt3_tpu.parallel import shard_batch as jax_shard_batch
from mr_mt3_tpu.train import optim as joptim
from mr_mt3_tpu.train.trainer import create_train_state as jax_state
from mr_mt3_tpu.train.trainer import make_train_step as jax_train_step
from mr_mt3_tpu_torch.infer import scores as port_scores
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.train import optim, trainer
from mr_mt3_tpu_torch.utils.checkpoint_import import (
    state_dict_from_jax_params,
)
from tests.parity_common import VANILLA_CFG, load_golden, parity_corpus
from tests.test_torch_eval import _write_song
from tests.test_torch_train import (
    LOSS_RTOL,
    PARAM_ATOL,
    TINY,
    _jax_params,
    _port_model,
)

REPO = Path(__file__).resolve().parent.parent
OPTIMIZER = dict(lr=1e-3, warmup_steps=2, total_steps=10, clip_norm=1.0)
# every rank's subprocess is killed past this: a collective that hangs
# fails the test instead of the suite
RANK_TIMEOUT_S = 240
# the parity model's eval decodes its songs to EOS within this budget
EVAL_MAX_LENGTH = 1024


def _batch(seed, reals, length=128):
    """Rows of noise audio, `reals[i]` random tokens, EOS, -100 padding."""
    rng = np.random.default_rng(seed)
    rows = len(reals)
    targets = np.full((rows, length), -100, np.int64)
    for i, real in enumerate(reals):
        targets[i, :real] = rng.integers(3, 1391, real)
        targets[i, real] = 1
    # instrument tokens (model space 1135-1262) weigh double in 'weighted'
    targets[0, 2] = 1140
    return {'audio': rng.normal(size=(rows, 256 * 128)).astype(np.float32)
            * 0.1,
            'valid_frames': np.full((rows,), 256, np.int32),
            'targets': targets}


# three rows padded to four: slice 0 holds rows 0-1 (61 real tokens with
# their EOS), slice 1 row 2 and a padding row (6)
BATCHES = [_batch(20 + i, (20, 39, 5)) for i in range(3)]
VAL_BATCHES = [_batch(30, (12, 50, 7)), _batch(31, (60, 3))]


def _eval_sets(root):
    """The parity corpus as a Slakh set (the overfit parity model scores
    it above 0.5) and an NSynth-style pair whose second file is not audio:
    on two ranks that song is the second rank's."""
    audios, notes = parity_corpus()
    slakh = chip_smoke.eval_set(root / 'slakh', audios, notes,
                                subtype='FLOAT')
    nsynth = root / 'nsynth'
    nsynth.mkdir()
    from mr_mt3_tpu_torch.audio import write_wav
    write_wav(nsynth / 'a_good.wav',
              np.random.default_rng(0).normal(size=32000) * 0.05, 16000)
    (nsynth / 'b_bad.wav').write_bytes(b'not audio at all')
    for name in ('a_good', 'b_bad'):
        _write_song(nsynth / f'{name}.mid', [(0.1, 0.5, 60, 0, False, 0)])
    return ({'files': slakh, 'gt': str(root / 'slakh'), 'dataset': 'Slakh'},
            {'files': [str(nsynth / 'a_good.wav'), str(nsynth / 'b_bad.wav')],
             'gt': str(nsynth), 'dataset': 'NSynth'})


@pytest.fixture(scope='module')
def parity():
    params, _ = load_golden('parity_vanilla.npz')
    cfg = {f: getattr(VANILLA_CFG, f) for f in MT3Config.__dataclass_fields__}
    return params, cfg


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, parity):
    """Both ranks' outputs (and the job they ran)."""
    root = tmp_path_factory.mktemp('ddp')
    params = _jax_params(JaxConfig(**TINY), seed=1)
    model = _port_model(params, MT3Config(**TINY))
    slakh, nsynth = _eval_sets(root)
    jparams, pcfg = parity
    parity_sd = state_dict_from_jax_params(jparams, MT3Config(**pcfg))
    job = {'cfg': TINY, 'state_dict': model.state_dict(),
           'batches': BATCHES, 'val_batches': VAL_BATCHES,
           'optimizer': OPTIMIZER, 'out_dir': str(root / 'run'),
           'eval': {
               'slakh': dict(slakh, cfg=pcfg, state_dict=parity_sd,
                             out=str(root / 'slakh_out'),
                             max_length=EVAL_MAX_LENGTH),
               'nsynth': dict(nsynth, cfg=TINY, state_dict=model.state_dict(),
                              out=str(root / 'nsynth_out'), max_length=8),
               # each rank a readable song; rank 1's decodes raise
               'decode_error': dict(
                   nsynth, files=[nsynth['files'][0]] * 2, cfg=TINY,
                   state_dict=model.state_dict(),
                   out=str(root / 'error_out'), max_length=8,
                   fail_rank=1)}}
    job_path = root / 'job.pt'
    torch.save(job, job_path)
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / 'tests' / 'ddp_rank.py'), str(job_path),
         str(r), '2', str(root / 'store')], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    outs = [torch.load(root / f'rank{r}.pt', weights_only=False)
            for r in range(2)]
    return job, outs, params


def _jax_run(params, loss_type):
    """The JAX package's train step on a two-device mesh over the same
    global batches: (metrics per step, parameters after)."""
    jcfg = JaxConfig(**TINY)
    mesh = jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    jopt = joptim.make_optimizer(**OPTIMIZER)
    # the step donates its state: a copy, not the fixture's arrays
    params = jax.tree.map(np.array, params)
    state = jax_state(jax.device_put(params,
                                     jax_param_shardings(params, mesh)),
                      jopt)
    step = jax_train_step(JaxMT3(jcfg), jopt, loss_type=loss_type)
    metrics = []
    for batch in BATCHES:
        state, m = step(state, jax_shard_batch(batch, mesh),
                        jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state.params


@pytest.mark.parametrize('loss_type', ['ce', 'weighted'])
def test_ddp_steps_equal_the_jax_mesh_step(ranks, loss_type):
    job, outs, params = ranks
    want_metrics, want_params = _jax_run(params, loss_type)
    assert [o['world'] for o in outs] == [2, 2]
    for o in outs:
        assert o[loss_type]['step'] == 3
        for got, want in zip(o[loss_type]['metrics'], want_metrics):
            assert set(got) == set(want)
            for key in want:
                tol = 1e-4 if key == 'grad_norm' else LOSS_RTOL
                assert got[key] == pytest.approx(want[key], rel=tol), key
    # the two ranks' parameters are the same tensors after the same
    # reduced gradients
    for k, v in outs[0][loss_type]['params'].items():
        assert torch.equal(v, outs[1][loss_type]['params'][k]), k
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, want_params),
                                      MT3Config(**TINY))
    worst = 0.0
    for name, w in want.items():
        err = float((outs[0][loss_type]['params'][name] - w).abs().max())
        worst = max(worst, err)
        assert err <= PARAM_ATOL, name
    print(loss_type, 'worst param diff after 3 steps', worst)


def test_the_slices_hold_unequal_token_counts():
    from mr_mt3_tpu_torch import parallel
    counts = [int((parallel.shard_batch(BATCHES[0], 2, r)['targets']
                   != -100).sum()) for r in range(2)]
    assert counts == [61, 6]


def test_validation_sums_equal_one_process(ranks, tmp_path):
    job, outs, _ = ranks
    # the ranks validate the model of their last run, the 'weighted' one
    model = MT3(MT3Config(**TINY))
    model.load_state_dict(outs[0]['weighted']['params'])
    tr = trainer.Trainer(model, optim.make_optimizer(**OPTIMIZER),
                         out_dir=str(tmp_path))
    state = trainer.create_train_state(model, tr.optimizer)
    loss_sum, tokens = tr.validation_sums(state, VAL_BATCHES)
    for o in outs:
        got_loss, got_tokens = o['validation_sums']
        assert got_tokens == tokens == 12 + 50 + 7 + 60 + 3 + 5
        assert got_loss == pytest.approx(loss_sum, rel=1e-6)


def test_the_checkpoint_is_written_once(ranks):
    _, outs, _ = ranks
    assert len(outs[0]['saves']) == 1 and outs[1]['saves'] == []
    assert outs[0]['checkpoints'] == outs[1]['checkpoints'] == ['last']


def test_two_rank_scores_equal_one_process_and_jax(ranks, parity, tmp_path):
    job, outs, _ = ranks
    ev = job['eval']['slakh']
    assert outs[0]['slakh'] == outs[1]['slakh']
    model = MT3(MT3Config(**ev['cfg']))
    model.load_state_dict(ev['state_dict'])
    one = port_scores.get_scores(
        model=model, eval_audio_dir=ev['files'],
        exp_tag_name=str(tmp_path / 'p'), ground_truth_midi_dir=ev['gt'],
        max_length=EVAL_MAX_LENGTH, verbose=False, device='cpu')
    jparams, _ = parity
    theirs = jax_get_scores(
        model=JaxMT3(VANILLA_CFG), variables={'params': jparams},
        eval_audio_dir=ev['files'], exp_tag_name=str(tmp_path / 'j'),
        ground_truth_midi_dir=ev['gt'], max_length=EVAL_MAX_LENGTH,
        verbose=False)
    assert outs[0]['slakh'] == one == theirs
    assert one['Onset F1'] > 0.5


def test_an_unreadable_song_does_not_hold_the_barrier(ranks, tmp_path):
    """Rank 1's only song is not audio: it skips it, meets rank 0 at the
    barrier, and both return one process's scores."""
    job, outs, _ = ranks
    ev = job['eval']['nsynth']
    assert outs[0]['nsynth'] == outs[1]['nsynth']
    model = MT3(MT3Config(**TINY))
    model.load_state_dict(ev['state_dict'])
    one = port_scores.get_scores(
        model=model, eval_audio_dir=ev['files'], eval_dataset='NSynth',
        exp_tag_name=str(tmp_path / 'out'), ground_truth_midi_dir=ev['gt'],
        max_length=8, verbose=False, device='cpu')
    assert outs[0]['nsynth'] == one
    assert 'Onset F1' in one
    assert sorted(os.listdir(ev['out'])) == ['a_good.mid']


def test_a_rank_whose_decode_raises_raises_on_every_rank(ranks):
    """Rank 1's decodes raise: both ranks raise together, naming it, and
    their next collective pairs up (no rank waits at a barrier the other
    left)."""
    job, outs, _ = ranks
    for o in outs:
        assert o['decode_error'] == {
            'error': 'transcription failed on rank(s) [1]'}
        assert o['decode_error_after'] == 3.0
        assert o['nsynth_after'] == o['slakh_after'] == 3.0
    # rank 0 transcribed its song; no rank scored
    assert os.listdir(job['eval']['decode_error']['out']) == ['a_good.mid']


SEGMEM = {'encoder_append': dict(segmem_variant='encoder_append',
                                  segmem_length=8),
          'decoder_prepend': dict(segmem_variant='decoder_prepend',
                                  segmem_length=8)}


@pytest.mark.parametrize('variant,with_prev', [
    ('vanilla', False), ('encoder_append', True), ('encoder_append', False),
    ('decoder_prepend', True), ('decoder_prepend', False)])
def test_every_parameter_gets_a_gradient(variant, with_prev):
    """Why create_train_state builds DDP with find_unused_parameters=False:
    every parameter of every variant is reached by the loss, with and
    without the previous segment's memory."""
    extra = SEGMEM.get(variant, {})
    model = MT3(MT3Config(**dict(TINY, dropout_rate=0.1), **extra)).train()
    batch = _batch(40, (9, 4))
    mel = trainer.batch_to_mel(torch.from_numpy(batch['audio']),
                               torch.from_numpy(batch['valid_frames']),
                               trainer.SpectrogramConfig())
    targets = torch.from_numpy(batch['targets'])
    prev = targets[:, :8].clamp(min=0) if with_prev else None
    logits = model(mel, labels=targets, targets_prev=prev,
                   generator=torch.Generator().manual_seed(0))
    loss = trainer.cross_entropy_loss(logits, targets)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    assert [n for n, g in zip(params, grads) if g is None] == []


def test_dropout_streams_differ_per_rank():
    """(seed, step, rank): rank 0's stream is the single-process one."""
    def draw(*args):
        return torch.rand(4, generator=trainer.step_generator(*args))
    cpu = torch.device('cpu')
    assert torch.equal(draw(5, 2, cpu), draw(5, 2, cpu, 0))
    assert not torch.equal(draw(5, 2, cpu, 0), draw(5, 2, cpu, 1))
    assert not torch.equal(draw(5, 2, cpu, 1), draw(5, 3, cpu, 1))
