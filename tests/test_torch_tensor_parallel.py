"""The model axis (tensor parallelism) of the port on the CPU: the placement
plan against the JAX package's param_shardings, and two grids of gloo
ranks (tests/tp_rank.py, subprocesses meeting through a file store), one
model group of two ranks and a data=2 x model=2 grid, each started once
for the module, against the JAX package's tensor-parallel handler and
train step on the conftest's virtual CPU devices and against the port's
one-rank handler and step:

  * the handler's fp32 tokens equal JAX's TP handler's, its teacher-forced
    logits are within 1e-5 of JAX's TP forward; every quantized tier
    raises naming the model axis;
  * three AdamW steps (dropout off) within 1e-5 of JAX's TP step; with
    dropout and the clip, the TP step within 1e-6 of the one-rank step;
  * checkpoints cross between model=2 and model=1;
  * the bf16 segment-memory handler on the attention kernel's route (its
    plain version here) against one rank by the probe's margin rule.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.tree_util import tree_flatten_with_path

from mr_mt3_tpu.infer import InferenceHandler as JaxHandler
from mr_mt3_tpu.models import MT3 as JaxMT3
from mr_mt3_tpu.models import MT3Config as JaxConfig
from mr_mt3_tpu.parallel import make_mesh as jax_make_mesh
from mr_mt3_tpu.parallel import param_shardings as jax_param_shardings
from mr_mt3_tpu.parallel import shard_batch as jax_shard_batch
from mr_mt3_tpu.train import optim as joptim
from mr_mt3_tpu.train.trainer import create_train_state as jax_state
from mr_mt3_tpu.train.trainer import make_train_step as jax_train_step
from mr_mt3_tpu_torch import parallel
from mr_mt3_tpu_torch.infer import InferenceHandler
from mr_mt3_tpu_torch.infer import probe
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.ops.decode import PORTED_TIERS
from mr_mt3_tpu_torch.train import optim, trainer
from mr_mt3_tpu_torch.utils import builders
from mr_mt3_tpu_torch.utils.checkpoint_import import (
    jax_param_map,
    state_dict_from_jax_params,
)
from tests.parity_common import WITHPREV_CFG, load_golden, parity_corpus
from tests.test_inference import SMALL

REPO = Path(__file__).resolve().parent.parent
# each rank is killed past this: a collective that hangs fails the test
RANK_TIMEOUT_S = 240
GRIDS = {'model2': (2, 2), 'grid2x2': (4, 2)}     # (world, model)
MAX_LENGTH = 8
TRAIN_CFG = dict(vocab_size=1536, d_model=32, d_kv=8, d_ff=48, num_heads=4,
                 num_encoder_layers=1, num_decoder_layers=1, mel_bins=512,
                 dropout_rate=0.0)
OPTIMIZER = dict(lr=1e-3, warmup_steps=2, total_steps=10)
DROPOUT_OPTIMIZER = dict(OPTIMIZER, clip_norm=1.0)
SEED = 11
# the parameters after three AdamW steps: against JAX's TP step the CPU
# tests' 1e-5 (tests/test_torch_train.py's PARAM_ATOL); against the port's
# one-rank step, which computes the same function in other sum orders,
# 1e-6, the loss and grad_norm of every step within 1e-6 of their values.
# AdamW divides each gradient by its own magnitude, so an element whose
# gradient is near its sum-order noise may move up to ~1e-3 of the
# learning rate apart (one element of 49152, its gradient 1e-7 against
# noise of 9e-10, read 1.5e-6 apart): an element further apart than 1e-6
# must have a first-step gradient below NOISE_RATIO times the largest
# difference of its gradients over the steps (chip_smoke.py's
# MULTI_NOISE_RATIO rule), and at most APART_SHARE of them may be apart.
PARAM_ATOL_JAX = 1e-5
PARAM_ATOL_ONE_RANK = 1e-6
METRIC_RTOL_ONE_RANK = 1e-6
NOISE_RATIO = 1e3
APART_SHARE = 1e-4
LOGIT_ATOL = 1e-5
SEGMEM_MAX_LENGTH = 512     # the memory encoder reaches the kernel here


def _flat(params):
    return {'/'.join(k.key for k in path): np.asarray(leaf)
            for path, leaf in tree_flatten_with_path(params)[0]}


def _jax_params(jcfg, seed=0):
    """A JAX parameter tree (numpy) of the port's seeded init
    (builders.init_params): no JAX compile before the ranks start."""
    cfg = _torch_cfg(jcfg)
    state = builders.init_params(MT3(cfg), seed).state_dict()
    params = {}
    for key, path, transpose in jax_param_map({}, cfg):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        value = state[key].numpy()
        node[path[-1]] = np.ascontiguousarray(value.T if transpose
                                              else value)
    return params


def _train_batch(seed, rows=4, length=128, real=(20, 39, 5, 60)):
    rng = np.random.default_rng(seed)
    targets = np.full((rows, length), -100, np.int64)
    for i in range(rows):
        targets[i, :real[i]] = rng.integers(3, 1391, real[i])
        targets[i, real[i]] = 1
    return {'audio': rng.normal(size=(rows, 256 * 128)).astype(np.float32)
            * 0.1,
            'valid_frames': np.full((rows,), 256, np.int32),
            'targets': targets}


def _torch_cfg(jcfg, **kw):
    return MT3Config(**{f: getattr(jcfg, f)
                        for f in MT3Config.__dataclass_fields__}).replace(**kw)


def _one_rank(params, cfg):
    model = MT3(cfg)
    model.load_state_dict(state_dict_from_jax_params(params, cfg))
    return model


def _one_rank_steps(params, cfg, optimizer, batches, seed, grads=None):
    """The port's step in one process on the whole batches; grads: a list
    for each step's gradients, its metrics under 'metrics'."""
    model = _one_rank(params, cfg)
    opt = optim.make_optimizer(**optimizer)
    state = trainer.create_train_state(model, opt)
    if grads is not None:
        names = [n for n, _ in model.named_parameters()]
        real = opt.step

        def keeping(gs):
            grads.append({n: g.clone() for n, g in zip(names, gs)})
            return real(gs)
        opt.step = keeping
    step = trainer.make_train_step('ce')
    state.metrics = [{k: float(v) for k, v in step(state, b, seed).items()}
                     for b in batches]
    return state


@pytest.fixture(scope='module')
def job(tmp_path_factory):
    """The ranks' inputs and the module's references: both grids start at
    once, the JAX references are computed while they run, and the ranks'
    outputs are read when they end."""
    threads = torch.get_num_threads()
    # one thread: torch's bf16 CPU matmuls at these tiny shapes run ~100x
    # slower on several threads, and the ranks share the cores
    torch.set_num_threads(1)
    try:
        return _job(tmp_path_factory.mktemp('tp'))
    finally:
        torch.set_num_threads(threads)


def _job(root):
    rng = np.random.default_rng(3)
    small = _jax_params(SMALL)
    train_params = _jax_params(JaxConfig(**TRAIN_CFG), seed=1)
    segmem, _ = load_golden('parity_withprev.npz')
    segmem_cfg = _torch_cfg(WITHPREV_CFG, dtype='bfloat16',
                            attention_kernel='fused')
    segmem_handler = InferenceHandler(
        model=_one_rank(segmem, segmem_cfg).eval(), device='cpu',
        max_length=SEGMEM_MAX_LENGTH, contiguous_inference=True,
        segment_bucket=1)
    audio = parity_corpus()[0][0]
    segments, _, valid = segmem_handler._audio_to_segments(audio)
    segmem_mel = segmem_handler._compute_mel(segments[:2], valid[:2]).numpy()
    train_cfg = MT3Config(**TRAIN_CFG)
    dropout_cfg = train_cfg.replace(dropout_rate=0.1)
    batches = [_train_batch(20 + i) for i in range(3)]
    # a one-rank checkpoint after one step, for the ranks to restore
    one = _one_rank_steps(train_params, dropout_cfg, DROPOUT_OPTIMIZER,
                          batches[:1], SEED)
    tr = trainer.Trainer(one.model, one.optimizer, out_dir=str(root / 'one'))
    tr.save_checkpoint(one, 'one_rank')
    payload = {
        'small_cfg': {f: getattr(SMALL, f)
                      for f in MT3Config.__dataclass_fields__},
        'small': _flat(small), 'max_length': MAX_LENGTH,
        'mel': rng.normal(size=(8, 256, 512)).astype(np.float32),
        'ids': rng.integers(2, 1536, (8, 8)),
        'train_cfg': TRAIN_CFG, 'train_params': _flat(train_params),
        'optimizer': OPTIMIZER, 'batches': batches,
        'dropout_cfg': dict(TRAIN_CFG, dropout_rate=0.1),
        'dropout_optimizer': DROPOUT_OPTIMIZER, 'seed': SEED,
        'one_rank_checkpoint': str(root / 'one' / 'checkpoints'
                                   / 'one_rank'),
        'segmem_cfg': {f: getattr(segmem_cfg, f)
                       for f in MT3Config.__dataclass_fields__},
        'segmem': _flat(segmem), 'segmem_max_length': SEGMEM_MAX_LENGTH,
        'segmem_mel': segmem_mel}
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = {}
    for name, (world, model) in GRIDS.items():
        (root / name).mkdir()
        torch.save(payload, root / name / 'job.pt')
        procs[name] = [subprocess.Popen(
            [sys.executable, str(REPO / 'tests' / 'tp_rank.py'),
             str(root / name), str(r), str(world), str(model)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
    try:
        refs = _references(payload, small, train_params, batches,
                           segmem_handler)
        logs = {name: [p.communicate(timeout=RANK_TIMEOUT_S)[0]
                       for p in ps] for name, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    outs = {}
    for name, ps in procs.items():
        for p, log in zip(ps, logs[name]):
            assert p.returncode == 0, log[-4000:]
        outs[name] = [torch.load(root / name / f'rank{r}.pt',
                                 weights_only=False)
                      for r in range(len(ps))]
    return {'payload': payload, 'refs': refs, 'outs': outs, 'root': root,
            'one_rank_state': one}


def _references(payload, small, train_params, batches, segmem_handler):
    """JAX's TP handler tokens and TP forward logits on SMALL over a
    data=2 x model=2 mesh, JAX's TP train step, the port's one-rank step
    with dropout and the clip, and the port's one-rank segment-memory
    handler with its flips' margins."""
    mesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    model = JaxMT3(SMALL)
    handler = JaxHandler(model=model, variables={'params': small},
                         max_length=MAX_LENGTH, batch_size=4, mesh=mesh)
    tokens = np.asarray(handler._decode_all(payload['mel']))
    params = jax.device_put(small, jax_param_shardings(small, mesh))
    logits = np.asarray(jax.jit(model.apply)(
        {'params': params}, jnp.asarray(payload['mel']),
        decoder_input_ids=jnp.asarray(payload['ids'])))
    jcfg = JaxConfig(**TRAIN_CFG)
    jopt = joptim.make_optimizer(**OPTIMIZER)
    tparams = jax.tree.map(np.array, train_params)
    state = jax_state(jax.device_put(tparams,
                                     jax_param_shardings(tparams, mesh)),
                      jopt)
    step = jax_train_step(JaxMT3(jcfg), jopt, loss_type='ce')
    for batch in batches:
        state, _ = step(state, jax_shard_batch(batch, mesh),
                        jax.random.PRNGKey(0))
    jax_trained = state_dict_from_jax_params(
        jax.tree.map(np.asarray, state.params), MT3Config(**TRAIN_CFG))
    grads = []
    one = _one_rank_steps(train_params, MT3Config(**payload['dropout_cfg']),
                          DROPOUT_OPTIMIZER, batches, SEED, grads)
    seg_tokens = segmem_handler._decode_all(
        torch.from_numpy(payload['segmem_mel']))
    return {'tokens': tokens, 'logits': logits, 'jax_trained': jax_trained,
            'one_rank_dropout': {'params': one.model.state_dict(),
                                 'grads': grads, 'metrics': one.metrics},
            'segmem_handler': segmem_handler, 'segmem_tokens': seg_tokens}


@functools.lru_cache(maxsize=None)
def _shapes(width):
    jcfg = SMALL if width == 'small' else JaxConfig()
    return jcfg, jax.eval_shape(lambda: JaxMT3(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 512)),
        decoder_input_ids=jnp.zeros((1, 4), jnp.int32)))['params']


@pytest.mark.parametrize('width', ['small', 'full'])
@pytest.mark.parametrize('model', [2, 3, 4])
def test_plan_equals_jax_param_shardings(width, model):
    """parallel.param_shardings equals JAX's param_shardings(...).spec on
    every leaf (a JAX kernel's (in, out) is the torch weight's (out, in)),
    with no ranks: the shapes from jax.eval_shape. The one exception is
    the port's whole heads: at full width, model=4, JAX shards q/k/v/o
    (384 columns, 1.5 heads a device) and the port replicates them."""
    jcfg, shapes = _shapes(width)
    mesh = jax_make_mesh(data=1, model=model,
                         devices=jax.devices()[:model])
    specs = jax_param_shardings(shapes, mesh)
    plan = parallel.param_shardings(_torch_cfg(jcfg), model)
    mapping = jax_param_map(shapes, _torch_cfg(jcfg))
    assert {key for key, _, _ in mapping} == set(plan)
    exceptions = []
    for key, path, transpose in mapping:
        spec = specs
        for k in path:
            spec = spec[k]
        spec = spec.spec
        want = None
        if 'model' in spec:
            want = spec.index('model')
            want = 1 - want if transpose else want
        if plan[key] != want:
            exceptions.append(key)
            assert want is not None and plan[key] is None
            assert 'Attention' in key and jcfg.num_heads % model
    if (width, model) == ('full', 4):
        assert exceptions and all('Attention' in k for k in exceptions)
    else:
        assert exceptions == []


def test_the_grids_and_their_shards(job):
    for name, (world, model) in GRIDS.items():
        outs = job['outs'][name]
        assert [(o['data_index'], o['model_index']) for o in outs] == [
            (r // model, r % model) for r in range(world)]
        assert all(o['shape'] == {'data': world // model, 'model': model}
                   for o in outs)
        assert all(o['local_heads'] == SMALL.num_heads // model
                   for o in outs)
        # the handler keeps the model object and its attention_kernel, as
        # JAX's does (tests/test_inference.py:435-450); no graphs here
        assert all(o['handler_model_is_model'] and
                   o['attention_kernel'] == 'auto' and o['graphs'] == {}
                   for o in outs)


@pytest.mark.parametrize('grid', list(GRIDS))
def test_tokens_equal_the_jax_tp_handler(job, grid):
    want = job['refs']['tokens']
    for o in job['outs'][grid]:
        np.testing.assert_array_equal(o['tokens'], want)


@pytest.mark.parametrize('grid', list(GRIDS))
def test_logits_within_1e5_of_jax(job, grid):
    want = job['refs']['logits']
    for o in job['outs'][grid]:
        assert o['logits'].shape == want.shape
        err = float(np.abs(o['logits'] - want).max())
        print(grid, 'worst logit diff', err)
        assert err <= LOGIT_ATOL


@pytest.mark.parametrize('quantize', [q for q in PORTED_TIERS
                                      if q != 'none'])
def test_quantized_tiers_raise_on_a_model_axis(quantize):
    """Refused before any collective, with JAX's wording."""
    model = MT3(_torch_cfg(SMALL))
    with pytest.raises(ValueError, match='model axis'):
        InferenceHandler(model=model, quantize=quantize, device='cpu',
                         mesh=parallel.Mesh(('cpu',) * 4, model=2))
    assert model.tp is None


def test_train_steps_within_1e5_of_jax_tp_step(job):
    """The 2x2 grid: DDP over the data groups, the model groups' shards;
    three AdamW steps, dropout off, on rows split over the data index."""
    want = job['refs']['jax_trained']
    outs = job['outs']['grid2x2']
    assert all(o['train']['ddp'] and o['train']['step'] == 3 for o in outs)
    worst = 0.0
    for o in outs:
        for name, w in want.items():
            err = float((o['train']['params'][name] - w).abs().max())
            worst = max(worst, err)
            assert err <= PARAM_ATOL_JAX, name
    print('worst param diff against JAX after 3 steps', worst)
    # the model-only group (no data axis) too
    for o in job['outs']['model2']:
        assert not o['train']['ddp']
        for name, w in want.items():
            assert float((o['train']['params'][name] - w).abs().max()) \
                <= PARAM_ATOL_JAX, name


def test_dropout_and_clip_step_equals_one_rank(job):
    """The masks of the sharded feed-forward hidden are the one-rank
    draw's slices, the replicated sites' alike on both ranks, and the clip
    reads the one-rank norm: three steps with dropout 0.1 and clip_norm 1
    equal the one-rank steps (see PARAM_ATOL_ONE_RANK)."""
    want = job['refs']['one_rank_dropout']
    for o in job['outs']['model2']:
        got = o['dropout']
        for a, b in zip(got['metrics'], want['metrics']):
            assert set(a) == set(b)
            for key in b:
                assert a[key] == pytest.approx(b[key],
                                               rel=METRIC_RTOL_ONE_RANK), key
        worst, apart, unexplained, total = 0.0, 0, 0, 0
        for name, w in want['params'].items():
            diff = (got['params'][name] - w).abs()
            far = diff > PARAM_ATOL_ONE_RANK
            noise = torch.stack([(a[name] - b[name]).abs() for a, b in
                                 zip(got['grads'], want['grads'])]).amax(0)
            explained = want['grads'][0][name].abs() < NOISE_RATIO * noise
            worst = max(worst, float(diff.max()))
            apart += int(far.sum())
            unexplained += int((far & ~explained).sum())
            total += w.numel()
        print(f'rank {o["rank"]}: worst param diff against one rank '
              f'{worst}, {apart} of {total} apart, {unexplained} of them '
              'unexplained by their gradients')
        assert unexplained == 0
        assert apart <= APART_SHARE * total


def test_a_model2_checkpoint_loads_at_model1(job):
    path = job['root'] / 'model2' / 'run' / 'checkpoints' / 'tp'
    blob = trainer.load_checkpoint(str(path))
    assert blob['step'] == 3
    gathered = job['outs']['model2'][0]['dropout']['params']
    model = MT3(MT3Config(**job['payload']['dropout_cfg']))
    model.load_state_dict(blob['params'], strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, gathered[k]), k
    opt = optim.make_optimizer(**DROPOUT_OPTIMIZER)
    state = trainer.create_train_state(model, opt)
    tr = trainer.Trainer(model, opt, out_dir=str(job['root'] / 'reload'))
    tr.restore_state(str(path), state)
    assert state.step == 3 and opt.count == 3
    assert [tuple(m.shape) for m in opt.mu] == [
        tuple(p.shape) for p in model.parameters()]


def test_a_model1_checkpoint_loads_at_model2(job):
    one = job['one_rank_state']
    full = one.model.state_dict()
    plan = parallel.param_shardings(one.model.cfg, 2)
    for o in job['outs']['model2']:
        r = o['restored']
        assert r['step'] == 1
        index = o['model_index']
        for k, v in full.items():
            want = v if plan[k] is None else v.chunk(2, plan[k])[index]
            assert torch.equal(r['params'][k], want), k
        for name, got, mu in zip(r['names'], r['mu'], one.optimizer.mu):
            want = mu if plan[name] is None else mu.chunk(2, plan[name])[
                index]
            assert torch.equal(got, want), name


def test_bf16_segmem_handler_by_the_margin_rule(job):
    """The parity golden's segment-memory model in bf16 on a first corpus
    song, one contiguous chain: the memory encoder at L 512 takes the
    attention kernel's route on H / 2 heads (the plain version on the
    CPU), once a segment; the tokens against one rank's: every flip
    benign by classify_flips (none material)."""
    handler = job['refs']['segmem_handler']
    want = job['refs']['segmem_tokens']
    mel = torch.from_numpy(job['payload']['segmem_mel'])
    for o in job['outs']['model2']:
        shapes = o['segmem_attention_shapes']
        assert len(shapes) == mel.shape[0]
        assert all(s[1:] == (SEGMEM_MAX_LENGTH, WITHPREV_CFG.num_heads // 2,
                             WITHPREV_CFG.d_kv) for s in shapes)
        got = o['segmem_tokens']
        assert got.shape == want.shape
        if not np.array_equal(got, want):
            flips = probe.classify_flips(handler, got, want, mel)
            print('segmem flips', flips)
            assert flips['material_rows'] == 0, flips
