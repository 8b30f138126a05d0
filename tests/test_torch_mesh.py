"""The port's parallel/mesh.py against the JAX package's on its virtual CPU
devices (tests/conftest.py): make_mesh's counts and errors, device_cap,
shard_batch's padding and slices, and the handler's device-call sizes on a
mesh; the process-group helpers without a group; the launch counts under
threads."""

import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mr_mt3_tpu.infer import InferenceHandler as JaxHandler
from mr_mt3_tpu.models import MT3 as JaxMT3
from mr_mt3_tpu.parallel import device_cap as jax_device_cap
from mr_mt3_tpu.parallel import make_mesh as jax_make_mesh
from mr_mt3_tpu.parallel import shard_batch as jax_shard_batch
from mr_mt3_tpu_torch import parallel
from mr_mt3_tpu_torch.infer import InferenceHandler
from mr_mt3_tpu_torch.ops.cuda_build import count_launch
from tests.test_inference import SMALL
from tests.test_torch_segmem import port_model


@pytest.mark.parametrize('data,model,n', [
    (None, 1, 8), (4, 1, 8), (1, 1, 8), (8, 1, 8), (None, 1, 3),
    (9, 1, 8), (None, 3, 8), (5, 2, 8), (None, 2, 8), (2, 2, 8)])
def test_make_mesh_equals_jax(data, model, n):
    """The same axis sizes and devices, the same errors; a model axis above
    1 builds a grid of data x model ranks (Mesh(model=2) builds without a
    process group; its groups need one)."""
    try:
        want = jax_make_mesh(data=data, model=model,
                             devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parallel.make_mesh(data=data, model=model, devices=['cpu'] * n)
        assert str(got.value) == str(e)
        return
    got = parallel.make_mesh(data=data, model=model, devices=['cpu'] * n)
    assert {'data': got.n_data, 'model': got.model} == dict(want.shape)
    assert got.shape == dict(want.shape)
    assert got.devices == (torch.device('cpu'),) * want.size
    if model > 1:
        assert parallel.Mesh(('cpu',) * 2, model=2).shape == {'data': 1,
                                                              'model': 2}
        with pytest.raises(RuntimeError, match='process group'):
            got.model_group()
        with pytest.raises(ValueError, match='not divisible by model=2'):
            parallel.Mesh(('cpu',) * 3, model=2)


@pytest.mark.parametrize('value', [None, 0, -1, 1, 3, '2', [0, 1], [],
                                   (0, 1, 2), [5]])
def test_device_cap_equals_jax(value):
    assert parallel.device_cap(value) == jax_device_cap(value)


def test_data_devices_on_the_cpu():
    cpu = torch.device('cpu')
    assert parallel.data_devices(None, cpu) == 1
    assert parallel.data_devices([0, 1, 2], cpu) == 3
    assert parallel.visible_devices('cpu') == [cpu]


def _batch(rows, seed=0):
    rng = np.random.default_rng(seed)
    return {'audio': rng.normal(size=(rows, 6)).astype(np.float32),
            'valid_frames': rng.integers(1, 9, size=(rows,)).astype(np.int32),
            'targets': rng.integers(0, 50, size=(rows, 5)).astype(np.int32),
            'targets_prev': rng.integers(0, 50, size=(rows, 4)
                                         ).astype(np.int32)}


@pytest.mark.parametrize('n', [1, 2, 3, 4, 8])
@pytest.mark.parametrize('rows', [1, 3, 5, 8])
def test_shard_batch_equals_jax(n, rows):
    """Slice i of the port is the rows the JAX mesh puts on device i: the
    same padding (-100 under 'targets*', 0 elsewhere), contiguous slices
    in row order."""
    batch = _batch(rows)
    mesh = jax_make_mesh(data=n, model=1, devices=jax.devices()[:n])
    sharded = jax_shard_batch(batch, mesh)
    for key, arr in sharded.items():
        shards = sorted(arr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        assert len(shards) == n
        for i, shard in enumerate(shards):
            got = parallel.shard_batch(batch, n, i)[key]
            np.testing.assert_array_equal(got, np.asarray(shard.data))
            assert got.dtype == batch[key].dtype
    with pytest.raises(ValueError):
        parallel.shard_batch(batch, n, n)


def test_no_group_defaults():
    assert (parallel.rank(), parallel.world(), parallel.local_rank(),
            parallel.local_world(), parallel.node_rank(),
            parallel.node_count()) == (0, 1, 0, 1, 0, 1)
    parallel.barrier()
    t = torch.arange(3.0)
    assert parallel.all_reduce_sum(t) is t
    assert parallel.broadcast_object({'a': 1.5}) == {'a': 1.5}
    assert parallel.local_mesh('cpu') is None
    assert parallel.backend_for(torch.device('cpu')) == 'gloo'
    assert parallel.rank_device('cpu') == torch.device('cpu')


def test_init_multihost_needs_the_launchers_environment(monkeypatch):
    for name in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'MASTER_ADDR',
                 'MASTER_PORT'):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match='WORLD_SIZE'):
        parallel.init_multihost(backend='gloo')
    monkeypatch.setenv('WORLD_SIZE', '1')
    monkeypatch.setenv('RANK', '0')
    monkeypatch.setenv('LOCAL_RANK', '0')
    with pytest.raises(ValueError, match='MASTER_ADDR'):
        parallel.init_multihost(backend='gloo')


@pytest.fixture(scope='module')
def weights():
    params = jax.device_get(JaxMT3(SMALL).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 512)),
        decoder_input_ids=jnp.zeros((1, 4), jnp.int32))['params'])
    return params, port_model(params, SMALL)


@pytest.mark.parametrize('n_data', [1, 2, 3, 4, 6])
def test_call_sizes_equal_jax(weights, n_data):
    """Every size a multiple of the data axis, the per-call cap 64 rows a
    device (the JAX vanilla handler's 8 x FUSED_MAX_BATCH; the port's
    FUSED_MAX_BATCH), including a remainder of 40 rows on six devices."""
    params, model = weights
    mine = InferenceHandler(model=model, max_length=8, device='cpu',
                            mesh=(parallel.Mesh(('cpu',) * n_data)
                                  if n_data > 1 else None))
    theirs = JaxHandler(model=JaxMT3(SMALL), variables={'params': params},
                        max_length=8,
                        mesh=(jax_make_mesh(data=n_data, model=1,
                                            devices=jax.devices()[:n_data])
                              if n_data > 1 else None))
    assert mine.n_data == theirs.n_data == n_data
    for n_real in list(range(1, 70)) + [127, 128, 129, 200, 384, 424, 500,
                                        684]:
        for floor in (1, 4):
            for capped in (False, True):
                got = mine._call_sizes(n_real, floor, capped)
                assert got == theirs._call_sizes(n_real, floor, capped), \
                    (n_real, floor, capped)
                assert all(s % n_data == 0 for s in got)
    if n_data == 6:
        # a cap of 64 x 6 = 384 rows a call: the remainder 40 buckets to
        # 64 and rounds up to 66; 300 grows in fours past 64, to 300
        assert mine._call_sizes(424, 1, True) == [384, 66]
        assert mine._call_sizes(684, 1, True) == [384, 300]


def test_launch_counts_survive_threads():
    """count_launch from more threads than cores, the interpreter switching
    threads as often as it can: no increment is lost."""
    counter = {'k': 0}
    threads_n, each = 32, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [count_launch(counter, 'k') for _ in range(each)])
            for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter['k'] == threads_n * each
