"""The port's InferenceHandler on a mesh of CPU replicas against the JAX
handler on its mesh of virtual CPU devices (tests/conftest.py) and against
the port's own unsharded decode, on the same weights: the data axis
mirrors tests/test_inference.py's TestMesh (:360-560). Tokens must be equal
to each other and to the unsharded decode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mr_mt3_tpu.infer import InferenceHandler as JaxHandler
from mr_mt3_tpu.models import MT3 as JaxMT3
from mr_mt3_tpu.parallel import make_mesh as jax_make_mesh
from mr_mt3_tpu_torch.infer import InferenceHandler
from mr_mt3_tpu_torch.parallel import Mesh
from tests.test_inference import SMALL
from tests.test_torch_segmem import SMALL_SEGMEM, port_model


def _mesh(n):
    return Mesh(('cpu',) * n)


def _jax_mesh(n):
    return jax_make_mesh(data=n, model=1, devices=jax.devices()[:n])


@pytest.fixture(scope='module')
def vanilla():
    params = jax.device_get(JaxMT3(SMALL).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 512)),
        decoder_input_ids=jnp.zeros((1, 4), jnp.int32))['params'])
    return params, port_model(params, SMALL)


@pytest.fixture(scope='module')
def segmem():
    params = jax.device_get(JaxMT3(SMALL_SEGMEM).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 256, 512)),
        decoder_input_ids=jnp.zeros((1, 4), jnp.int32),
        targets_prev=jnp.zeros((1, 4), jnp.int32))['params'])
    return params, port_model(params, SMALL_SEGMEM)


def _three(weights, jax_cfg, n, **kw):
    """(port unsharded, port on n replicas, JAX on n devices)."""
    params, model = weights
    return (InferenceHandler(model=model, device='cpu', **kw),
            InferenceHandler(model=model, mesh=_mesh(n), **kw),
            JaxHandler(model=JaxMT3(jax_cfg), variables={'params': params},
                       mesh=_jax_mesh(n), **kw))


def _mel(seed, n):
    return (np.random.default_rng(seed).normal(size=(n, 256, 512))
            * 0.5).astype(np.float32)


def _all_equal(mel, *handlers):
    want = handlers[0]._decode_all(torch.from_numpy(mel))
    for h in handlers[1:]:
        got = (h._decode_all(mel) if isinstance(h, JaxHandler)
               else h._decode_all(torch.from_numpy(mel)))
        np.testing.assert_array_equal(got, want)
    return want


def test_replicas_are_copies_on_the_mesh(vanilla):
    _, model = vanilla
    h = InferenceHandler(model=model, mesh=_mesh(3), max_length=8)
    assert h.n_data == 3 and h.device == torch.device('cpu')
    assert h.replicas[0].model is h.model
    assert len({id(r.model) for r in h.replicas}) == 3
    for r in h.replicas[1:]:
        for a, b in zip(r.model.state_dict().values(),
                        model.state_dict().values()):
            assert torch.equal(a, b)
    assert InferenceHandler(model=model, mesh=_mesh(2), device='cpu',
                            max_length=8).device.type == 'cpu'


@pytest.mark.parametrize('n', [2, 4])
def test_vanilla_tokens_equal(vanilla, n):
    """10 segments at batch_size 4: calls of 4 x n rows, the last padded;
    each replica decodes its 4."""
    mine, sharded, theirs = _three(vanilla, SMALL, n, max_length=8,
                                   batch_size=4)
    tokens = _all_equal(_mel(1, 10), mine, sharded, theirs)
    assert tokens.shape == (10, 9)


def test_batch_size_is_per_device_and_never_rounded(vanilla):
    mine, sharded, theirs = _three(vanilla, SMALL, 4, max_length=8,
                                   batch_size=6)
    assert sharded.batch_size == theirs.batch_size == 6
    _all_equal(_mel(2, 7), mine, sharded, theirs)


@pytest.mark.parametrize('n', [2, 4])
def test_chained_segmem_chain_count_not_divisible(segmem, n):
    """7 segments in chains of 3: 3 chains, bucketed to 4 (floor) and
    tiled over the data axis; the chain length is not rounded."""
    mine, sharded, theirs = _three(segmem, SMALL_SEGMEM, n, max_length=8,
                                   batch_size=3)
    assert sharded._call_sizes(3, 4, False) == theirs._call_sizes(3, 4,
                                                                  False)
    _all_equal(_mel(6, 7), mine, sharded, theirs)


@pytest.mark.parametrize('n', [2, 4])
def test_contiguous_lockstep_odd_song_count(segmem, n):
    """3 songs in lockstep, the song axis padded to a multiple of the data
    axis; a lone song decodes on the first replica alone."""
    mine, sharded, theirs = _three(segmem, SMALL_SEGMEM, n, max_length=8,
                                   batch_size=2, contiguous_inference=True,
                                   segment_bucket=4)
    rng = np.random.default_rng(4)
    audios = [rng.normal(size=16000 * 4).astype(np.float32) * 0.05
              for _ in range(3)]
    notes = [[[(x.pitch, x.start_time, x.end_time) for x in ns.notes]
              for ns in h.transcribe_many(audios)]
             for h in (mine, sharded, theirs)]
    assert notes[1] == notes[0] and notes[2] == notes[0]
    one = sharded.transcribe(audios[0])
    assert [(x.pitch, x.start_time, x.end_time) for x in one.notes] == \
        notes[0][0]


def test_window_tier_through_its_plain_version(vanilla):
    """fused_bf16 on 2 replicas (the window's plain version on the CPU)
    against the unsharded port and the JAX window kernel (interpreted) on
    its 2-device mesh: 4 rows, 2 a replica."""
    mine, sharded, theirs = _three(vanilla, SMALL, 2, max_length=8,
                                   batch_size=2, quantize='fused_bf16')
    _all_equal(_mel(5, 4), mine, sharded, theirs)


def test_a_replicas_error_reaches_the_caller(vanilla, monkeypatch):
    _, model = vanilla
    h = InferenceHandler(model=model, mesh=_mesh(2), max_length=8,
                         batch_size=2)

    def failing(replica, rows, mask):
        if replica is h.replicas[1]:
            raise RuntimeError('replica 1 failed')
        return np.zeros((rows.shape[0], 9), np.int32)
    monkeypatch.setattr(h, '_greedy_on', failing)
    with pytest.raises(RuntimeError, match='replica 1 failed'):
        h._decode_all(torch.from_numpy(_mel(7, 3)))


def test_server_on_a_mesh_names_its_devices(vanilla):
    """serve's handler on two replicas answers a request, and /healthz
    names the devices; devices=2 on the CPU's one device raises."""
    import json
    import threading
    import urllib.request

    from mr_mt3_tpu_torch import serve
    from tests.test_torch_serve import post, wav_bytes
    _, model = vanilla
    handler = InferenceHandler(model=model, mesh=_mesh(2), max_length=8,
                               batch_size=2)
    srv = serve.make_server(handler, 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f'http://127.0.0.1:{srv.server_address[1]}'
    try:
        status, body, _ = post(url + '/transcribe', wav_bytes(3.0))
        assert status == 200 and body[:4] == b'MThd'
        with urllib.request.urlopen(url + '/healthz', timeout=30) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert health['devices'] == ['cpu', 'cpu'] and health['requests'] == 1
    with pytest.raises(ValueError, match='exceeds 1 devices'):
        serve.build_handler(['device=cpu', 'devices=2'])
