"""The port's HTTP server (mr_mt3_tpu_torch.serve) on the CPU: the handler
built as `python -m mr_mt3_tpu_torch.serve device=cpu` builds it (full
MT3Net width, seeded random weights, a short decode budget)."""

import json
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import serve as jax_serve
from mr_mt3_tpu_torch import serve


def wav_bytes(seconds=2.0, sr=16000, freq=440.0):
    t = np.arange(int(sr * seconds)) / sr
    pcm = (0.3 * np.sin(2 * np.pi * freq * t) * 32767).astype('<i2')
    data = pcm.tobytes()
    return (b'RIFF' + struct.pack('<I', 36 + len(data)) + b'WAVE'
            + b'fmt ' + struct.pack('<IHHIIHH', 16, 1, 1, sr, sr * 2, 2, 16)
            + b'data' + struct.pack('<I', len(data)) + data)


def post(url, body):
    req = urllib.request.Request(url, data=body, method='POST')
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read(), resp.headers.get('Content-Type')
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get('Content-Type')


def get_json(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope='module')
def server():
    handler = serve.build_handler(['device=cpu', 'eval.max_length=8',
                                   'eval.batch_size=2'])
    info = serve.prepare_handler(handler)
    srv = serve.make_server(handler, 0, info)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield handler, f'http://127.0.0.1:{srv.server_address[1]}'
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


class TestServer:
    def test_handler_is_the_cli_one(self, server):
        handler, _ = server
        assert handler.device.type == 'cpu'
        assert handler.quantize == 'none'       # 'fused_int4' on the card
        assert handler.cfg.d_model == 512
        assert handler.cfg.num_decoder_layers == 8
        assert handler.max_length == 8 and handler.batch_size == 2

    def test_transcribe_wav_to_midi(self, server):
        _, url = server
        status, body, ctype = post(url + '/transcribe', wav_bytes())
        assert status == 200 and ctype == 'audio/midi'
        assert body[:4] == b'MThd'

    def test_transcribe_json(self, server):
        _, url = server
        status, body, ctype = post(url + '/transcribe.json',
                                   wav_bytes(1.0, sr=44100))
        assert status == 200 and ctype == 'application/json'
        assert isinstance(json.loads(body)['notes'], list)

    def test_bad_bodies_400(self, server):
        _, url = server
        status, body, _ = post(url + '/transcribe', b'fLaC' + bytes(64))
        assert status == 400 and b'invalid or unsupported FLAC stream' in body
        status, body, _ = post(url + '/transcribe', b'not audio')
        assert status == 400 and b'WAV or FLAC' in body
        status, _, _ = post(url + '/transcribe', b'RIFF\x10\x00\x00\x00WAVE')
        assert status == 400
        status, _, _ = post(url + '/nope', b'')
        assert status == 404

    def test_concurrent_requests_and_healthz(self, server):
        _, url = server
        before = get_json(url + '/healthz')['requests']
        results = [None] * 3

        def call(i):
            results[i] = post(url + '/transcribe', wav_bytes(1.5, freq=300.0
                                                             + 100 * i))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(not t.is_alive() for t in threads)
        for status, body, _ in results:
            assert status == 200 and body[:4] == b'MThd'
        health = get_json(url + '/healthz')
        assert health['requests'] == before + 3
        assert health['decode']['quantize'] == 'none'
        assert health['decode']['prewarmed'] is True

    def test_healthz_has_the_jax_servers_keys(self, server):
        """The JAX server's /healthz, built around the same handler, has
        the same top-level keys, and the port's names the devices its
        replicas decode on; the decode block has the keys the JAX
        prepare_handler reports for a vanilla handler without the probe."""
        handler, url = server
        mine = get_json(url + '/healthz')
        jax_srv = jax_serve.make_server(handler, 0)
        thread = threading.Thread(target=jax_srv.serve_forever, daemon=True)
        thread.start()
        try:
            theirs = get_json(
                f'http://127.0.0.1:{jax_srv.server_address[1]}/healthz')
        finally:
            jax_srv.shutdown()
            jax_srv.server_close()
        assert set(mine) == set(theirs) | {'devices'}
        assert mine['devices'] == ['cpu']
        assert set(mine['decode']) == {'quantize', 'prewarmed',
                                       'prewarm_seconds', 'prewarm_buckets'}


class TestServingTier:
    def test_default_tier_per_device(self):
        """The server starts at the int4 window kernel on the card (the
        JAX server's TPU default) and at the exact path on the CPU; 'auto'
        maps to the same."""
        assert serve.default_quantize(torch.device('cuda')) == 'fused_int4'
        assert serve.default_quantize(torch.device('cpu')) == 'none'
        handler = serve.build_handler(['device=cpu', 'eval.quantize=auto',
                                       'eval.max_length=8'])
        assert handler.quantize == 'none'

    def test_healthz_reports_the_probe(self, server, monkeypatch):
        """A handler that walks the ladder reports the walk under
        "decode": the tier, its probe counts and the demotions."""
        from mr_mt3_tpu_torch.infer import InferenceHandler
        handler, _ = server
        int4 = InferenceHandler(model=handler.model, max_length=8,
                                batch_size=2, quantize='fused_int4',
                                device='cpu')
        monkeypatch.setattr(
            serve, 'quantize_probe',
            lambda h: (0, 18) if h.quantize == 'fused' else (5, 18))
        info = serve.prepare_handler(int4)
        srv = serve.make_server(int4, 0, info)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            decode = get_json(f'http://127.0.0.1:{srv.server_address[1]}'
                              '/healthz')['decode']
        finally:
            srv.shutdown()
            srv.server_close()
        assert decode['quantize'] == 'fused'
        assert decode['probe_tier'] == 'fused'
        assert (decode['probe_flips'], decode['probe_tokens']) == (0, 18)
        assert len(decode['demotions']) == 1
        assert decode['probe_seconds'] >= 0 and decode['prewarmed']


class TestBuildHandler:
    @pytest.mark.parametrize('tier', ['int8', 'int8_kv'])
    def test_quantize_override(self, tier):
        """build_handler honours +eval.quantize (the JAX package's
        TestBuildHandler); on the CPU the default stays exact."""
        widths = ['device=cpu', 'model=MT3Net', 'model.config.num_layers=1',
                  'model.config.d_model=32', 'model.config.d_ff=48',
                  'model.config.num_heads=2', 'model.config.d_kv=16']
        assert serve.build_handler(widths).quantize == 'none'
        handler = serve.build_handler(widths + [f'+eval.quantize={tier}'])
        assert handler.quantize == tier
        assert handler.cfg.d_model == 32 and handler.device.type == 'cpu'


class TestMicroBatcher:
    def test_coalesces_queued_requests(self):
        """Requests queued while the device is busy run as ONE
        transcribe_many call."""
        release = threading.Event()
        calls = []

        class SlowHandler:
            def transcribe_many(self, audios):
                calls.append(len(audios))
                if len(calls) == 1:
                    release.wait(timeout=10)
                return [object() for _ in audios]

        batcher = serve.MicroBatcher(SlowHandler())
        threads = [threading.Thread(
            target=batcher.transcribe, args=(np.zeros(10, np.float32),))
            for _ in range(4)]
        threads[0].start()
        deadline = time.time() + 5
        while not calls and time.time() < deadline:
            time.sleep(0.005)
        assert calls, 'worker thread never picked up request 0'
        for t in threads[1:]:
            t.start()
        deadline = time.time() + 5
        while batcher._q.qsize() < 3 and time.time() < deadline:
            time.sleep(0.005)
        release.set()
        for t in threads:
            t.join(timeout=10)
        assert all(not t.is_alive() for t in threads)
        assert calls == [1, 3]

    def test_failing_song_is_isolated(self):
        """A coalesced batch that fails is retried one song at a time, so
        only the bad song's caller sees the error."""
        class Flaky:
            def transcribe_many(self, audios):
                if any(a[0] < 0 for a in audios):
                    if len(audios) > 1:
                        raise RuntimeError('batch failed')
                    raise ValueError('bad song')
                return [float(a[0]) for a in audios]

        batcher = serve.MicroBatcher(Flaky())
        out = {}

        def call(v):
            try:
                out[v] = batcher.transcribe(np.full(4, v, np.float32))
            except ValueError as e:
                out[v] = e

        threads = [threading.Thread(target=call, args=(v,))
                   for v in (1.0, -1.0, 2.0)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert out[1.0] == 1.0 and out[2.0] == 2.0
        assert isinstance(out[-1.0], ValueError)
