"""The port's native FLAC codec (mr_mt3_tpu_torch/native/flac.py and its
copy of flac.cc) against the JAX package's (mr_mt3_tpu/native/flac.py):
decoded samples bit-equal and encoded bytes equal over tests/test_flac.py's
matrix, the same outcome on malformed streams, read_audio, and the port
server's FLAC bodies. The JAX package's library is built by its own
make, or where that fails from its flac.cc by g++ with the Makefile's
flags (jax_codec); a codec that cannot be built fails the tests."""

import os
import shutil
import struct
import subprocess
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from mr_mt3_tpu.native import _loader as jax_loader
from mr_mt3_tpu.native import flac as jax_flac_module
from mr_mt3_tpu_torch import serve
from mr_mt3_tpu_torch.audio import read_audio
from mr_mt3_tpu_torch.native import flac


def jax_codec(monkeypatch, build_dir):
    """mr_mt3_tpu.native.flac with its library loaded. Where its make
    cannot build it, its flac.cc is compiled into build_dir with the
    Makefile's flags and the module's loader pointed there (undone with
    monkeypatch). A failed build fails the caller."""
    if not jax_flac_module.flac_available():
        out = os.path.join(str(build_dir), 'libmt3flac.so')
        src = os.path.join(os.path.dirname(jax_flac_module.__file__),
                           'flac.cc')
        proc = subprocess.run(
            [shutil.which('g++') or 'c++', '-O2', '-std=c++17', '-fPIC',
             '-Wall', '-shared', '-o', out, src],
            capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        monkeypatch.setattr(jax_flac_module, '_LOADER',
                            jax_loader.LazyNativeLib(
                                out, configure=jax_flac_module._configure))
    assert jax_flac_module.flac_available(), 'the JAX FLAC codec'
    return jax_flac_module


@pytest.fixture(scope='module')
def jax_flac(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        yield jax_codec(mp, tmp_path_factory.mktemp('jax_flac'))


def _tone(n, channels=1, sr=16000, amp=12000):
    t = np.arange(n) / sr
    base = np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 880 * t)
    return np.stack([(amp * base * (1.0 - 0.2 * c)).astype(np.int32)
                     for c in range(channels)], axis=1)


def _long_ramp():
    # 2051 frames: frame numbers >= 2048 take the 3-byte UTF-8 form
    n = 4096 * 2050 + 17
    return (np.arange(n, dtype=np.int64) % 997 - 498).astype(np.int32)


def _noise():
    rng = np.random.default_rng(0)
    return rng.integers(-30000, 30000, size=(8000, 2)).astype(np.int32)


# (id, samples, sample rate, encoder keywords): tests/test_flac.py's
# round-trip matrix and the three bit depths
CASES = (
    [(f'mono_mode{m}', lambda: _tone(10000), 16000, dict(force_mode=m))
     for m in (-1, 0, 1, 2, 3, 4, 102, 108)]
    + [('stereo_independent', lambda: _tone(5000, channels=2), 44100, {})]
    + [(f'mid_side_mode{m}', lambda: _tone(9000, channels=2), 44100,
        dict(force_mode=m, mid_side=True)) for m in (-1, 2, 104)]
    + [('multi_frame', lambda: _tone(4096 * 3 + 123, channels=2), 44100,
        dict(mid_side=True)),
       ('past_2048_frames', _long_ramp, 16000, {})]
    + [(f'short_final_block_mode{m}_n{n}', lambda n=n: _tone(n), 16000,
        dict(force_mode=m)) for m, n in ((104, 4101), (4, 4097), (108, 4100))]
    + [('noise', _noise, 22050, {}),
       ('bits8', lambda: _tone(6000, channels=2, amp=100), 16000,
        dict(bits=8, force_mode=2)),
       ('bits16_lpc', lambda: _tone(6000, channels=2), 44100,
        dict(bits=16, force_mode=108, mid_side=True)),
       ('bits24', lambda: _tone(6000, channels=2, amp=3000000), 44100,
        dict(bits=24, force_mode=104))])


def _as_ints(y, bits):
    return (y.astype(np.float64) * float(1 << (bits - 1))).round().astype(
        np.int32)


@pytest.mark.parametrize('name,make,sr,kw', CASES, ids=[c[0] for c in CASES])
def test_decode_and_encode_equal_jax(jax_flac, name, make, sr, kw):
    x = make()
    bits = kw.get('bits', 16)
    data = flac.encode_flac_bytes(x, sr, **kw)
    y, got_sr = flac.decode_flac_bytes(data)
    assert got_sr == sr and y.dtype == np.float32
    np.testing.assert_array_equal(_as_ints(y, bits),
                                  x.reshape(len(x), -1))
    assert jax_flac.encode_flac_bytes(x, sr, **kw) == data
    want, want_sr = jax_flac.decode_flac_bytes(data)
    assert want_sr == got_sr
    np.testing.assert_array_equal(y, want)


def test_lpc_compresses_tonal():
    x = _tone(20000)
    assert len(flac.encode_flac_bytes(x, 16000, force_mode=108)) < \
        len(flac.encode_flac_bytes(x, 16000, force_mode=0))


def test_read_audio_flac_equals_jax(jax_flac, tmp_path):
    x = _tone(6000, channels=2)
    path = tmp_path / 'mix.flac'
    path.write_bytes(flac.encode_flac_bytes(x, 16000, mid_side=True))
    mono, sr = read_audio(str(path))
    assert sr == 16000 and mono.dtype == np.float32
    np.testing.assert_array_equal(
        mono, (x / 32768.0).astype(np.float32).mean(axis=1))
    from mr_mt3_tpu.audio import read_audio as jax_read_audio
    want, want_sr = jax_read_audio(str(path))
    assert want_sr == sr
    np.testing.assert_array_equal(mono, want)


def _outcome(decode, data):
    """('ok', samples, rate) or ('ValueError',); anything else raises."""
    try:
        y, sr = decode(data)
    except ValueError:
        return ('ValueError',)
    return ('ok', y, sr)


def _same_outcome(jax_flac, data):
    got = _outcome(flac.decode_flac_bytes, data)
    want = _outcome(jax_flac.decode_flac_bytes, data)
    assert got[0] == want[0]
    if got[0] == 'ok':
        assert got[2] == want[2]
        np.testing.assert_array_equal(got[1], want[1])
    return got[0]


def test_truncations_match_jax(jax_flac):
    data = flac.encode_flac_bytes(_tone(6000), 16000)
    outcomes = [_same_outcome(jax_flac, data[:cut])
                for cut in [4, 8, 20, 41, 42, 43, 100, len(data) // 2,
                            len(data) - 1]]
    assert outcomes[:3] == ['ValueError'] * 3


def test_deterministic_mutations_match_jax(jax_flac):
    data = bytearray(flac.encode_flac_bytes(_tone(6000, channels=2),
                                            16000, mid_side=True))
    rng = np.random.default_rng(11)
    rejected = 0
    for _ in range(200):
        corrupt = bytearray(data)
        for _ in range(int(rng.integers(1, 24))):
            corrupt[int(rng.integers(0, len(corrupt)))] = \
                int(rng.integers(0, 256))
        rejected += _same_outcome(jax_flac, bytes(corrupt)) == 'ValueError'
    assert rejected > 0


def test_frame_channel_count_exceeding_streaminfo_rejected(jax_flac):
    data = bytearray(flac.encode_flac_bytes(_tone(6000, channels=1), 16000))
    frame = 42  # the frame header follows the 4 + 38 bytes of metadata
    data[frame + 3] = (data[frame + 3] & 0x0F) | (10 << 4)  # mid-side
    assert _same_outcome(jax_flac, bytes(data)) == 'ValueError'


def test_huge_total_samples_rejected(jax_flac):
    data = bytearray(flac.encode_flac_bytes(_tone(600), 16000))
    data[17 + 4] |= 0x0F  # top 4 bits of the 36-bit total_samples
    assert _same_outcome(jax_flac, bytes(data)) == 'ValueError'


def test_garbage_raises():
    with pytest.raises(ValueError):
        flac.decode_flac_bytes(b'not a flac stream at all')


def _wav_bytes(pcm16, sr):
    data = pcm16.astype('<i2').tobytes()
    return (b'RIFF' + struct.pack('<I', 36 + len(data)) + b'WAVE'
            + b'fmt ' + struct.pack('<IHHIIHH', 16, 1, 1, sr, sr * 2, 2, 16)
            + b'data' + struct.pack('<I', len(data)) + data)


def test_decode_audio_flac_equals_wav_body():
    pcm = _tone(16000 * 2, amp=9000)[:, 0]
    from_wav = serve.decode_audio(_wav_bytes(pcm, 16000))
    from_flac = serve.decode_audio(flac.encode_flac_bytes(pcm, 16000))
    assert from_flac.dtype == np.float32
    np.testing.assert_array_equal(from_flac, from_wav)


def test_decode_audio_44k_stereo_equals_jax_path(jax_flac):
    """A 44.1 kHz stereo FLAC body: decoded, averaged over channels and
    resampled to 16 kHz as the JAX server does it."""
    x = _tone(44100, channels=2, sr=44100)
    body = flac.encode_flac_bytes(x, 44100, mid_side=True)
    got = serve.decode_audio(body)
    from mr_mt3_tpu.audio import resample as jax_resample
    samples, sr = jax_flac.decode_flac_bytes(body)
    want = jax_resample(samples.mean(axis=1), sr, 16000)
    assert got.dtype == np.float32 and len(got) == 16000
    np.testing.assert_array_equal(got, want)


def test_decode_audio_malformed_flac_is_a_value_error():
    body = flac.encode_flac_bytes(_tone(6000), 16000)
    with pytest.raises(ValueError, match='FLAC'):
        serve.decode_audio(body[:30])


@pytest.fixture(scope='module')
def tiny_server():
    handler = serve.build_handler([
        'device=cpu', 'eval.max_length=8', 'eval.batch_size=2',
        'model.config.d_model=32', 'model.config.d_kv=8',
        'model.config.d_ff=48', 'model.config.num_heads=4',
        'model.config.num_layers=1', 'model.config.num_decoder_layers=1'])
    srv = serve.make_server(handler, 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f'http://127.0.0.1:{srv.server_address[1]}'
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


def _post(url, body):
    req = urllib.request.Request(url, data=body, method='POST')
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_server_answers_flac_with_midi(tiny_server):
    body = flac.encode_flac_bytes(_tone(44100, channels=2, sr=44100), 44100)
    status, reply = _post(tiny_server + '/transcribe', body)
    assert status == 200 and reply[:4] == b'MThd'


def test_server_answers_malformed_flac_400(tiny_server):
    body = flac.encode_flac_bytes(_tone(6000), 16000)
    status, reply = _post(tiny_server + '/transcribe', body[:len(body) // 3])
    assert status == 400 and b'FLAC' in reply


@pytest.mark.slow
def test_asan_ubsan_fuzz():
    """Build the ASan+UBSan fuzz binary of the port's decoder into _build/
    and run the deterministic mutation corpus; any sanitizer report fails
    the run."""
    proc = subprocess.run([str(flac.build_flac_fuzz()), '20000'],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert 'fuzz ok' in proc.stdout
