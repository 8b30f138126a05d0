"""Transcription server for the PyTorch port (port of the repo's serve.py).

A long-lived process with the model resident on the card, on the standard
library only:

  POST /transcribe       body: WAV bytes -> Standard MIDI File bytes
  POST /transcribe.json  body: WAV bytes -> JSON note list
  GET  /healthz          -> {"status": "ok", ...}

Requests queue through one device worker that coalesces concurrent songs
into one transcribe_many call. FLAC input is not yet ported (400).

Usage:
  python -m mr_mt3_tpu_torch.serve --port 8742 [path=<checkpoint>]
      [--config-name=... model=...] [device=cpu]

With no path, serves seeded random weights (plumbing/latency testing). The
decode tier defaults to 'fused_bf16' (the CUDA window kernel) on the card
and to the exact path with device=cpu; eval.quantize overrides it.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

REPO_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs')


def build_handler(argv):
    """CLI-style args (test.py grammar) -> InferenceHandler."""
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.utils import builders
    from mr_mt3_tpu_torch.utils.config import load_config, parse_cli
    from mr_mt3_tpu_torch.utils.device import resolve_device

    args = [a for a in argv if not a.startswith('--port')]
    config_name, config_dir, overrides = parse_cli(args)
    default_dir = os.environ.get('MR_MT3_CONFIGS') or REPO_CONFIGS
    cfg = load_config(config_dir or default_dir, config_name, overrides)
    device = resolve_device(cfg.get('device'))

    model = builders.build_model(cfg)
    if cfg.get('path'):
        builders.load_weights(str(cfg.path), model)
        mel_norm = 'pretrained/mt3.pth' not in str(cfg.path)
    else:
        print('WARNING: serving randomly initialized weights '
              '(no path= given)', file=sys.stderr)
        builders.init_params(model)
        mel_norm = True
    default = 'fused_bf16' if device.type == 'cuda' else 'none'
    quantize = str(cfg.eval.get('quantize') or default)
    if quantize == 'auto':
        quantize = default
    return InferenceHandler(
        model=model, mel_norm=mel_norm,
        contiguous_inference=bool(cfg.eval.get('contiguous_inference')),
        batch_size=int(cfg.eval.get('batch_size') or 8),
        max_length=int(cfg.eval.get('max_length') or 1024),
        quantize=quantize, device=device)


def prepare_handler(handler):
    """Pre-traffic work; returns an info dict for /healthz.

    The prewarm runs one transcribe_many on the probe audio, the path every
    request takes, so the first request finds the kernel built and loaded.
    (The JAX package's quantize probe ladder is not yet ported: the
    'fused_bf16' tier is the exact numerics class and needs no probe.)"""
    from mr_mt3_tpu_torch.infer.probe import probe_audio
    t0 = time.monotonic()
    handler.transcribe_many([probe_audio(2)])
    # vanilla non-contiguous decode pads every call to one batch shape, so
    # one song warms all traffic (the JAX server's bucket list is [1] here)
    info = {'quantize': handler.quantize, 'prewarmed': True,
            'prewarm_seconds': round(time.monotonic() - t0, 1),
            'prewarm_buckets': [1]}
    print(f'serving decode path: quantize={handler.quantize!r} '
          f'(prewarmed={info["prewarmed"]})')
    return info


class MicroBatcher:
    """Coalesces concurrent transcription requests into one device batch.

    Requests that arrive while the device is busy queue up; when the worker
    frees, everything waiting (up to MAX_COALESCE songs) runs as ONE
    transcribe_many call."""

    MAX_COALESCE = 8

    def __init__(self, handler):
        import queue
        self.handler = handler
        self.batches = 0
        self._q: 'queue.Queue' = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def transcribe(self, audio):
        done = threading.Event()
        slot = {'result': None, 'error': None}
        self._q.put((audio, slot, done))
        done.wait()
        if slot['error'] is not None:
            raise slot['error']
        return slot['result']

    def _drain(self):
        import queue
        batch = [self._q.get()]  # block for the first request
        while len(batch) < self.MAX_COALESCE:
            try:
                batch.append(self._q.get_nowait())
            except queue.Empty:
                break
        return batch

    def _run(self):
        while True:
            batch = self._drain()
            self.batches += 1
            audios = [b[0] for b in batch]
            try:
                try:
                    results = self.handler.transcribe_many(audios)
                    if len(results) != len(batch):
                        raise RuntimeError(
                            f'transcribe_many returned {len(results)} '
                            f'results for {len(batch)} songs')
                    for (_, slot, done), ns in zip(batch, results):
                        slot['result'] = ns
                        done.set()
                except Exception:
                    # isolate the failing song: retry one request at a time
                    for audio, slot, done in batch:
                        try:
                            slot['result'] = \
                                self.handler.transcribe_many([audio])[0]
                        except Exception as e:  # noqa: BLE001
                            slot['error'] = e
                        done.set()
            except BaseException as e:  # never die with waiters blocked
                for _, slot, done in batch:
                    if not done.is_set():
                        slot['error'] = RuntimeError(
                            f'transcription worker error: {e!r}')
                        done.set()


def decode_audio(body: bytes):
    """Request body -> float32 16 kHz mono samples; ValueError -> 400."""
    import struct
    from math import gcd

    import numpy as np

    from mr_mt3_tpu_torch.audio import read_wav_bytes, resample
    if body[:4] == b'fLaC':
        raise ValueError('FLAC input not yet ported')
    if body[:4] != b'RIFF':
        raise ValueError('body must be WAV or FLAC bytes')
    try:
        samples, sr = read_wav_bytes(body)
    except (struct.error, IndexError, KeyError) as e:
        raise ValueError(f'malformed audio container: {e!r}')
    # bound the resampler's filter design (a corrupt header's rate)
    if not 1000 <= sr <= 768000:
        raise ValueError(f'implausible sample rate: {sr}')
    if max(sr, 16000) // gcd(int(sr), 16000) > 8000:
        raise ValueError(
            f'unsupported sample rate for resampling: {sr} '
            '(use a standard audio rate, e.g. 44100/48000/16000)')
    if sr != 16000:
        samples = resample(samples, sr, 16000)
    return samples.astype(np.float32)


def make_server(handler, port: int, info=None):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from mr_mt3_tpu_torch.midi import note_sequence_to_midi_bytes

    batcher = MicroBatcher(handler)
    stats = {'requests': 0, 'audio_seconds': 0.0, 'batches': 0}
    if info is None:
        info = {'quantize': handler.quantize, 'prewarmed': False}
    stats['decode'] = info
    stats_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _reply(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/healthz':
                with stats_lock:
                    payload = json.dumps({'status': 'ok', **stats})
                self._reply(200, payload.encode(), 'application/json')
            else:
                self._reply(404, b'not found', 'text/plain')

        def do_POST(self):
            if self.path not in ('/transcribe', '/transcribe.json'):
                self._reply(404, b'not found', 'text/plain')
                return
            try:
                length = int(self.headers.get('Content-Length') or 0)
            except ValueError:
                self._reply(400, b'bad Content-Length', 'text/plain')
                return
            if length < 0 or length > 1 << 30:
                self._reply(400, b'bad Content-Length', 'text/plain')
                return
            body = self.rfile.read(length)
            try:
                audio = decode_audio(body)
                ns = batcher.transcribe(audio)
                with stats_lock:
                    stats['requests'] += 1
                    stats['audio_seconds'] += len(audio) / 16000.0
                    stats['batches'] = batcher.batches
                if self.path == '/transcribe.json':
                    notes = [{'pitch': n.pitch, 'start': n.start_time,
                              'end': n.end_time, 'velocity': n.velocity,
                              'program': n.program, 'is_drum': n.is_drum}
                             for n in ns.notes]
                    self._reply(200, json.dumps({'notes': notes}).encode(),
                                'application/json')
                else:
                    self._reply(200, note_sequence_to_midi_bytes(ns),
                                'audio/midi')
            except ValueError as e:
                self._reply(400, str(e).encode(), 'text/plain')
            except Exception as e:  # noqa: BLE001
                self._reply(500, f'internal error: {e}'.encode(),
                            'text/plain')

    return ThreadingHTTPServer(('127.0.0.1', port), Handler)


def main():
    port = 8742
    argv = []
    it = iter(sys.argv[1:])
    for arg in it:
        if arg.startswith('--port'):
            port = int(arg.split('=', 1)[1] if '=' in arg else next(it))
        else:
            argv.append(arg)
    handler = build_handler(argv)
    info = prepare_handler(handler)
    server = make_server(handler, port, info)
    print(f'serving on http://127.0.0.1:{port} '
          '(POST /transcribe, /transcribe.json; GET /healthz)')
    server.serve_forever()


if __name__ == '__main__':
    main()
