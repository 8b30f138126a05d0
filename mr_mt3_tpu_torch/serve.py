"""Transcription server for the PyTorch port (port of the repo's serve.py).

A long-lived process with the model resident on the card, on the standard
library only:

  POST /transcribe       body: WAV or FLAC bytes -> Standard MIDI File bytes
  POST /transcribe.json  body: WAV or FLAC bytes -> JSON note list
  GET  /healthz          -> {"status": "ok", ...}

Requests queue through one device worker that coalesces concurrent songs
into one transcribe_many call. FLAC bodies decode through the port's native
codec (native/flac.cc, built by g++ at first use); a malformed one is a
400.

Usage:
  python -m mr_mt3_tpu_torch.serve --port 8742 [path=<checkpoint>]
      [--config-name=... model=...] [device=cpu]

model=MT3NetSegMemV2WithPrev trainer.precision=bf16 serves the MR-MT3
segment-memory model, its memory encoder's attention on the CUDA
fused_attention kernel. With no path, serves seeded random weights
(plumbing/latency testing). The
decode tier defaults to 'fused_int4' (the CUDA window kernel in its int4
mode) on the card, as the JAX server does on the TPU, and to the exact path
with device=cpu; eval.quantize (or +eval.quantize) overrides it, with any
tier of ops/decode.py::greedy_decode ('int8' and 'int8_kv' run the
step-by-step loop on the CUDA int8 kernels). Before traffic,
prepare_handler walks the probe ladder (infer/probe.py: int4 -> int8 ->
bf16 -> exact, and 'int8' or 'int8_kv' -> exact, demoting on a material
token flip) and prewarms the
surviving tier; on the card a failing kernel stops the server instead of
demoting. /healthz reports the walk under "decode".

`devices` (null: every visible card; an int or a list of ids: how many)
serves from a model replica on each card, the decode batches sharded over
them (parallel.Mesh), as the JAX server spans its chips; /healthz names
the devices under "devices".
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
    from mr_mt3_tpu_torch import parallel
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
    quantize = str(cfg.eval.get('quantize') or default_quantize(device))
    if quantize == 'auto':
        # the serving default, guarded by prepare_handler's probe
        quantize = default_quantize(device)
    # the data axis: a replica on each of `devices` cards
    n_dev = parallel.data_devices(cfg.get('devices'), device)
    mesh = (parallel.make_mesh(data=n_dev,
                               devices=parallel.visible_devices(device.type))
            if n_dev > 1 else None)
    return InferenceHandler(
        model=model, mel_norm=mel_norm,
        contiguous_inference=bool(cfg.eval.get('contiguous_inference')),
        batch_size=int(cfg.eval.get('batch_size') or 8),
        max_length=int(cfg.eval.get('max_length') or 1024),
        quantize=quantize, mesh=mesh,
        device=device if mesh is None else None)


def default_quantize(device) -> str:
    """The serving tier before the probe ladder: the int4 window kernel
    on the card (the JAX server's TPU default), the exact path on the
    CPU (where the window kernel would run as its plain version)."""
    return 'fused_int4' if device.type == 'cuda' else 'none'


def quantize_probe(handler, max_length=None, **kw):
    """Decode a probe batch through the handler's quantized path AND an
    exact twin; return (flipped_tokens, total_tokens), or, when the
    ladder asks for classify=True, the classified dict. max_length is
    passed by the ladder's full-length confirm (None = the short length).
    Library home: mr_mt3_tpu_torch.infer.probe; re-exported here so tests
    and operators can monkeypatch the serving entry point."""
    from mr_mt3_tpu_torch.infer.probe import quantize_probe as _probe
    if max_length is None:
        return _probe(handler, **kw)
    return _probe(handler, max_length=max_length, **kw)


def prepare_handler(handler, probe: bool = True):
    """Pre-traffic safety and latency work; returns an info dict for
    /healthz.

    1. quantize guard: with a quantized tier, the probe ladder
       (infer/probe.resolve_auto_quantize) decodes a probe batch quantized
       AND exact; a MATERIAL token flip (its first divergence at a logit
       margin numeric noise cannot cross) demotes one tier ('fused_int4'
       -> 'fused' -> 'fused_bf16' -> 'none'). Benign near-tie flips keep
       the tier and are reported.
    2. prewarm: transcribe_many on the probe audio, the path every
       request takes, so the first request finds the kernels built and
       loaded, once per distinct device-call size real traffic can take:
       vanilla non-contiguous decodes pad every call to one batch shape
       (bucket list [1]); contiguous mode warms each lockstep song bucket
       up to MicroBatcher.MAX_COALESCE; an 'encoder_append' model warms
       each pow2 chain bucket up to handler.POW2_BUCKET_CAP. Counts that
       give no new call size (handler._call_sizes) are skipped. Then, on
       the card, every phase of the step loop's decode shapes those calls
       ran is captured as CUDA graphs (handler.capture_graphs; /healthz
       reports their seconds and memory under 'graphs').
    A probe or prewarm failure demotes one tier (and re-runs the ladder)
    only where probe.demotes_on_error allows it, the CPU; on the card, and
    at 'none', it re-raises.
    """
    from mr_mt3_tpu_torch.infer import probe as probe_mod

    def demote_tier(reason: str):
        nxt = probe_mod._NEXT_TIER.get(handler.quantize, 'none')
        print(f'WARNING: quantize={handler.quantize!r} demoted to '
              f'{nxt!r} for serving ({reason})', file=sys.stderr)
        info.setdefault('demotions', []).append(reason)
        handler.quantize = nxt
        handler._invalidate_compiled()
        # the recorded probe counts belong to the tier just left: /healthz
        # must not present them as evidence for the new one
        for k in probe_mod.PROBE_INFO_KEYS:
            info.pop(k, None)

    info = {'quantize': handler.quantize, 'prewarmed': False}
    while True:
        if probe and handler.quantize != 'none':
            t0 = time.monotonic()
            before = handler.quantize
            demoted_before = len(info.get('demotions', []))
            probed = probe_mod.resolve_auto_quantize(
                handler, verbose=False,
                probe_fn=lambda h, **kw: quantize_probe(h, **kw))
            info.setdefault('demotions', []).extend(
                probed.pop('demotions', []))
            info.update(probed)
            info['probe_seconds'] = round(
                info.get('probe_seconds', 0.0) + time.monotonic() - t0, 1)
            if handler.quantize != before:
                why = '; '.join(info['demotions'][demoted_before:])
                print(f'WARNING: quantize={before!r} demoted to '
                      f'{handler.quantize!r} for serving ({why})',
                      file=sys.stderr)
        t0 = time.monotonic()
        prewarm_before = info.get('prewarm_seconds', 0.0)
        audio, counts = prewarm_plan(handler)
        try:
            for k in counts:
                handler.transcribe_many([audio] * k)
        except Exception as e:  # noqa: BLE001
            # treat a prewarm failure like a probe failure: demote one
            # tier and re-run the ladder from there; at 'none' there is no
            # further fallback. prewarm_seconds accumulates across failed
            # attempts.
            info['prewarm_seconds'] = round(
                prewarm_before + time.monotonic() - t0, 1)
            if handler.quantize == 'none' or \
                    not probe_mod.demotes_on_error(handler):
                raise
            demote_tier(f'prewarm failed at full length ({e!r})')
            continue
        graphs = handler.capture_graphs()
        if graphs:              # the card's; the CPU keeps the JAX keys
            info['graphs'] = graphs
        info['prewarm_seconds'] = round(
            prewarm_before + time.monotonic() - t0, 1)
        info['prewarmed'] = True
        info['prewarm_buckets'] = counts
        break
    info['quantize'] = handler.quantize
    print(f'serving decode path: quantize={handler.quantize!r} '
          f'(probe={info.get("probe_flips", "skipped")} flips, '
          f'prewarmed={info["prewarmed"]})')
    return info


def prewarm_plan(handler):
    """(probe audio, song counts) for prepare_handler's prewarm: one
    count for each new device-call size the handler's decode can take."""
    from mr_mt3_tpu_torch.infer import probe as probe_mod
    from mr_mt3_tpu_torch.infer.handler import POW2_BUCKET_CAP
    audio = probe_mod.probe_audio(2)
    capped = handler.quantize.startswith('fused')
    if handler.contiguous_inference:
        # leading axis = lockstep songs, bounded by the coalesce cap
        floor = 1
        candidates = [1 << i for i in range(
            (MicroBatcher.MAX_COALESCE - 1).bit_length() + 1)]
    elif handler.cfg.segmem_variant == 'encoder_append':
        # leading axis = memory chains (ceil(segments / batch_size) per
        # song, floor 4): one long song gives more chains than the
        # coalesce cap has songs, so every pow2 chain bucket is warmed.
        # The probe song must be exactly one chain, so k songs give k
        # chains: at batch_size 1 the 2-segment probe would be 2.
        if handler.batch_size < 2:
            audio = probe_mod.probe_audio(1)
        floor = 4
        candidates = [1 << i for i in range(POW2_BUCKET_CAP.bit_length())]
    else:
        # vanilla non-contiguous: every call is padded to one batch shape
        return audio, [1]
    counts, seen = [], set()
    for k in candidates:
        new = [s for s in handler._call_sizes(k, floor=floor, capped=capped)
               if s not in seen]
        if new:
            seen.update(new)
            counts.append(k)
    return audio, counts


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
    """Request body (WAV or FLAC) -> float32 16 kHz mono samples;
    ValueError -> 400. A FLAC codec that cannot be built raises
    RuntimeError, as in the JAX server."""
    import struct
    from math import gcd

    import numpy as np

    from mr_mt3_tpu_torch.audio import read_wav_bytes, resample
    try:
        if body[:4] == b'fLaC':
            from mr_mt3_tpu_torch.native.flac import decode_flac_bytes
            samples, sr = decode_flac_bytes(body)
            samples = samples.mean(axis=1)
        elif body[:4] == b'RIFF':
            samples, sr = read_wav_bytes(body)
        else:
            raise ValueError('body must be WAV or FLAC bytes')
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
    stats = {'requests': 0, 'audio_seconds': 0.0, 'batches': 0,
             'devices': [str(r.device) for r in handler.replicas]}
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
