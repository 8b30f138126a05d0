"""The system under test, `mr_mt3_tpu_torch`, as a cell runs it: the
model built by the program's own configuration loader and builders, the
benchmark's weights loaded into it, an InferenceHandler at the
configuration's tier, and (for traffic over HTTP) the program's
transcription server on an ephemeral port of this process.

This is the only file of the benchmark that imports the program. It
records, from outside, what the per-layer metrics and the comparison read:
each decode call's rows, chain positions and tokens (a wrapper around the
handler module's greedy_decode and segmem_greedy_decode), each song's
served tokens, the benchmark's spans around the handler's stages, and the
seconds that nvcc builds of the program's CUDA libraries took.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List

import numpy as np
import torch

from perfbench import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Recorder:
    """What the handler did, appended from whichever thread ran it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.on = False
        self.calls: List[dict] = []       # decode calls
        self.songs: List[dict] = []       # songs transcribed
        self.local = threading.local()

    def add(self, kind: str, item: dict) -> None:
        if self.on:
            with self.lock:
                getattr(self, kind).append(item)


class Program:
    """The handler (and server) of one cell, with its recorder."""

    def __init__(self, config: dict, traffic: dict, weights: dict,
                 device: str, tracer: trace.Tracer):
        from mr_mt3_tpu_torch.infer import InferenceHandler
        from mr_mt3_tpu_torch.utils import builders
        from mr_mt3_tpu_torch.utils.config import load_config

        self.config, self.traffic, self.tracer = config, traffic, tracer
        cfg = load_config(os.path.join(REPO, 'configs'),
                          config['program_config'],
                          list(config['program_overrides']))
        with torch.device(device):
            model = builders.build_model(cfg)
        check_sizes(model.cfg, config)
        model.load_state_dict(weights, strict=True)
        self.handler = InferenceHandler(
            model=model, mel_norm=True, contiguous_inference=False,
            batch_size=int(traffic['batch_size']),
            max_length=int(config['sizes']['max_length']),
            quantize=config['tier'], device=device)
        self.rec = Recorder()
        self.build_s = 0.0
        self._wrap()
        self.server = None
        self._thread = None

    # ---- recording ----

    def _wrap(self):
        """Wrap the handler module's decode entries and the handler's
        stages, recording and adding spans; `unwrap` restores them."""
        from mr_mt3_tpu_torch.infer import handler as hmod
        rec, h, span = self.rec, self.handler, self.tracer.span
        from mr_mt3_tpu_torch.ops import cuda_build
        self._saved = {name: getattr(hmod, name) for name in
                       ('greedy_decode', 'segmem_greedy_decode')}
        self._build = build = cuda_build.build

        def timed_build(name, *a, **kw):
            # the nvcc builds of a checkout's first run, timed apart
            t0 = time.perf_counter()
            built = not cuda_build.library_path(name).exists()
            out = build(name, *a, **kw)
            if built:
                self.build_s += time.perf_counter() - t0
            return out

        cuda_build.build = timed_build
        vanilla, segmem = self._saved['greedy_decode'], \
            self._saved['segmem_greedy_decode']

        def decode_call(fn, kind, x, kw):
            with span('decode'):
                tokens = fn(*x, **kw).cpu()
            mask = kw.get('valid_mask')
            rows = tokens.shape[0]
            rec.add('calls', {
                'kind': kind, 'rows': rows,
                'positions': 1 if tokens.dim() == 2 else tokens.shape[1],
                'real_rows': rows if mask is None else int(mask.sum()),
                'tokens': tokens.numpy()})
            return tokens

        def greedy_decode(*a, **kw):
            return decode_call(vanilla, 'vanilla', a, kw)

        def segmem_greedy_decode(*a, **kw):
            return decode_call(segmem, 'segmem', a, kw)

        hmod.greedy_decode = greedy_decode
        hmod.segmem_greedy_decode = segmem_greedy_decode

        many, mel_fn = h.transcribe_many, h._compute_mel
        dec_all, dec_chain = h._decode_all, h._decode_segmem_chained
        post, to_ns = h._postprocess, h._to_note_sequence

        def transcribe_many(audios):
            rec.local.current = cur = {'audios': list(audios),
                                       'segments': [], 'tokens': None}
            with span('transcribe_many'):
                out = many(audios)
            tokens = cur['tokens']
            if isinstance(tokens, np.ndarray):        # vanilla: split
                parts, off = [], 0
                for n in cur['segments']:
                    parts.append(tokens[off:off + n])
                    off += n
                tokens = parts
            for audio, toks in zip(cur['audios'], tokens):
                rec.add('songs', {'audio': audio, 'tokens': toks})
            return out

        def compute_mel(segments, valid):
            rec.local.current['segments'].append(len(valid))
            with span('mel'):
                return mel_fn(segments, valid)

        def decode_all(mel):
            out = dec_all(mel)
            rec.local.current['tokens'] = out
            return out

        def decode_chain(mels):
            out = dec_chain(mels)
            rec.local.current['tokens'] = out
            return out

        def postprocess(tokens):
            with span('postprocess'):
                return post(tokens)

        def to_note_sequence(tokens, seg_times):
            with span('postprocess'):
                return to_ns(tokens, seg_times)

        h.transcribe_many = transcribe_many
        h._compute_mel = compute_mel
        h._decode_all = decode_all
        h._decode_segmem_chained = decode_chain
        h._postprocess = postprocess
        h._to_note_sequence = to_note_sequence

    def unwrap(self):
        from mr_mt3_tpu_torch.infer import handler as hmod
        from mr_mt3_tpu_torch.ops import cuda_build
        for name, fn in self._saved.items():
            setattr(hmod, name, fn)
        cuda_build.build = self._build

    # ---- the paths traffic takes ----

    def call_sizes(self, chains: int) -> list:
        """The decode-call sizes of one transcribe_many call over `chains`
        memory chains (the program's own rule)."""
        return self.handler._call_sizes(
            chains, floor=4, capped=self.config['tier'].startswith('fused'))

    def transcribe_many(self, audios):
        return self.handler.transcribe_many(audios)

    def serve(self) -> int:
        """Start the program's HTTP server on an ephemeral port; returns
        the port."""
        from mr_mt3_tpu_torch.serve import make_server
        self.server = make_server(self.handler, 0,
                                  {'quantize': self.handler.quantize,
                                   'prewarmed': True})
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name='server')
        self._thread.start()
        return self.server.server_address[1]

    def close(self):
        """Stop the server, restore the wrapped functions and drop the
        model and its packed weights (the server's worker thread keeps
        the handler object)."""
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self._thread.join(timeout=30)
            self.server = None
        self.unwrap()
        self.handler.model = None
        self.handler.replicas = []


def check_sizes(mcfg, config: dict) -> None:
    """Raise unless the program's model has the configuration's sizes."""
    sizes = config['sizes']
    got = {'d_model': mcfg.d_model, 'd_kv': mcfg.d_kv, 'd_ff': mcfg.d_ff,
           'num_heads': mcfg.num_heads, 'num_layers': mcfg.num_encoder_layers,
           'num_decoder_layers': mcfg.num_decoder_layers,
           'vocab_size': mcfg.vocab_size, 'mel_bins': mcfg.mel_bins,
           'layer_norm_epsilon': mcfg.layer_norm_epsilon,
           'segmem_length': mcfg.segmem_length if mcfg.has_segmem else 0,
           'segmem_num_layers': (mcfg.segmem_num_layers if mcfg.has_segmem
                                 else 0)}
    bad = {k: (v, sizes[k]) for k, v in got.items() if sizes[k] != v}
    dtype = 'bfloat16' if mcfg.dtype == 'bfloat16' else 'float32'
    if dtype != config['dtype']:
        bad['dtype'] = (dtype, config['dtype'])
    if bad:
        raise ValueError(f'the program built other sizes than the '
                         f'configuration states (program, file): {bad}')
