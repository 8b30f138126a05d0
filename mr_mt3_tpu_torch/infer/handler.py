"""Transcription inference engine (port of mr_mt3_tpu/infer/handler.py).

Audio -> segments -> log-mel -> encoder -> greedy decode -> tokens ->
NoteSequence -> MIDI, as the reference InferenceHandler (reference:
inference.py:20-234). Vanilla MT3 decodes segments in independent
batches; the segment-memory models decode memory chains
(ops/decode.py::segmem_greedy_decode): contiguous_inference runs each song
as one chain, and without it an 'encoder_append' model chains the segments
of every batch_size-long run, as the reference's generate() does. The
frontend, encoder and decode run on the handler's device ('cuda' unless
device='cpu' is passed); framing, postprocess, NoteSequence assembly and
MIDI writing are host numpy code, identical to the JAX package's.

With a mesh (parallel/mesh.py) the decode batch shards over the data axis
as the JAX handler's shard_map does: each mesh device holds a replica of
the model and its decode parameters, each device call's rows split into
n_data equal contiguous parts, part i decodes on replica i on a host
thread of its own, and the tokens are gathered back in row order.

With a model axis above 1 (tensor parallelism, the JAX handler's jit over
param_shardings) the handler is one rank of the mesh's grid: the model is
sharded in place (parallel/tensor.py::shard_model), each call's rows split
over the data index, the rank's model group decodes its part on the exact
tier with the collectives in the step, and the tokens are all-gathered
over the data group, so every rank returns every row. The quantized tiers
read whole weight matrices and are refused, as in JAX.
"""

from __future__ import annotations

import copy
import math
import os
import threading
import traceback
from contextlib import nullcontext
from typing import List, Optional

import numpy as np
import torch

from mr_mt3_tpu_torch.audio import (
    SpectrogramConfig,
    compute_logmel,
    normalize_logmel,
)
from mr_mt3_tpu_torch.codec import (
    DECODED_EOS_ID,
    VocabularyConfig,
    build_codec,
    vocabulary_from_codec,
)
from mr_mt3_tpu_torch.codec import note_sequences
from mr_mt3_tpu_torch.codec.combine import event_predictions_to_ns
from mr_mt3_tpu_torch.midi import note_sequence_to_midi_file
from mr_mt3_tpu_torch.models import MT3
from mr_mt3_tpu_torch.ops.decode import (
    check_quantize,
    greedy_decode,
    segmem_greedy_decode,
)
from mr_mt3_tpu_torch.ops.mel_kernel import logmel
from mr_mt3_tpu_torch.parallel import all_gather_cat
from mr_mt3_tpu_torch.parallel.tensor import shard_model
from mr_mt3_tpu_torch.utils.device import resolve_device


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# largest leading-axis size that still pow2-buckets; beyond it sizes grow
# in multiples of 4. serve.py's prewarm derives its chain buckets from it.
POW2_BUCKET_CAP = 64


def _pow2_bucket(n: int, cap: int = POW2_BUCKET_CAP) -> int:
    """Next power of two >= n for n <= cap, else a multiple of 4: the
    leading axis of a chain or lockstep decode takes few distinct sizes
    (padding rows start finished and cost no decode steps)."""
    if n <= 1:
        return 1
    if n > cap:
        return _round_up(n, 4)
    return 1 << int(n - 1).bit_length()


class Replica:
    """One data-axis device's model and the decode parameters stacked for
    the handler's tier (and with them the step loop's runners and CUDA
    graphs)."""

    def __init__(self, model: MT3, device: torch.device):
        self.model = model
        self.device = device
        self.dp = None

    def decode_params(self, quantize: str):
        if self.dp is None:
            from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params
            self.dp = stack_decode_params(self.model, quantize=quantize)
        return self.dp


class InferenceHandler:
    """Audio -> MIDI transcription.

    Args:
      model: an MT3 (port; vanilla or segment memory) with its weights
        loaded; it is moved to the handler's device.
      weight_path: alternatively, a reference-format torch checkpoint to
        load into a default-config MT3 (reference: inference.py:31-42).
      mel_norm: clamp/scale log-mel to [0,1]; off for the official
        checkpoint (reference: test.py:123).
      contiguous_inference: run each song as one sequential segment
        chain so the memory propagates (reference: inference.py:176-181).
      filterbank_style: 'torch' for in-repo models, 'tf' for the official
        checkpoint.
      segment_bucket: contiguous mode pads a song's segment count to a
        multiple of it.
      quantize: 'none' (exact); 'int8' (int8 feed-forward and lm_head
        weights) or 'int8_kv' (int8 K/V), the step-by-step loop on the
        CUDA int8 kernels; or a tier of the CUDA window kernel:
        'fused_bf16', 'fused' (int8) or 'fused_int4' (the serving default
        on the card, guarded by the probe ladder of infer/probe.py).
      device: None or 'cuda' (raises without a card) or 'cpu'.
      segmem_chain: False reseeds the memory every segment (a diagnostic
        ablation of ops/decode.py::segmem_greedy_decode).
      segmem_memory_format: 'reference' keeps the start id in the carried
        memory, 'train_aligned' drops it.
      mesh: a parallel.Mesh: the decode batch (segments, memory chains,
        lockstep songs) shards over its data axis, one model replica a
        device (the handler's device is the mesh's first). batch_size is
        then per device and never rounded, as in the JAX handler: for the
        segment-memory models it is the chain length. A mesh with a model
        axis above 1 is a grid of the process group's ranks: this rank
        (its device devices[rank]) holds its shard of `model`, sharded in
        place unless it already is, and decodes with its model group at
        quantize='none' only (the other tiers raise ValueError).
    """

    SAMPLE_RATE = 16000

    def __init__(self,
                 model: Optional[MT3] = None,
                 weight_path: Optional[str] = None,
                 mel_norm: bool = True,
                 contiguous_inference: bool = False,
                 filterbank_style: str = 'torch',
                 batch_size: int = 8,
                 max_length: int = 1024,
                 segment_bucket: int = 32,
                 quantize: str = 'none',
                 mesh=None,
                 device=None,
                 segmem_chain: bool = True,
                 segmem_memory_format: str = 'reference'):
        check_quantize(quantize)
        self.mesh = mesh
        self.sharded = mesh is not None and mesh.model > 1
        if self.sharded and quantize != 'none':
            raise ValueError(
                f'quantize={quantize!r} is not supported with a model axis '
                '> 1: the decode kernels read whole weight matrices. Use a '
                'data-only mesh for quantized serving, or quantize=\'none\' '
                'for tensor parallelism.')
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = mesh.rank_device()
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f'device {device} is not the mesh\'s '
                                 f'device {self.device} for this rank')
        if model is None:
            if weight_path is None:
                raise ValueError('need model or weight_path')
            from mr_mt3_tpu_torch.models import MT3Config
            from mr_mt3_tpu_torch.utils.builders import load_weights
            model = load_weights(weight_path, MT3(MT3Config()))
        if self.sharded and model.tp is None:
            shard_model(model, mesh)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.n_data = 1 if mesh is None else mesh.n_data
        self.replicas = [Replica(self.model, self.device)]
        if mesh is not None and not self.sharded:
            self.replicas += [Replica(copy.deepcopy(self.model).to(d).eval(),
                                      d) for d in mesh.devices[1:]]
        self.mel_norm = mel_norm
        self.contiguous_inference = contiguous_inference
        self.segmem_chain = segmem_chain
        self.segmem_memory_format = segmem_memory_format
        self.batch_size = batch_size
        self.max_length = max_length
        self.segment_bucket = segment_bucket
        self.quantize = quantize
        self.spectrogram_config = SpectrogramConfig(
            filterbank_style=filterbank_style)
        self.codec = build_codec(VocabularyConfig(num_velocity_bins=1))
        self.vocab = vocabulary_from_codec(self.codec)
        self.mel_length = 256

    def _invalidate_compiled(self):
        """Drop every replica's decode parameters stacked and packed for
        the current tier, and with them the step loop's runners and CUDA
        graphs. Called whenever the tier changes (the probe ladder, serve's
        prewarm demotion), so a demoted handler never decodes with the
        previous tier's packed weights."""
        for replica in self.replicas:
            replica.dp = None

    def capture_graphs(self) -> dict:
        """Capture every phase of every step-loop decode shape this
        handler has run (serve's prewarm, after its decodes): a request
        then replays graphs only, even where the prewarm's audio stopped
        early. On the card only; the replicas one after another, from this
        thread. Returns the graphs' numbers for /healthz: the captures'
        seconds in all, the device memory (torch.cuda.memory_allocated and
        memory_reserved, before and after each capture) and the greedy
        steps the warm-ups ran."""
        from mr_mt3_tpu_torch.ops.decode import capture_module_phases
        from mr_mt3_tpu_torch.ops.fast_decode import capture_phases
        if self.device.type != 'cuda':
            return {}
        if self.sharded and self.model.tp.backend() == 'gloo':
            return {'graphs': False,
                    'reason': 'tensor-parallel decode over gloo runs its '
                              'step loops eagerly'}
        parts = []
        for replica in self.replicas:
            with torch.cuda.device(replica.device):
                parts.append(capture_module_phases(replica.model))
                if replica.dp is not None:
                    parts.append(capture_phases(replica.dp))
        out = {k: sum(p[k] for p in parts) for k in parts[0]}
        out['capture_seconds'] = round(out['capture_seconds'], 3)
        return out

    # ---- host-side preprocessing (reference: inference.py:64-127) ----

    def _audio_to_segments(self, audio: np.ndarray):
        """Frame and split audio into zero-padded (N, mel_length*hop) chunks.

        Returns (segment_samples (N, 32768), frame_times (N, 256),
        valid_frames per segment)."""
        hop = self.spectrogram_config.hop_width
        pad = hop - len(audio) % hop
        audio = np.pad(audio, (0, pad))
        num_frames = len(audio) // hop
        times = np.arange(num_frames) / self.spectrogram_config.frames_per_second
        seg_frames = self.mel_length
        num_segments = math.ceil(num_frames / seg_frames)
        seg_samples = seg_frames * hop
        segments = np.zeros((num_segments, seg_samples), dtype=np.float32)
        seg_times = np.zeros((num_segments, seg_frames))
        valid = []
        for i in range(num_segments):
            f0 = i * seg_frames
            f1 = min(f0 + seg_frames, num_frames)
            n = f1 - f0
            segments[i, :n * hop] = audio[f0 * hop:f1 * hop]
            seg_times[i, :n] = times[f0:f1]
            valid.append(n)
        return segments, seg_times, valid

    @torch.no_grad()
    def _compute_mel(self, segments: np.ndarray, valid: List[int]
                     ) -> torch.Tensor:
        """Segments -> log-mel (N, 256, mel_bins) on the handler's device;
        frames past each segment's valid count are zeroed (reference:
        inference.py:125-127). On the card the log-mel is the CUDA kernel
        ops/mel_kernel.py::logmel (a DFT by products); on the CPU its plain
        version, compute_logmel (an FFT)."""
        x = torch.as_tensor(np.asarray(segments, np.float32),
                            device=self.device)
        if x.is_cuda:
            mel = logmel(x, self.spectrogram_config)
        else:
            mel = compute_logmel(x, self.spectrogram_config)
        if self.mel_norm:
            mel = normalize_logmel(mel)
        frames = torch.arange(mel.shape[1], device=self.device)
        n_valid = torch.as_tensor(np.asarray(valid, np.int64),
                                  device=self.device)
        keep = frames[None, :, None] < n_valid[:, None, None]
        return torch.where(keep, mel, torch.zeros_like(mel))

    # ---- device-side decode ----

    def _decode_params(self):
        return self.replicas[0].decode_params(self.quantize)

    def _call_sizes(self, n_real: int, floor: int, capped: bool) -> list:
        """Device-call sizes for a leading axis of n_real chains or songs:
        one pow2-bucketed call; on a window tier (capped) at most
        FUSED_MAX_BATCH rows per device per call, full-cap calls plus a
        pow2-bucketed remainder. Every size is a multiple of the data axis
        (JAX handler: mr_mt3_tpu/infer/handler.py:314-351). Rows are
        independent, so the split changes no token."""
        def bucket(n):
            return _round_up(max(floor, _pow2_bucket(n)), self.n_data)
        if not capped:
            return [bucket(n_real)]
        from mr_mt3_tpu_torch.ops.fused_decode import FUSED_MAX_BATCH
        cap = FUSED_MAX_BATCH * self.n_data
        if bucket(n_real) <= cap:
            return [bucket(n_real)]
        sizes = [cap] * (n_real // cap)
        rem = n_real % cap
        if rem:
            # pow2-bucketing then rounding up to n_data can pass the cap on
            # a non-pow2 mesh (rem 40, n_data 6: 66 > 48): one full-cap
            # call then
            sizes.append(min(bucket(rem), cap))
        return sizes

    def _on_replicas(self, decode, rows: torch.Tensor,
                     valid_mask: torch.Tensor) -> np.ndarray:
        """decode(replica, rows, mask) -> tokens, over the data axis: the
        leading axis (a multiple of n_data) in n_data equal contiguous
        parts, part i on replica i, each on a host thread of its own (a
        step loop's exit check waits on its device; from one thread the
        devices would take turns); the tokens gathered in row order. On
        a model axis part i is data index i's, decoded by its model group,
        and the parts are all-gathered over the data group."""
        if self.n_data == 1:
            return decode(self.replicas[0], rows, valid_mask)
        if self.sharded:
            part = rows.shape[0] // self.n_data
            i = self.mesh.data_index()
            mine = decode(self.replicas[0], rows[i * part:(i + 1) * part],
                          valid_mask[i * part:(i + 1) * part])
            return all_gather_cat(torch.as_tensor(mine),
                                  self.mesh.data_group()).numpy()
        part = rows.shape[0] // self.n_data
        outs = [None] * self.n_data
        errors = []

        def run(i):
            replica = self.replicas[i]
            cuda = replica.device.type == 'cuda'
            try:
                with torch.no_grad(), (torch.cuda.device(replica.device)
                                       if cuda else nullcontext()):
                    if cuda:    # the thread's context, made current
                        torch.cuda.synchronize(replica.device)
                    rows_i = rows[i * part:(i + 1) * part]
                    mask_i = valid_mask[i * part:(i + 1) * part]
                    outs[i] = decode(replica, rows_i.to(replica.device),
                                     mask_i.to(replica.device))
            except BaseException as e:  # re-raised by the caller
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,),
                                    name=f'replica-{i}')
                   for i in range(self.n_data)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return np.concatenate(outs)

    def _segmem_on(self, replica: Replica, mel_segments: torch.Tensor,
                   valid_mask: torch.Tensor) -> np.ndarray:
        """(B, S, frames, mel_bins) chains -> tokens (B, S, max_length +
        1) through segmem_greedy_decode on `replica` in the handler's
        tier."""
        dp = None if self.cfg.segmem_variant == 'decoder_prepend' \
            else replica.decode_params(self.quantize)
        tokens = segmem_greedy_decode(
            replica.model, mel_segments, self.max_length, codec=self.codec,
            vocab=self.vocab, quantize=self.quantize, valid_mask=valid_mask,
            chain_memory=self.segmem_chain,
            memory_format=self.segmem_memory_format, dp=dp)
        return tokens.cpu().numpy()

    def _greedy_on(self, replica: Replica, mel: torch.Tensor,
                   valid_mask: torch.Tensor) -> np.ndarray:
        tokens = greedy_decode(replica.model, mel, self.max_length,
                               quantize=self.quantize, valid_mask=valid_mask,
                               dp=replica.decode_params(self.quantize))
        return tokens.cpu().numpy()

    def _call_in_sizes(self, stacked: torch.Tensor, sizes: list,
                       n_real: int) -> np.ndarray:
        """The segment-memory decode over consecutive slices of `sizes`
        rows, each sharded over the data axis (rows beyond n_real are
        padding and start finished)."""
        parts, off = [], 0
        for size in sizes:
            real = max(0, min(size, n_real - off))
            mask = torch.arange(size, device=self.device) < real
            parts.append(self._on_replicas(
                self._segmem_on, stacked[off:off + size], mask))
            off += size
        return np.concatenate(parts)

    def _decode_all(self, mel) -> np.ndarray:
        """mel (N, 256, mel_bins) -> model-space tokens (N, max_length + 1).

        Contiguous mode decodes the N segments as one memory chain, on
        the first device alone (a lone song's chain is sequential: the
        data axis has nothing to share); 'encoder_append' models chain
        batch_size segments at a time; vanilla segments decode in fixed
        batches of batch_size rows per device (capped at the window
        kernel's per-launch limit), the padding rows of the last batch
        starting finished."""
        mel = torch.as_tensor(mel, device=self.device)
        n = mel.shape[0]
        if self.contiguous_inference:
            padded = _round_up(n, max(self.segment_bucket, 1))
            mel_p = torch.nn.functional.pad(
                mel, (0, 0, 0, 0, 0, padded - n))[None]
            mask = torch.ones(1, dtype=torch.bool, device=self.device)
            return self._segmem_on(self.replicas[0], mel_p, mask)[0][:n]
        if self.cfg.segmem_variant == 'encoder_append':
            return self._decode_segmem_chained([mel])[0]
        b = self.batch_size * self.n_data
        if self.quantize.startswith('fused'):
            from mr_mt3_tpu_torch.ops.fused_decode import FUSED_MAX_BATCH
            b = min(b, FUSED_MAX_BATCH * self.n_data)
        outs = []
        for start in range(0, n, b):
            chunk = mel[start:start + b]
            real = chunk.shape[0]
            if real < b:
                chunk = torch.nn.functional.pad(chunk,
                                                (0, 0, 0, 0, 0, b - real))
            mask = torch.arange(b, device=self.device) < real
            outs.append(self._on_replicas(self._greedy_on, chunk, mask))
        return np.concatenate(outs)[:n]

    def _decode_segmem_chained(self, mels: List[torch.Tensor]
                               ) -> List[np.ndarray]:
        """Non-contiguous decode of an 'encoder_append' model: the
        reference chains the memory across the rows of every decode batch
        (reference: models/t5_segmem_v2.py:169-233,
        t5_segmem_v2_with_prev.py:226-297). Each song's segments are cut
        into chains of batch_size (the tail padded at the chain's end, so
        padding never feeds real memory), and all chains of all songs
        decode in lockstep: batch axis = chains, loop axis = chain
        position."""
        b = self.batch_size
        chains, all_chunks = [], []
        for mel in mels:
            mel = torch.as_tensor(mel, device=self.device)
            n = mel.shape[0]
            num_chunks = math.ceil(n / b)
            mel_p = torch.nn.functional.pad(
                mel, (0, 0, 0, 0, 0, num_chunks * b - n))
            chains.append((n, len(all_chunks), num_chunks))
            all_chunks.extend(mel_p.reshape((num_chunks, b) + mel.shape[1:]))
        n_real = len(all_chunks)
        sizes = self._call_sizes(n_real, floor=4,
                                 capped=self.quantize.startswith('fused'))
        stacked = torch.stack(all_chunks)
        if sum(sizes) > n_real:
            stacked = torch.nn.functional.pad(
                stacked, (0, 0, 0, 0, 0, 0, 0, sum(sizes) - n_real))
        tokens = self._call_in_sizes(stacked, sizes, n_real)
        return [tokens[start:start + num_chunks].reshape(num_chunks * b, -1)
                [:n] for n, start, num_chunks in chains]

    # ---- host-side postprocess (reference: inference.py:206-234) ----

    def _postprocess(self, tokens: np.ndarray) -> np.ndarray:
        """Model tokens -> codec tokens: EOS-and-after -> -1, strip the
        special offset, drop the start token."""
        after_eos = np.cumsum(tokens == self.cfg.eos_token_id, axis=-1)
        out = tokens - self.vocab.num_special_tokens()
        out = np.where(after_eos > 0, DECODED_EOS_ID, out)
        return out[:, 1:]

    def _to_note_sequence(self, tokens: np.ndarray, seg_times: np.ndarray):
        predictions = []
        for i, row in enumerate(tokens):
            # trim at the first EOS marker; np.argmax semantics match the
            # reference (no EOS -> argmax 0 -> empty tokens)
            row = row[:np.argmax(row == DECODED_EOS_ID)]
            start_time = seg_times[i][0]
            start_time -= start_time % (1 / self.codec.steps_per_second)
            predictions.append({
                'est_tokens': row,
                'start_time': start_time,
                'raw_inputs': [],
            })
        result = event_predictions_to_ns(
            predictions, codec=self.codec,
            encoding_spec=note_sequences.NoteEncodingWithTiesSpec)
        return result['est_ns']

    # ---- public API ----

    def transcribe(self, audio: np.ndarray) -> note_sequences.NoteSequence:
        """16 kHz mono audio -> NoteSequence."""
        segments, seg_times, valid = self._audio_to_segments(
            np.asarray(audio, dtype=np.float32))
        mel = self._compute_mel(segments, valid)
        tokens = self._decode_all(mel)
        codec_tokens = self._postprocess(tokens)
        return self._to_note_sequence(codec_tokens, seg_times)

    def transcribe_many(self, audios) -> list:
        """Transcribe several songs. Contiguous mode runs the songs in
        lockstep, one memory chain each; 'encoder_append' models decode
        every song's chains in lockstep; vanilla segments of all songs are
        concatenated into fixed decode batches. Outputs equal per-song
        transcribe()."""
        pre = [self._audio_to_segments(np.asarray(a, dtype=np.float32))
               for a in audios]
        mels = [self._compute_mel(segments, valid)
                for segments, _, valid in pre]
        if self.contiguous_inference:
            max_s = _round_up(max(m.shape[0] for m in mels),
                              max(self.segment_bucket, 1))
            n_songs = len(mels)
            sizes = self._call_sizes(n_songs, floor=1,
                                     capped=self.quantize.startswith('fused'))
            stacked = torch.stack([torch.nn.functional.pad(
                m, (0, 0, 0, 0, 0, max_s - m.shape[0])) for m in mels])
            if sum(sizes) > n_songs:
                stacked = torch.nn.functional.pad(
                    stacked, (0, 0, 0, 0, 0, 0, 0, sum(sizes) - n_songs))
            tokens = self._call_in_sizes(stacked, sizes, n_songs)
            per_song = [tokens[i, :m.shape[0]] for i, m in enumerate(mels)]
        elif self.cfg.segmem_variant == 'encoder_append':
            per_song = self._decode_segmem_chained(mels)
        else:
            all_tokens = self._decode_all(torch.cat(mels, dim=0))
            per_song, start = [], 0
            for m in mels:
                per_song.append(all_tokens[start:start + m.shape[0]])
                start += m.shape[0]
        results = []
        for tokens, (_, seg_times, _) in zip(per_song, pre):
            codec_tokens = self._postprocess(tokens)
            results.append(self._to_note_sequence(codec_tokens, seg_times))
        return results

    def inference(self, audio, audio_path: str = '', outpath=None,
                  valid_programs=None, num_beams: int = 1,
                  batch_size: Optional[int] = None,
                  max_length: Optional[int] = None,
                  verbose: bool = False
                  ) -> Optional[note_sequences.NoteSequence]:
        """Transcribe and write a MIDI file (reference signature:
        inference.py:149-204; errors are caught and printed the same way).
        num_beams is accepted for API parity; decoding is greedy."""
        if batch_size is not None:
            self.batch_size = batch_size
        if max_length is not None:
            self.max_length = max_length
        try:
            ns = self.transcribe(audio)
            if outpath is None:
                filename = os.path.basename(str(audio_path)).split('.')[0]
                outpath = f'./out/{filename}.mid'
            parent = os.path.dirname(str(outpath))
            if parent:
                os.makedirs(parent, exist_ok=True)
            if verbose:
                print('saving', outpath)
            note_sequence_to_midi_file(ns, outpath)
            return ns
        except Exception:
            traceback.print_exc()
            return None
