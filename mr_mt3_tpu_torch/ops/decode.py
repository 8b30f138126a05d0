"""Greedy autoregressive decoding (port of mr_mt3_tpu/ops/decode.py).

  * greedy_decode -- vanilla MT3: one batch of independent segments;
  * segmem_greedy_decode -- the segment-memory chain: a Python loop over the
    segment axis (the JAX package's lax.scan) carrying the previous
    segment's decoded tokens, the batch axis free for several chains or
    songs in lockstep.

Outputs match the reference token-stream format: position 0 is the decoder
start token, finished rows pad with pad_token_id, EOS is included.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, Optional

import torch

from mr_mt3_tpu_torch.models.config import MT3Config
from mr_mt3_tpu_torch.models.mt3 import MT3
from mr_mt3_tpu_torch.ops.fast_decode import (
    DecodeParams,
    DecodeRunner,
    greedy_loop_fast,
    merge_stats,
    stack_decode_params,
    use_graphs,
)

# every decode tier of the JAX package; all are ported
PORTED_TIERS = ('none', 'int8', 'int8_kv', 'fused', 'fused_bf16',
                'fused_int4')


def check_quantize(quantize: str) -> None:
    """Raise for a tier that does not exist."""
    if quantize not in PORTED_TIERS:
        raise ValueError(f'unknown quantize mode: {quantize!r}')


@torch.no_grad()
def greedy_decode(model: MT3, mel: torch.Tensor, max_length: int = 1024,
                  quantize: str = 'none',
                  valid_mask: Optional[torch.Tensor] = None,
                  dp: Optional[DecodeParams] = None,
                  graphs: Optional[bool] = None) -> torch.Tensor:
    """Vanilla MT3 transcription decode.

    mel (B, frames, mel_bins) -> tokens (B, max_length + 1) with a leading
    start token. quantize:
      'none'       — the exact KV-cache loop at the model's dtype;
      'int8'       — the same loop with each layer's feed-forward and the
                     lm_head on int8 weights with f32 column scales (the
                     CUDA int8_gated_ff and int8_matmul kernels; their
                     plain PyTorch versions for CPU tensors);
      'int8_kv'    — the same loop with the self and cross K/V in int8
                     with f32 scales per position, attention through the
                     CUDA int8_decode_attention kernel (its plain version
                     for CPU tensors);
      'fused_bf16' — the whole-decoder CUDA window kernel: bf16 weights
                     and K/V with f32 sums (its plain PyTorch version for
                     CPU tensors);
      'fused'      — the same kernel in int8 mode: int8 weights and K/V
                     with f32 scales, int32 attention dots;
      'fused_int4' — int4 weights and K/V (codes in [-7, 7]); the
                     serving default on the card.
    dp: DecodeParams already stacked for this quantize tier (callers that
    decode repeatedly keep them, and with them the step loop's captured
    graphs). graphs=False runs the step loop eagerly on the card (for
    comparison only; see greedy_loop_fast)."""
    check_quantize(quantize)
    encoder_out = model.encode_audio(mel)
    if dp is None:
        dp = stack_decode_params(model, quantize=quantize)
    return greedy_loop_fast(model.cfg, dp, encoder_out, max_length,
                            quantize=quantize, valid_mask=valid_mask,
                            graphs=graphs)


# the module path's phase bounds (mr_mt3_tpu/ops/decode.py::_greedy_loop)
MODULE_PHASES = (256, 512)
# the module path's runners of each model (keyed weakly: a runner holds
# no reference to its model), by decode shape
_MODULE_RUNNERS: 'weakref.WeakKeyDictionary' = weakref.WeakKeyDictionary()


class ModuleRunner(DecodeRunner):
    """_greedy_loop's runner: MT3.decode_step on the model's own modules,
    per-layer (B, P + max_length, H, Dk) caches (P the prefix length) of
    which a step of the phase ending at b passes the first P + b, the
    cross K/V for `lenc` encoder rows. Its graphs read the model's
    parameters where they lie: a model whose parameters moved (another
    device or dtype, new tensors) gets its graphs captured anew."""

    tier = 'module'

    def __init__(self, model: MT3, batch: int, lenc: int, prefix_len: int,
                 max_length: int, device):
        super().__init__(model.cfg, batch, max_length, device, MODULE_PHASES)
        cfg = model.cfg
        self.prefix_len = prefix_len
        self.cache = model.init_cache(batch, prefix_len + max_length)
        shape = (cfg.num_decoder_layers, batch, lenc,
                 model.decoder.block[0].cross_attn.n_heads, cfg.d_kv)
        self.cross = {name: torch.empty(shape, dtype=model.dtype,
                                        device=device) for name in 'kv'}
        self.weights = None

    def reset(self, model: MT3, encoder_out: torch.Tensor,
              prefix_embeds: Optional[torch.Tensor],
              valid_mask: Optional[torch.Tensor]) -> None:
        weights = tuple(t.data_ptr() for t in (*model.parameters(),
                                               *model.buffers()))
        if weights != self.weights:
            self.graphs.clear()
            self.weights = weights
        for name, t in model.precompute_cross_kv(encoder_out).items():
            self.cross[name].copy_(t)
        for k, v in self.cache:
            k.zero_()
            v.zero_()
        if self.prefix_len:
            model.prefill_cache(prefix_embeds, self.cache, self.cross)
        self.reset_state(valid_mask)

    def step(self, model: MT3, bound: int) -> None:
        length = self.prefix_len + bound
        logits, _ = model.decode_step(
            self.current_tokens().long(), self.step_index + self.prefix_len,
            [(k[:, :length], v[:, :length]) for k, v in self.cache],
            self.cross)
        self.advance(logits)


def module_runners(model: MT3) -> Dict[Any, ModuleRunner]:
    """The module path's runners of `model`, by decode shape."""
    if model not in _MODULE_RUNNERS:
        _MODULE_RUNNERS[model] = {}
    return _MODULE_RUNNERS[model]


def capture_module_phases(model: MT3) -> Dict[str, Any]:
    """ModuleRunner.capture_all for every runner of `model` on the card
    (prewarm); their summed stats."""
    runners = [r for r in module_runners(model).values()
               if r.device.type == 'cuda']
    steps = sum(r.capture_all(model) for r in runners)
    return merge_stats(runners, steps)


@torch.no_grad()
def _greedy_loop(model: MT3, encoder_out: torch.Tensor, max_length: int,
                 decoder_prefix_embeds: Optional[torch.Tensor] = None,
                 valid_mask: Optional[torch.Tensor] = None,
                 graphs: Optional[bool] = None) -> torch.Tensor:
    """The module-path decode loop (MT3.decode_step); encoder_out (B, Lenc,
    D) -> tokens (B, max_length + 1). With decoder_prefix_embeds (B, P, D)
    the prefix is prefilled into the cache (eagerly) and generation starts
    at position P (the v1 memory). The steps run in the JAX loop's phases
    (MODULE_PHASES, then max_length) through the model's ModuleRunner for
    this shape: a step of the phase ending at b attends over the first
    P + b cache positions, those after the current one masked to exact
    zeros, as in the JAX loop's phase-grown cache. graphs as in
    greedy_loop_fast: captured blocks on the card unless False."""
    batch, lenc = encoder_out.shape[:2]
    dev = encoder_out.device
    graphs = use_graphs(dev, graphs, model.tp)
    prefix_len = (0 if decoder_prefix_embeds is None
                  else decoder_prefix_embeds.shape[1])
    key = (batch, lenc, prefix_len, max_length, model.dtype)
    runners = module_runners(model) if dev.type == 'cuda' else {}
    runner = runners.get(key)
    if runner is None:
        runner = runners[key] = ModuleRunner(model, batch, lenc, prefix_len,
                                             max_length, dev)
    runner.reset(model, encoder_out, decoder_prefix_embeds, valid_mask)
    return runner.run(model, graphs)


def initial_segmem_tokens(cfg: MT3Config, batch: int, max_length: int,
                          codec=None, vocab=None,
                          device=None) -> torch.Tensor:
    """Memory seed of the first segment, (batch, max_length) int32:
    v2-with-prev seeds [tie, EOS, pad...] in model space (1134, 1 for the
    standard vocabulary; reference: models/t5_segmem_v2_with_prev.py:
    246-259), v1 / v2 seed [EOS, pad...]. The tie id comes from the codec
    and vocabulary (the default codec when none is given)."""
    mem = torch.zeros((batch, max_length), dtype=torch.int32, device=device)
    if cfg.segmem_variant == 'encoder_append' and \
            cfg.segmem_seed == 'tie_eos':
        from mr_mt3_tpu_torch.codec import (
            Event,
            VocabularyConfig,
            build_codec,
            vocabulary_from_codec,
        )
        if codec is None:
            codec = build_codec(VocabularyConfig(num_velocity_bins=1))
        if vocab is None:
            vocab = vocabulary_from_codec(codec)
        tie_id = (codec.encode_event(Event(type='tie', value=0))
                  + vocab.num_special_tokens())
        mem[:, 0] = tie_id
        mem[:, 1] = cfg.eos_token_id
    else:
        mem[:, 0] = cfg.eos_token_id
    return mem


@torch.no_grad()
def segmem_greedy_decode(model: MT3, mel_segments: torch.Tensor,
                         max_length: int = 1024,
                         codec=None, vocab=None,
                         quantize: str = 'none',
                         valid_mask: Optional[torch.Tensor] = None,
                         chain_memory: bool = True,
                         memory_format: str = 'reference',
                         oracle_memory: Optional[torch.Tensor] = None,
                         dp: Optional[DecodeParams] = None,
                         graphs: Optional[bool] = None) -> torch.Tensor:
    """Sequential segment-memory decode over one or more chains in
    lockstep.

    mel_segments (B, S, frames, mel_bins): S consecutive segments per
    chain. Returns tokens (B, S, max_length + 1). Segment i's memory is
    segment i-1's decoded tokens: with the leading start id
    (memory_format='reference', the reference's decode) or without it
    ('train_aligned', training's targets_prev layout). chain_memory=False
    reseeds every segment (a diagnostic ablation); oracle_memory (B, S,
    max_length) gives each segment's memory verbatim. All segments are
    encoded in one batched pass first. 'encoder_append' appends the memory
    to the encoder output and decodes through greedy_loop_fast in the
    quantize tier (any of greedy_decode's, 'int8' and 'int8_kv'
    included); 'decoder_prepend' (v1) prefills it as a decoder prefix
    and decodes on the exact module path only. Each segment reuses the
    step loop's runner (its graphs on the card; graphs=False runs it
    eagerly, for comparison only); the next segment's memory is a copy of
    its tokens buffer."""
    if memory_format not in ('reference', 'train_aligned'):
        raise ValueError(f'unknown memory_format: {memory_format!r}')
    check_quantize(quantize)
    cfg = model.cfg
    variant = cfg.segmem_variant
    if variant == 'decoder_prepend' and quantize != 'none':
        raise ValueError(
            'quantize is not supported for decoder_prepend models')
    b, s = mel_segments.shape[:2]
    dev = mel_segments.device
    if dp is None and variant != 'decoder_prepend':
        dp = stack_decode_params(model, quantize=quantize)
    enc = model.encode_audio(mel_segments.reshape(
        (b * s,) + mel_segments.shape[2:]))
    enc = enc.reshape((b, s) + enc.shape[1:])
    mem = initial_segmem_tokens(cfg, b, max_length, codec, vocab, dev)
    if oracle_memory is not None:
        oracle_memory = oracle_memory.to(dev)
    out = []
    for i in range(s):
        mem_in = mem if oracle_memory is None else oracle_memory[:, i]
        enc_i = enc[:, i]
        if variant == 'decoder_prepend':
            tokens = _greedy_loop(model, enc_i, max_length,
                                  decoder_prefix_embeds=model.compute_segmem(
                                      mem_in),
                                  valid_mask=valid_mask, graphs=graphs)
        else:
            if variant == 'encoder_append':
                enc_i = torch.cat([enc_i, model.compute_segmem(mem_in)],
                                  dim=1)
            tokens = greedy_loop_fast(cfg, dp, enc_i, max_length,
                                      quantize=quantize,
                                      valid_mask=valid_mask, graphs=graphs)
        if chain_memory:
            mem = (tokens[:, 1:max_length + 1]
                   if memory_format == 'train_aligned'
                   else tokens[:, :max_length])
        out.append(tokens)
    return torch.stack(out, dim=1)
