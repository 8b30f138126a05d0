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

from typing import Optional

import torch

from mr_mt3_tpu_torch.models.config import MT3Config
from mr_mt3_tpu_torch.models.mt3 import MT3
from mr_mt3_tpu_torch.ops.fast_decode import (
    _EXIT_CHECK_EVERY,
    DecodeParams,
    _start,
    greedy_loop_fast,
    stack_decode_params,
)

PORTED_TIERS = ('none', 'fused_bf16', 'fused', 'fused_int4')
_JAX_TIERS = ('none', 'int8', 'int8_kv', 'fused', 'fused_bf16', 'fused_int4')


def check_quantize(quantize: str) -> None:
    """Raise for a tier this port does not run (yet)."""
    if quantize not in _JAX_TIERS:
        raise ValueError(f'unknown quantize mode: {quantize!r}')
    if quantize not in PORTED_TIERS:
        raise NotImplementedError(f'quantize={quantize!r} not yet ported')


@torch.no_grad()
def greedy_decode(model: MT3, mel: torch.Tensor, max_length: int = 1024,
                  quantize: str = 'none',
                  valid_mask: Optional[torch.Tensor] = None,
                  dp: Optional[DecodeParams] = None) -> torch.Tensor:
    """Vanilla MT3 transcription decode.

    mel (B, frames, mel_bins) -> tokens (B, max_length + 1) with a leading
    start token. quantize:
      'none'       — the exact KV-cache loop at the model's dtype;
      'fused_bf16' — the whole-decoder CUDA window kernel: bf16 weights
                     and K/V with f32 sums (its plain PyTorch version for
                     CPU tensors);
      'fused'      — the same kernel in int8 mode: int8 weights and K/V
                     with f32 scales, int32 attention dots;
      'fused_int4' — int4 weights and K/V (codes in [-7, 7]); the
                     serving default on the card.
    'int8' and 'int8_kv' are not yet ported.
    dp: DecodeParams already stacked for this quantize tier (callers that
    decode repeatedly keep them)."""
    check_quantize(quantize)
    encoder_out = model.encode_audio(mel)
    if dp is None:
        dp = stack_decode_params(model, quantize=quantize)
    return greedy_loop_fast(model.cfg, dp, encoder_out, max_length,
                            quantize=quantize, valid_mask=valid_mask)


@torch.no_grad()
def _greedy_loop(model: MT3, encoder_out: torch.Tensor, max_length: int,
                 decoder_prefix_embeds: Optional[torch.Tensor] = None,
                 valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The module-path decode loop (MT3.decode_step); encoder_out (B, Lenc,
    D) -> tokens (B, max_length + 1). With decoder_prefix_embeds (B, P, D)
    the prefix is prefilled into the cache and generation starts at
    position P (the v1 memory). The cache holds all P + max_length
    positions at once; the positions after the current one are masked to
    exact zeros, as the JAX loop's phase-grown cache is."""
    cfg = model.cfg
    batch = encoder_out.shape[0]
    dev = encoder_out.device
    prefix_len = (0 if decoder_prefix_embeds is None
                  else decoder_prefix_embeds.shape[1])
    cross_kv = model.precompute_cross_kv(encoder_out)
    cache = model.init_cache(batch, prefix_len + max_length)
    if prefix_len:
        cache = model.prefill_cache(decoder_prefix_embeds, cache, cross_kv)
    tokens, finished = _start(cfg, batch, max_length, dev, valid_mask)
    for i in range(max_length):
        if i % _EXIT_CHECK_EVERY == 0 and bool(finished.all()):
            break
        logits, cache = model.decode_step(tokens[:, i].long(),
                                          i + prefix_len, cache, cross_kv)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(finished, cfg.pad_token_id, nxt)
        finished = finished | (nxt == cfg.eos_token_id)
        tokens[:, i + 1] = nxt
    return tokens


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
                         dp: Optional[DecodeParams] = None) -> torch.Tensor:
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
    quantize tier; 'decoder_prepend' (v1) prefills it as a decoder prefix
    and decodes on the exact module path only."""
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
                                  valid_mask=valid_mask)
        else:
            if variant == 'encoder_append':
                enc_i = torch.cat([enc_i, model.compute_segmem(mem_in)],
                                  dim=1)
            tokens = greedy_loop_fast(cfg, dp, enc_i, max_length,
                                      quantize=quantize,
                                      valid_mask=valid_mask)
        if chain_memory:
            mem = (tokens[:, 1:max_length + 1]
                   if memory_format == 'train_aligned'
                   else tokens[:, :max_length])
        out.append(tokens)
    return torch.stack(out, dim=1)
