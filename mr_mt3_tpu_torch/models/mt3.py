"""MT3 and the MR-MT3 segment-memory family in PyTorch (port of
mr_mt3_tpu/models/mt3.py).

Modules carry the reference HF-T5 state-dict names (reference:
models/t5.py; the names mr_mt3_tpu/utils/checkpoint_import.py maps), so
reference .pth files load with load_state_dict. Architectural contract,
as in the JAX package:

  * continuous encoder input: Linear(mel_bins -> d_model, no bias) 'proj';
  * additive fixed sinusoidal positions on the stack inputs (sin block then
    cos block), no relative attention bias;
  * T5 blocks: RMS norm computed in fp32 and cast back, UNSCALED
    dot-product attention, gated-GELU MLP with tanh-approximate GELU,
    pre-LN residuals; inner attention dim num_heads * d_kv (384 != 512);
  * untied lm_head Linear(d_model -> vocab, no bias);
  * segment memory: the previous segment's tokens, embedded with the
    decoder embedding, through a 1-layer encoder stack 'segmem_encoder',
    cut to segmem_length, then appended to the encoder output
    ('encoder_append', v2 / v2-with-prev) or prepended to the decoder
    inputs ('decoder_prepend', v1).

Full-sequence attention takes the JAX package's two routes: a plain matmul
+ fp32 softmax (einsum), or ops/train_attention.py::fused_attention (the
CUDA kernels on the card, differentiable) under the same eligibility rules.

Training (the JAX package's deterministic=False): dropout at the JAX sites
(the FF hidden, each residual branch, the stack input and output; none in
the memory encoder), its masks drawn from an explicit torch.Generator
passed to forward, and only in train() mode with a generator given, so
every other call is deterministic as JAX's default apply is; labels
shifted right into decoder inputs (shift_right); and remat, each block
under torch.utils.checkpoint with its dropout masks replayed.

On a model axis (parallel/tensor.py::shard_model) a module holds its
rank's shard: an attention its n_heads heads, a feed-forward its columns
of d_ff (shard), and model.tp names the rank's place. Dropout then draws
the masks one rank draws: the feed-forward hidden's mask whole, the rank
keeping its columns; the residual, stack-input and stack-output masks
alike on every model rank (their generators start alike), so a sharded
step equals the one-rank step at the same seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mr_mt3_tpu_torch.models.config import MT3Config

_ATTENTION_KERNELS = ('auto', 'einsum', 'fused')

# The fused kernel takes full-sequence attention from this query length on
# (the JAX package's _FUSED_MIN_LEN): the memory encoder and the
# teacher-forced decoder at 1024; everything shorter keeps einsum.
_FUSED_MIN_LEN = 512


def resolve_attention_kernel(cfg: MT3Config, device: torch.device) -> str:
    """'auto' -> 'fused' only for a bfloat16 model on the card (the
    counterpart of the JAX package's "bf16 on TPU"); fp32 models keep
    einsum, so parity goldens see its numerics, and the CPU never takes
    the kernel unless asked ('fused' on an fp32 model runs the plain
    version on the CPU and raises on the card: the kernel is bf16 only).
    Unknown values raise."""
    if cfg.attention_kernel not in _ATTENTION_KERNELS:
        raise ValueError(
            f'unknown attention_kernel {cfg.attention_kernel!r}; '
            f'expected one of {_ATTENTION_KERNELS}')
    if cfg.attention_kernel != 'auto':
        return cfg.attention_kernel
    if cfg.dtype == 'bfloat16' and device.type == 'cuda':
        return 'fused'
    return 'einsum'


def sinusoidal_position_table(dim: int, max_length: int = 5000) -> np.ndarray:
    """[sin(t w_i) ... | cos(t w_i) ...] table, shape (max_length, dim)."""
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64)
                                  / dim))
    t = np.arange(max_length, dtype=np.float64)
    angles = np.outer(t, inv_freq)
    return np.concatenate([np.sin(angles), np.cos(angles)],
                          axis=-1).astype(np.float32)


def shift_right(labels: torch.Tensor, start_token_id: int = 0,
                pad_token_id: int = 0) -> torch.Tensor:
    """Teacher-forcing shift: [start, labels[:-1]], with -100 -> pad."""
    start = labels.new_full(labels.shape[:-1] + (1,), start_token_id)
    shifted = torch.cat([start, labels[..., :-1]], dim=-1)
    return torch.where(shifted == -100, pad_token_id, shifted)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """flax nn.Dropout: keep each value with probability 1 - rate (a
    uniform draw below it), scaled by 1 / (1 - rate); the identity without
    a generator or at rate 0. shard (index, m): x is part `index` of m of
    the last dim of the whole, whose mask is drawn, x keeping its part."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = x.shape
    if shard is not None:
        shape = x.shape[:-1] + (x.shape[-1] * shard[1],)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if shard is not None:
        mask = mask.chunk(shard[1], dim=-1)[shard[0]]
    return torch.where(mask, x / keep, x.new_zeros(()))


def causal_mask(lq: int, lk: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """Additive (lq, lk) mask: 0 where key <= query, -1e9 above."""
    tri = torch.ones(lq, lk, dtype=torch.bool, device=device).tril()
    return torch.zeros(lq, lk, dtype=dtype, device=device).masked_fill(
        ~tri, -1e9)


_GELU_C = math.sqrt(2.0 / math.pi)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GELU (HF 'gelu_new', used by T5 gated-gelu)."""
    return 0.5 * x * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * x ** 3)))


class RMSNorm(nn.Module):
    """T5LayerNorm: scale-only RMS normalization computed in fp32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        out = x32 * torch.rsqrt(var + self.eps)
        return (self.weight * out.to(dtype)).to(dtype)


class _Linear(nn.Linear):
    """Bias-free Linear computing in the input's dtype (fp32 params, as
    flax Dense(dtype=...) keeps them)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.weight.to(x.dtype))


def _linear(n_in: int, n_out: int) -> nn.Linear:
    return _Linear(n_in, n_out, bias=False)


class Attention(nn.Module):
    """T5 multi-head attention: no scaling, no bias.

    attend takes one of two routes (cfg.attention_kernel): einsum, the
    (B, H, Lq, Lk) scores with an fp32 softmax; or fused, the CUDA kernel
    of ops/train_attention.py (fp32 scores and softmax, bf16 values) for an
    unmasked call with Lq >= 512, Lq % 8 == 0, and causal only if square.
    """

    def __init__(self, cfg: MT3Config):
        super().__init__()
        self.cfg = cfg
        inner = cfg.inner_dim
        self.q = _linear(cfg.d_model, inner)
        self.k = _linear(cfg.d_model, inner)
        self.v = _linear(cfg.d_model, inner)
        self.o = _linear(inner, cfg.d_model)
        # the heads this module holds (fewer on a model axis)
        self.n_heads = cfg.num_heads

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        return x.reshape(b, l, self.n_heads, self.cfg.d_kv)

    def project_kv(self, src: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K/V heads of a source sequence: (B, L, H, Dk) each."""
        return self.heads(self.k(src)), self.heads(self.v(src))

    def _fused_eligible(self, lq: int, lk: int, mask, causal: bool,
                        device: torch.device) -> bool:
        if resolve_attention_kernel(self.cfg, device) != 'fused':
            return False
        if mask is not None:       # decode-step / prefill masks stay einsum
            return False
        if lq < _FUSED_MIN_LEN or lq % 8:
            return False
        return not (causal and lq != lk)

    def attend(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor],
               causal: bool = False) -> torch.Tensor:
        """x (B, Lq, D); k/v (B, Lk, H, Dk); mask additive (.., Lq, Lk),
        or causal=True (not both)."""
        q = self.heads(self.q(x))
        lq, lk = q.shape[1], k.shape[1]
        if self._fused_eligible(lq, lk, mask, causal, x.device):
            from mr_mt3_tpu_torch.ops.train_attention import fused_attention
            out = fused_attention(q, k, v, causal)
        else:
            if causal:
                if mask is not None:
                    raise ValueError('pass mask or causal=True, not both')
                mask = causal_mask(lq, lk, x.dtype, x.device)
            scores = torch.einsum('bqhd,bkhd->bhqk', q, k)
            if mask is not None:
                scores = scores + mask
            probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
            out = torch.einsum('bhqk,bkhd->bqhd', probs, v)
        b, lq = out.shape[:2]
        return self.o(out.reshape(b, lq, self.n_heads * self.cfg.d_kv))

    def forward(self, x: torch.Tensor, kv_src: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                causal: bool = False) -> torch.Tensor:
        k, v = self.project_kv(x if kv_src is None else kv_src)
        return self.attend(x, k, v, mask, causal=causal)


class DenseReluDense(nn.Module):
    """T5 gated-GELU MLP: wo(gelu_new(wi_0(x)) * wi_1(x))."""

    def __init__(self, cfg: MT3Config):
        super().__init__()
        self.wi_0 = _linear(cfg.d_model, cfg.d_ff)
        self.wi_1 = _linear(cfg.d_model, cfg.d_ff)
        self.wo = _linear(cfg.d_ff, cfg.d_model)
        # (index, m) where this module holds part index of m of d_ff
        self.shard = None

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = gelu_new(self.wi_0(x)) * self.wi_1(x)
        return self.wo(dropout(h, rate, generator, self.shard))


class SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: MT3Config):
        super().__init__()
        self.SelfAttention = Attention(cfg)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class CrossAttentionLayer(nn.Module):
    def __init__(self, cfg: MT3Config):
        super().__init__()
        self.EncDecAttention = Attention(cfg)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class FeedForwardLayer(nn.Module):
    def __init__(self, cfg: MT3Config):
        super().__init__()
        self.DenseReluDense = DenseReluDense(cfg)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class Block(nn.Module):
    """Pre-LN T5 block: layer.0 self-attn, [layer.1 cross-attn,] last MLP."""

    def __init__(self, cfg: MT3Config, is_decoder: bool,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.is_decoder = is_decoder
        self.dropout_rate = dropout_rate
        layers = [SelfAttentionLayer(cfg)]
        if is_decoder:
            layers.append(CrossAttentionLayer(cfg))
        layers.append(FeedForwardLayer(cfg))
        self.layer = nn.ModuleList(layers)

    @property
    def self_attn(self) -> Attention:
        return self.layer[0].SelfAttention

    @property
    def cross_attn(self) -> Attention:
        return self.layer[1].EncDecAttention

    @property
    def ff(self) -> DenseReluDense:
        return self.layer[-1].DenseReluDense

    def norm(self, i: int) -> RMSNorm:
        return self.layer[i].layer_norm

    def forward(self, x: torch.Tensor,
                encoder_out: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.dropout_rate
        x = x + dropout(self.self_attn(self.norm(0)(x),
                                       causal=self.is_decoder),
                        rate, generator)
        if self.is_decoder:
            x = x + dropout(self.cross_attn(self.norm(1)(x),
                                            kv_src=encoder_out),
                            rate, generator)
        return x + dropout(self.ff(self.norm(-1)(x), rate, generator),
                           rate, generator)


class Stack(nn.Module):
    """T5 stack with additive sinusoidal positions and final RMS norm;
    dropout on its input and output (after the final norm)."""

    def __init__(self, cfg: MT3Config, num_layers: int, is_decoder: bool,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.is_decoder = is_decoder
        self.dropout_rate = dropout_rate
        self.remat = cfg.remat
        self.block = nn.ModuleList(Block(cfg, is_decoder, dropout_rate)
                                   for _ in range(num_layers))
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.register_buffer(
            'pos_table', torch.from_numpy(sinusoidal_position_table(
                cfg.d_model, cfg.max_positions)), persistent=False)

    def forward(self, embeds: torch.Tensor,
                encoder_out: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        seq = embeds.shape[-2]
        x = embeds + self.pos_table[:seq].to(embeds.dtype)
        x = dropout(x, self.dropout_rate, generator)
        for block in self.block:
            if self.remat and torch.is_grad_enabled():
                x = _remat_block(block, x, encoder_out, generator)
            else:
                x = block(x, encoder_out, generator)
        x = self.final_layer_norm(x)
        return dropout(x, self.dropout_rate, generator)


def _remat_block(block: Block, x: torch.Tensor,
                 encoder_out: Optional[torch.Tensor],
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """block(x) under torch.utils.checkpoint: its activations are
    recomputed in the backward. The recomputation replays the block's
    dropout masks from a copy of the generator's state at the block's
    start, and the caller's generator moves on as if the block had run
    once, so the masks, and the gradients, equal the non-remat ones."""
    start = None if generator is None else generator.get_state()
    end = {}

    def run(x, encoder_out):
        gen = None
        if start is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(start)
        out = block(x, encoder_out, gen)
        if gen is not None:
            end['state'] = gen.get_state()
        return out
    out = checkpoint(run, x, encoder_out, use_reentrant=False)
    if generator is not None:
        generator.set_state(end['state'])
    return out


class MT3(nn.Module):
    """The MT3 encoder-decoder, with the optional segment memory.

    Entry points: forward (teacher-forced logits), encode_audio, encode,
    compute_segmem, decode_hidden, precompute_cross_kv, init_cache,
    prefill_cache and decode_step."""

    def __init__(self, cfg: MT3Config):
        super().__init__()
        if cfg.segmem_variant not in (None, 'encoder_append',
                                      'decoder_prepend'):
            raise ValueError(
                f'unknown segmem_variant {cfg.segmem_variant!r}')
        self.cfg = cfg
        self.proj = _linear(cfg.mel_bins, cfg.d_model)
        self.decoder_embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = Stack(cfg, cfg.num_encoder_layers, is_decoder=False,
                             dropout_rate=cfg.dropout_rate)
        self.decoder = Stack(cfg, cfg.num_decoder_layers, is_decoder=True,
                             dropout_rate=cfg.dropout_rate)
        self.lm_head = _linear(cfg.d_model, cfg.vocab_size)
        if cfg.has_segmem:
            # dropout forced to 0 in the memory encoder
            # (reference: models/t5_segmem.py:63-64)
            self.segmem_encoder = Stack(cfg, cfg.segmem_num_layers,
                                        is_decoder=False)
        # this rank's parallel.tensor.ModelAxis once sharded
        self.tp = None

    @property
    def dtype(self) -> torch.dtype:
        return self.cfg.activation_dtype

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype)

    # ---- encoder side ----

    def encode_audio(self, mel: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """mel (B, frames, mel_bins) -> (B, frames, d_model)."""
        x = self.proj(self._cast(mel))
        return self.encoder(x, generator=generator)

    def compute_segmem(self, prev_ids: torch.Tensor) -> torch.Tensor:
        """Previous-segment token ids (B, L) -> memory (B, segmem_length,
        D): -100 labels become pad, the ids are embedded with the decoder
        embedding in the activation dtype and run through the memory
        encoder (one full-sequence attention per layer at length L)."""
        ids = torch.where(prev_ids == -100, self.cfg.pad_token_id,
                          prev_ids).long()
        emb = self._cast(self.decoder_embed_tokens(ids))
        return self.segmem_encoder(emb)[:, :self.cfg.segmem_length]

    def encode(self, mel: torch.Tensor,
               targets_prev: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Encoder pass (dropout from `generator`); appends the memory for
        'encoder_append'."""
        enc = self.encode_audio(mel, generator)
        if self.cfg.segmem_variant == 'encoder_append':
            if targets_prev is None:
                raise ValueError(
                    'encoder_append segmem requires targets_prev')
            enc = torch.cat([enc, self.compute_segmem(targets_prev)], dim=1)
        return enc

    # ---- teacher-forced decode ----

    def decode_hidden(self, encoder_out: torch.Tensor,
                      decoder_input_ids: torch.Tensor,
                      decoder_embeds_prefix: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Decoder stack over the ids; a prefix (B, P, D) of embeddings
        goes in front and is stripped after the stack (v1 memory)."""
        embeds = self._cast(self.decoder_embed_tokens(decoder_input_ids))
        strip = 0
        if decoder_embeds_prefix is not None:
            strip = decoder_embeds_prefix.shape[1]
            embeds = torch.cat([decoder_embeds_prefix, embeds], dim=1)
        hidden = self.decoder(embeds, encoder_out=encoder_out,
                              generator=generator)
        return hidden[:, strip:] if strip else hidden

    def forward(self, mel: torch.Tensor,
                decoder_input_ids: Optional[torch.Tensor] = None,
                targets_prev: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Teacher-forced logits (B, L, vocab). decoder_input_ids default to
        labels shifted right. A segmem model without targets_prev remembers
        within the batch: row b's memory is row b-1's ids
        (batch_internal_segmem_ids). Dropout runs only in train() mode with
        a generator (the JAX deterministic=False); the memory encoder has
        none."""
        cfg = self.cfg
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError('need decoder_input_ids or labels')
            decoder_input_ids = shift_right(
                labels, cfg.decoder_start_token_id, cfg.pad_token_id)
        gen = generator if self.training else None
        variant = cfg.segmem_variant
        if variant is not None and targets_prev is None:
            targets_prev = batch_internal_segmem_ids(decoder_input_ids)
        enc = self.encode(mel, targets_prev, gen)
        prefix = None
        if variant == 'decoder_prepend':
            prefix = self.compute_segmem(targets_prev)
        return self.lm_head(self.decode_hidden(
            enc, decoder_input_ids, decoder_embeds_prefix=prefix,
            generator=gen))

    # ---- incremental decoding with KV cache ----

    def precompute_cross_kv(self, encoder_out: torch.Tensor
                            ) -> Dict[str, torch.Tensor]:
        """Per-layer cross-attention K/V: {'k', 'v'} of (L, B, Lenc, H, Dk)."""
        ks, vs = zip(*(blk.cross_attn.project_kv(encoder_out)
                       for blk in self.decoder.block))
        return {'k': torch.stack(ks), 'v': torch.stack(vs)}

    def init_cache(self, batch_size: int, max_len: int
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        cfg = self.cfg
        shape = (batch_size, max_len, self.decoder.block[0].self_attn.n_heads,
                 cfg.d_kv)
        dev = self.proj.weight.device
        return [(torch.zeros(shape, dtype=self.dtype, device=dev),
                 torch.zeros(shape, dtype=self.dtype, device=dev))
                for _ in range(cfg.num_decoder_layers)]

    def decode_step(self, tokens: torch.Tensor, position,
                    self_kv: List[Tuple[torch.Tensor, torch.Tensor]],
                    cross_kv: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, list]:
        """One greedy step: tokens (B,) -> (logits (B, vocab), self_kv).

        self_kv holds per-layer (B, max_len, H, Dk) caches (views of a
        longer cache do: the loop passes the phase's first positions);
        row `position` is written in place (index_copy_), and positions
        after it are masked. position: a 0-d int tensor on the device (an
        int is moved there), as the JAX loop's traced position."""
        x = self._cast(self.decoder_embed_tokens(tokens[:, None]))
        if not isinstance(position, torch.Tensor):
            position = torch.tensor(int(position), device=x.device)
        where = position.reshape(1)
        x = x + self.decoder.pos_table.index_select(0, where).to(x.dtype)
        max_len = self_kv[0][0].shape[1]
        step_mask = torch.where(
            torch.arange(max_len, device=x.device) <= position, 0.0,
            -1e9).to(x.dtype)
        index = where.long()
        for i, blk in enumerate(self.decoder.block):
            k_cache, v_cache = self_kv[i]
            h = blk.norm(0)(x)
            k_step, v_step = blk.self_attn.project_kv(h)
            k_cache.index_copy_(1, index, k_step)
            v_cache.index_copy_(1, index, v_step)
            x = x + blk.self_attn.attend(h, k_cache, v_cache, step_mask)
            h = blk.norm(1)(x)
            x = x + blk.cross_attn.attend(h, cross_kv['k'][i],
                                          cross_kv['v'][i], None)
            x = x + blk.ff(blk.norm(2)(x))
        x = self.decoder.final_layer_norm(x)
        return self.lm_head(x)[:, 0], self_kv

    def prefill_cache(self, prefix_embeds: torch.Tensor,
                      self_kv: List[Tuple[torch.Tensor, torch.Tensor]],
                      cross_kv: Dict[str, torch.Tensor]) -> list:
        """Run a decoder-input prefix (B, P, D) through the stack, filling
        cache positions [0, P) in place (the v1 memory: generation then
        starts at position P)."""
        p = prefix_embeds.shape[1]
        x = prefix_embeds + self.decoder.pos_table[:p].to(
            prefix_embeds.dtype)
        mask = causal_mask(p, p, x.dtype, x.device)
        for i, blk in enumerate(self.decoder.block):
            k_cache, v_cache = self_kv[i]
            h = blk.norm(0)(x)
            k, v = blk.self_attn.project_kv(h)
            k_cache[:, :p] = k
            v_cache[:, :p] = v
            x = x + blk.self_attn.attend(h, k, v, mask)
            h = blk.norm(1)(x)
            x = x + blk.cross_attn.attend(h, cross_kv['k'][i],
                                          cross_kv['v'][i], None)
            x = x + blk.ff(blk.norm(2)(x))
        return self_kv


def batch_internal_segmem_ids(decoder_input_ids: torch.Tensor
                              ) -> torch.Tensor:
    """Row b's memory is row b-1's left-shifted ids; row 0 gets [1, 0,
    ...] (reference: models/t5_segmem.py:125-132)."""
    b, l = decoder_input_ids.shape
    shifted = torch.cat([decoder_input_ids[:, 1:],
                         decoder_input_ids.new_zeros((b, 1))], dim=1)
    dummy = decoder_input_ids.new_zeros((1, l))
    dummy[0, 0] = 1
    return torch.cat([dummy, shifted[:-1]], dim=0)
