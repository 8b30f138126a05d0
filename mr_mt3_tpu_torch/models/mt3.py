"""Vanilla MT3 in PyTorch (port of mr_mt3_tpu/models/mt3.py).

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
  * untied lm_head Linear(d_model -> vocab, no bias).

Attention is a plain matmul + fp32 softmax, as the JAX package computes it
with einsum at these lengths. Dropout is omitted: the port serves only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mr_mt3_tpu_torch.models.config import MT3Config


def sinusoidal_position_table(dim: int, max_length: int = 5000) -> np.ndarray:
    """[sin(t w_i) ... | cos(t w_i) ...] table, shape (max_length, dim)."""
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64)
                                  / dim))
    t = np.arange(max_length, dtype=np.float64)
    angles = np.outer(t, inv_freq)
    return np.concatenate([np.sin(angles), np.cos(angles)],
                          axis=-1).astype(np.float32)


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
    """T5 multi-head attention: no scaling, no bias."""

    def __init__(self, cfg: MT3Config):
        super().__init__()
        self.cfg = cfg
        inner = cfg.inner_dim
        self.q = _linear(cfg.d_model, inner)
        self.k = _linear(cfg.d_model, inner)
        self.v = _linear(cfg.d_model, inner)
        self.o = _linear(inner, cfg.d_model)

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        return x.reshape(b, l, self.cfg.num_heads, self.cfg.d_kv)

    def project_kv(self, src: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K/V heads of a source sequence: (B, L, H, Dk) each."""
        return self.heads(self.k(src)), self.heads(self.v(src))

    def attend(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, Lq, D); k/v (B, Lk, H, Dk); mask additive (.., Lq, Lk)."""
        q = self.heads(self.q(x))
        scores = torch.einsum('bqhd,bkhd->bhqk', q, k)
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.einsum('bhqk,bkhd->bqhd', probs, v)
        b, lq = out.shape[:2]
        return self.o(out.reshape(b, lq, self.cfg.inner_dim))

    def forward(self, x: torch.Tensor, kv_src: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        k, v = self.project_kv(x if kv_src is None else kv_src)
        return self.attend(x, k, v, mask)


class DenseReluDense(nn.Module):
    """T5 gated-GELU MLP: wo(gelu_new(wi_0(x)) * wi_1(x))."""

    def __init__(self, cfg: MT3Config):
        super().__init__()
        self.wi_0 = _linear(cfg.d_model, cfg.d_ff)
        self.wi_1 = _linear(cfg.d_model, cfg.d_ff)
        self.wo = _linear(cfg.d_ff, cfg.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(gelu_new(self.wi_0(x)) * self.wi_1(x))


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

    def __init__(self, cfg: MT3Config, is_decoder: bool):
        super().__init__()
        self.is_decoder = is_decoder
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
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.norm(0)(x), mask=mask)
        if self.is_decoder:
            x = x + self.cross_attn(self.norm(1)(x), kv_src=encoder_out)
        return x + self.ff(self.norm(-1)(x))


class Stack(nn.Module):
    """T5 stack with additive sinusoidal positions and final RMS norm."""

    def __init__(self, cfg: MT3Config, num_layers: int, is_decoder: bool):
        super().__init__()
        self.is_decoder = is_decoder
        self.block = nn.ModuleList(Block(cfg, is_decoder)
                                   for _ in range(num_layers))
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.register_buffer(
            'pos_table', torch.from_numpy(sinusoidal_position_table(
                cfg.d_model, cfg.max_positions)), persistent=False)

    def forward(self, embeds: torch.Tensor,
                encoder_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        seq = embeds.shape[-2]
        x = embeds + self.pos_table[:seq].to(embeds.dtype)
        mask = None
        if self.is_decoder:
            tri = torch.tril(torch.ones(seq, seq, dtype=torch.bool,
                                        device=x.device))
            mask = torch.zeros(seq, seq, dtype=x.dtype, device=x.device)
            mask = mask.masked_fill(~tri, -1e9)
        for block in self.block:
            x = block(x, encoder_out, mask)
        return self.final_layer_norm(x)


class MT3(nn.Module):
    """The vanilla MT3 encoder-decoder.

    Entry points: forward (teacher-forced logits), encode_audio,
    decode_hidden, precompute_cross_kv, init_cache and decode_step."""

    def __init__(self, cfg: MT3Config):
        super().__init__()
        if cfg.has_segmem:
            raise NotImplementedError(
                f'segmem_variant={cfg.segmem_variant!r} not yet ported')
        self.cfg = cfg
        self.proj = _linear(cfg.mel_bins, cfg.d_model)
        self.decoder_embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = Stack(cfg, cfg.num_encoder_layers, is_decoder=False)
        self.decoder = Stack(cfg, cfg.num_decoder_layers, is_decoder=True)
        self.lm_head = _linear(cfg.d_model, cfg.vocab_size)

    @property
    def dtype(self) -> torch.dtype:
        return self.cfg.activation_dtype

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype)

    # ---- encoder side ----

    def encode_audio(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, frames, mel_bins) -> (B, frames, d_model)."""
        x = self.proj(self._cast(mel))
        return self.encoder(x)

    # ---- teacher-forced decode ----

    def decode_hidden(self, encoder_out: torch.Tensor,
                      decoder_input_ids: torch.Tensor) -> torch.Tensor:
        embeds = self.decoder_embed_tokens(decoder_input_ids)
        return self.decoder(self._cast(embeds), encoder_out=encoder_out)

    def forward(self, mel: torch.Tensor,
                decoder_input_ids: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits (B, L, vocab)."""
        enc = self.encode_audio(mel)
        return self.lm_head(self.decode_hidden(enc, decoder_input_ids))

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
        shape = (batch_size, max_len, cfg.num_heads, cfg.d_kv)
        dev = self.proj.weight.device
        return [(torch.zeros(shape, dtype=self.dtype, device=dev),
                 torch.zeros(shape, dtype=self.dtype, device=dev))
                for _ in range(cfg.num_decoder_layers)]

    def decode_step(self, tokens: torch.Tensor, position: int,
                    self_kv: List[Tuple[torch.Tensor, torch.Tensor]],
                    cross_kv: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, list]:
        """One greedy step: tokens (B,) -> (logits (B, vocab), self_kv).

        self_kv holds per-layer (B, max_len, H, Dk) caches; row `position`
        is written in place, and positions after it are masked."""
        x = self._cast(self.decoder_embed_tokens(tokens[:, None]))
        x = x + self.decoder.pos_table[position:position + 1].to(x.dtype)
        max_len = self_kv[0][0].shape[1]
        step_mask = torch.zeros(max_len, dtype=x.dtype, device=x.device)
        step_mask[position + 1:] = -1e9
        for i, blk in enumerate(self.decoder.block):
            k_cache, v_cache = self_kv[i]
            h = blk.norm(0)(x)
            k_step, v_step = blk.self_attn.project_kv(h)
            k_cache[:, position] = k_step[:, 0]
            v_cache[:, position] = v_step[:, 0]
            x = x + blk.self_attn.attend(h, k_cache, v_cache, step_mask)
            h = blk.norm(1)(x)
            x = x + blk.cross_attn.attend(h, cross_kv['k'][i],
                                          cross_kv['v'][i], None)
            x = x + blk.ff(blk.norm(2)(x))
        x = self.decoder.final_layer_norm(x)
        return self.lm_head(x)[:, 0], self_kv
