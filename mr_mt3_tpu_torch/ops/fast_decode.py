"""Greedy decode on stacked decoder parameters (port of
mr_mt3_tpu/ops/fast_decode.py).

Two loops:
  * greedy_loop_fast (quantize='none') — the exact path: a step-by-step
    KV-cache decode in plain torch ops at the model's activation dtype. It
    launches no kernel of its own and is the yardstick the fused path is
    held against.
  * greedy_loop_fused (quantize='fused_bf16', 'fused' or 'fused_int4') —
    drives the whole-decoder window kernel
    (ops/fused_decode.py::fused_decode_window), FUSED_WINDOW greedy steps
    per launch, in the tier's mode (bf16, int8 or int4 weights and K/V).

Both return tokens (B, max_length + 1) with a leading start token;
finished rows emit pad and EOS finishes a row; rows that valid_mask marks
False (batch padding) start finished.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from mr_mt3_tpu_torch.models.config import MT3Config
from mr_mt3_tpu_torch.models.mt3 import MT3, gelu_new
from mr_mt3_tpu_torch.ops.fused_decode import FUSED_TIERS

# the exact loop reads the finished flags back to the host (a device sync)
# once every this many steps to stop early
_EXIT_CHECK_EVERY = 8


class DecodeParams(NamedTuple):
    """Decoder weights stacked on a leading layer axis, (in, out) layout."""
    layers: Dict[str, torch.Tensor]  # name -> (L, ...) tensor
    token_embed: torch.Tensor        # (vocab, D)
    final_norm: torch.Tensor         # (D,) f32
    lm_head: torch.Tensor            # (D, vocab)
    pos_table: torch.Tensor          # (max_positions, D)
    fused: Any = None                # FusedParams (the fused tiers)


@torch.no_grad()
def stack_decode_params(model: MT3, quantize: str = 'none') -> DecodeParams:
    """Stack the decoder blocks' weights along a leading layer axis.

    Every tensor lands on the model's device in its activation dtype. With
    a fused tier ('fused_bf16', 'fused', 'fused_int4') only the
    cross-attention K/V kernels are stacked (the window kernel holds the
    rest in FusedParams, packed for the tier)."""
    cfg = model.cfg
    dtype = cfg.activation_dtype
    blocks = list(model.decoder.block)

    def stack(get):
        return torch.stack([get(b).weight.t() for b in blocks]).to(
            dtype).contiguous()

    layers = {'cross_k': stack(lambda b: b.cross_attn.k),
              'cross_v': stack(lambda b: b.cross_attn.v)}
    fused = None
    if quantize in FUSED_TIERS:
        from mr_mt3_tpu_torch.ops.fused_decode import pack_fused_params
        fused = pack_fused_params(model, quantize)
        lm_head = model.lm_head.weight.new_zeros((0,), dtype=dtype)
    elif quantize == 'none':
        for name, get in (('q', lambda b: b.self_attn.q),
                          ('k', lambda b: b.self_attn.k),
                          ('v', lambda b: b.self_attn.v),
                          ('o', lambda b: b.self_attn.o),
                          ('cross_q', lambda b: b.cross_attn.q),
                          ('cross_o', lambda b: b.cross_attn.o),
                          ('wi_0', lambda b: b.ff.wi_0),
                          ('wi_1', lambda b: b.ff.wi_1),
                          ('wo', lambda b: b.ff.wo)):
            layers[name] = stack(get)
        for i, name in enumerate(('self_norm', 'cross_norm', 'ff_norm')):
            layers[name] = torch.stack(
                [b.norm(i).weight for b in blocks]).float()
        lm_head = model.lm_head.weight.t().to(dtype).contiguous()
    else:
        raise NotImplementedError(f'quantize={quantize!r} not yet ported')
    return DecodeParams(
        layers=layers,
        token_embed=model.decoder_embed_tokens.weight.detach().to(dtype),
        final_norm=model.decoder.final_layer_norm.weight.detach().float(),
        lm_head=lm_head,
        pos_table=model.decoder.pos_table.to(dtype),
        fused=fused)


def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (weight * out.to(dtype)).to(dtype)


def precompute_cross_kv_stacked(dp: DecodeParams, cfg: MT3Config,
                                encoder_out: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V for all layers, 'bhdk' layout (L, B, H, Dk, Lenc)."""
    b, lenc, _ = encoder_out.shape
    enc = encoder_out.to(dp.token_embed.dtype)
    shape = (cfg.num_decoder_layers, b, cfg.num_heads, cfg.d_kv, lenc)
    k = torch.einsum('bsd,ldi->lbis', enc, dp.layers['cross_k'])
    v = torch.einsum('bsd,ldi->lbis', enc, dp.layers['cross_v'])
    return k.reshape(shape), v.reshape(shape)


def init_cache_stacked(cfg: MT3Config, batch: int, max_len: int,
                       device, dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, B, H, Dk, max_len) self K/V caches."""
    dtype = dtype or cfg.activation_dtype
    shape = (cfg.num_decoder_layers, batch, cfg.num_heads, cfg.d_kv, max_len)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def decode_step_fast(cfg: MT3Config, dp: DecodeParams, tokens: torch.Tensor,
                     position: int, cache, cross_kv) -> torch.Tensor:
    """One exact greedy step; tokens (B,) -> logits (B, vocab).

    Writes row `position` of the (L, B, H, Dk, P) caches in place and
    attends over rows 0..position (the JAX body masks rows > position with
    -1e9, which contributes exact zeros)."""
    eps = cfg.layer_norm_epsilon
    heads, d_kv = cfg.num_heads, cfg.d_kv
    k_cache, v_cache = cache
    cross_k, cross_v = cross_kv
    batch = tokens.shape[0]
    lay = dp.layers
    x = dp.token_embed[tokens][:, None, :]                    # (B, 1, D)
    x = x + dp.pos_table[position:position + 1]

    def attend(q, k, v):
        """q (B, 1, inner); k/v (B, H, Dk, K) -> (B, 1, inner)."""
        q = q.reshape(batch, 1, heads, d_kv)
        scores = torch.einsum('bqhd,bhdk->bhqk', q, k)
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        out = torch.einsum('bhqk,bhdk->bqhd', probs, v)
        return out.reshape(batch, 1, heads * d_kv)

    for i in range(cfg.num_decoder_layers):
        h = _rms(x, lay['self_norm'][i], eps)
        k_cache[i, :, :, :, position] = (h[:, 0] @ lay['k'][i]).reshape(
            batch, heads, d_kv)
        v_cache[i, :, :, :, position] = (h[:, 0] @ lay['v'][i]).reshape(
            batch, heads, d_kv)
        attn = attend(h @ lay['q'][i], k_cache[i, ..., :position + 1],
                      v_cache[i, ..., :position + 1])
        x = x + attn @ lay['o'][i]
        h = _rms(x, lay['cross_norm'][i], eps)
        x = x + attend(h @ lay['cross_q'][i], cross_k[i], cross_v[i]) \
            @ lay['cross_o'][i]
        h = _rms(x, lay['ff_norm'][i], eps)
        h = gelu_new(h @ lay['wi_0'][i]) * (h @ lay['wi_1'][i])
        x = x + h @ lay['wo'][i]
    x = _rms(x, dp.final_norm, eps)
    return (x @ dp.lm_head)[:, 0]


def _start(cfg: MT3Config, batch: int, length: int, device,
           valid_mask: Optional[torch.Tensor]):
    tokens = torch.full((batch, length + 1), cfg.pad_token_id,
                        dtype=torch.int32, device=device)
    tokens[:, 0] = cfg.decoder_start_token_id
    finished = (torch.zeros(batch, dtype=torch.bool, device=device)
                if valid_mask is None
                else ~valid_mask.to(device=device, dtype=torch.bool))
    return tokens, finished


@torch.no_grad()
def greedy_loop_fast(cfg: MT3Config, dp: DecodeParams,
                     encoder_out: torch.Tensor, max_length: int,
                     quantize: str = 'none',
                     valid_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Greedy decode; returns tokens (B, max_length + 1)."""
    if quantize in FUSED_TIERS:
        return greedy_loop_fused(cfg, dp, encoder_out, max_length,
                                 valid_mask=valid_mask)
    if quantize != 'none':
        raise NotImplementedError(f'quantize={quantize!r} not yet ported')
    batch = encoder_out.shape[0]
    dev = encoder_out.device
    cross_kv = precompute_cross_kv_stacked(dp, cfg, encoder_out)
    cache = init_cache_stacked(cfg, batch, max_length, dev)
    tokens, finished = _start(cfg, batch, max_length, dev, valid_mask)
    for i in range(max_length):
        if i % _EXIT_CHECK_EVERY == 0 and bool(finished.all()):
            break
        logits = decode_step_fast(cfg, dp, tokens[:, i], i, cache, cross_kv)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(finished, cfg.pad_token_id, nxt)
        finished = finished | (nxt == cfg.eos_token_id)
        tokens[:, i + 1] = nxt
    return tokens


@torch.no_grad()
def greedy_loop_fused(cfg: MT3Config, dp: DecodeParams,
                      encoder_out: torch.Tensor, max_length: int,
                      valid_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Greedy decode through the whole-decoder window kernel.

    Each fused_decode_window call decodes t_win steps (embed -> layers ->
    lm_head -> argmax in one launch). The window length is a token rule,
    not a memory rule: it decides which attention rows take the cache's
    numerics (rows of earlier windows: a bf16-rounded q in bf16 mode,
    int8 q and codes in the integer modes) and which the window's own
    (rows of the current window: f32 q, bf16 rows). The tier is read from
    dp.fused; the cross K/V and the cache take its mode. The self-K/V
    cache is
    allocated once for the window-aligned decode budget; the kernel reads
    only rows before the window. Stops early once every row is finished,
    checked on the host once per window."""
    from mr_mt3_tpu_torch.ops.fused_decode import (
        FUSED_MAX_BATCH,
        FUSED_WINDOW,
        fused_decode_window,
        fused_tier,
        init_fused_cache,
        precompute_cross_kv_fused,
    )
    batch = encoder_out.shape[0]
    if batch > FUSED_MAX_BATCH:
        raise ValueError(f'fused decode supports at most {FUSED_MAX_BATCH} '
                         f'rows per call (got {batch})')
    dev = encoder_out.device
    t_win = min(FUSED_WINDOW, max(8, -(-max_length // 8) * 8))
    ml_eff = -(-max_length // t_win) * t_win
    cross = precompute_cross_kv_fused(dp, cfg, encoder_out)
    cache = init_fused_cache(cfg, batch, ml_eff, dev, fused_tier(dp.fused))
    tokens, finished = _start(cfg, batch, ml_eff, dev, valid_mask)
    for i in range(0, ml_eff, t_win):
        toks_w, finished, cache = fused_decode_window(
            cfg, dp.fused, dp, tokens[:, i], finished, i, cache, cross,
            t_window=t_win)
        tokens[:, i + 1:i + 1 + t_win] = toks_w
        if bool(finished.all()):
            break
    return tokens[:, :max_length + 1]
