"""Greedy decode on stacked decoder parameters (port of
mr_mt3_tpu/ops/fast_decode.py).

Two loops:
  * greedy_loop_fast — a step-by-step KV-cache decode at the model's
    activation dtype, one decode_step_fast per step:
      'none'    the exact path, plain torch ops; it launches no kernel of
                its own and is the yardstick the other tiers are held
                against;
      'int8'    the same with each layer's gated-GELU feed-forward and the
                lm_head on int8 weights (ops/int8_matmul.py: one
                int8_gated_ff launch per layer, one int8_matmul per step);
      'int8_kv' the self and cross K/V in int8 with per-position scales,
                attention through ops/int8_attention.py (two
                int8_decode_attention launches per layer and step).
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
from mr_mt3_tpu_torch.ops import int8_attention, int8_matmul
from mr_mt3_tpu_torch.ops.fused_decode import FUSED_TIERS

# the exact loop reads the finished flags back to the host (a device sync)
# once every this many steps to stop early
_EXIT_CHECK_EVERY = 8


class DecodeParams(NamedTuple):
    """Decoder weights stacked on a leading layer axis, (in, out) layout.

    With quantize='int8' the feed-forward weights are int8 codes with f32
    column scales (layers 'wi_0_q', 'wi_0_s', ...) and lm_head_q /
    lm_head_scale replace lm_head."""
    layers: Dict[str, torch.Tensor]  # name -> (L, ...) tensor
    token_embed: torch.Tensor        # (vocab, D)
    final_norm: torch.Tensor         # (D,) f32
    lm_head: torch.Tensor            # (D, vocab)
    pos_table: torch.Tensor          # (max_positions, D)
    lm_head_q: Any = None            # (D, vocab) int8 ('int8')
    lm_head_scale: Any = None        # (1, vocab) f32 ('int8')
    fused: Any = None                # FusedParams (the fused tiers)


@torch.no_grad()
def stack_decode_params(model: MT3, quantize: str = 'none') -> DecodeParams:
    """Stack the decoder blocks' weights along a leading layer axis.

    Every tensor lands on the model's device in its activation dtype. With
    a fused tier ('fused_bf16', 'fused', 'fused_int4') only the
    cross-attention K/V kernels are stacked (the window kernel holds the
    rest in FusedParams, packed for the tier). 'int8' quantizes wi_0, wi_1,
    wo and the lm_head per output column from the model's f32 parameters
    (not from the activation-dtype stack: two roundings would compound);
    'int8_kv' stacks as 'none' does (its K/V are quantized as they are
    made)."""
    cfg = model.cfg
    dtype = cfg.activation_dtype
    blocks = list(model.decoder.block)

    def stack(get):
        return torch.stack([get(b).weight.t() for b in blocks]).to(
            dtype).contiguous()

    layers = {'cross_k': stack(lambda b: b.cross_attn.k),
              'cross_v': stack(lambda b: b.cross_attn.v)}
    fused = lm_head_q = lm_head_scale = None
    lm_head = model.lm_head.weight.new_zeros((0,), dtype=dtype)
    if quantize in FUSED_TIERS:
        from mr_mt3_tpu_torch.ops.fused_decode import pack_fused_params
        fused = pack_fused_params(model, quantize)
    elif quantize in ('none', 'int8', 'int8_kv'):
        ff = (('wi_0', lambda b: b.ff.wi_0), ('wi_1', lambda b: b.ff.wi_1),
              ('wo', lambda b: b.ff.wo))
        for name, get in (('q', lambda b: b.self_attn.q),
                          ('k', lambda b: b.self_attn.k),
                          ('v', lambda b: b.self_attn.v),
                          ('o', lambda b: b.self_attn.o),
                          ('cross_q', lambda b: b.cross_attn.q),
                          ('cross_o', lambda b: b.cross_attn.o)) \
                + (() if quantize == 'int8' else ff):
            layers[name] = stack(get)
        for i, name in enumerate(('self_norm', 'cross_norm', 'ff_norm')):
            layers[name] = torch.stack(
                [b.norm(i).weight for b in blocks]).float()
        if quantize == 'int8':
            for name, get in ff:
                codes, scale = int8_matmul.quantize_columns(torch.stack(
                    [get(b).weight.float().t() for b in blocks]))
                layers[name + '_q'] = codes.contiguous()
                layers[name + '_s'] = scale.unsqueeze(-2).contiguous()
            lm_head_q, scale = int8_matmul.quantize_columns(
                model.lm_head.weight.float().t())
            lm_head_q = lm_head_q.contiguous()
            lm_head_scale = scale.unsqueeze(0).contiguous()
        else:
            lm_head = model.lm_head.weight.t().to(dtype).contiguous()
    else:
        raise ValueError(f'unknown quantize mode: {quantize!r}')
    return DecodeParams(
        layers=layers,
        token_embed=model.decoder_embed_tokens.weight.detach().to(dtype),
        final_norm=model.decoder.final_layer_norm.weight.detach().float(),
        lm_head=lm_head,
        pos_table=model.decoder.pos_table.to(dtype),
        lm_head_q=lm_head_q,
        lm_head_scale=lm_head_scale,
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


def init_int8_cache_stacked(cfg: MT3Config, batch: int, max_len: int,
                            device) -> Dict[str, torch.Tensor]:
    """int8 self-K/V caches (L, B, H, Dk, P) with f32 scales per position
    (L, B, H, 1, P), P = max_len rounded up to a multiple of 4 (the
    positions past max_len are never written or read)."""
    align = int8_attention.POSITION_ALIGN
    p = -(-max_len // align) * align
    shape = (cfg.num_decoder_layers, batch, cfg.num_heads, cfg.d_kv, p)
    sshape = shape[:3] + (1, p)
    return {'kq': torch.zeros(shape, dtype=torch.int8, device=device),
            'ks': torch.zeros(sshape, dtype=torch.float32, device=device),
            'vq': torch.zeros(shape, dtype=torch.int8, device=device),
            'vs': torch.zeros(sshape, dtype=torch.float32, device=device)}


def quantize_cross_kv(cross_kv: Tuple[torch.Tensor, torch.Tensor]
                      ) -> Dict[str, Any]:
    """(L, B, H, Dk, Lenc) cross K/V in the activation dtype -> int8 codes
    and per-position scales, zero-padded to a multiple of 4 positions;
    'last' is the last real position (Lenc - 1), the one the attention
    stops at."""
    cross_k, cross_v = cross_kv
    lenc = cross_k.shape[-1]
    pad = -lenc % int8_attention.POSITION_ALIGN
    out: Dict[str, Any] = {'last': lenc - 1}
    for name, t in (('k', cross_k), ('v', cross_v)):
        codes, scale = int8_attention.quantize_kv_rows(t)
        out[name + 'q'] = torch.nn.functional.pad(codes, (0, pad)) \
            .contiguous()
        out[name + 's'] = torch.nn.functional.pad(scale, (0, pad)) \
            .contiguous()
    return out


def decode_step_fast(cfg: MT3Config, dp: DecodeParams, tokens: torch.Tensor,
                     position: int, cache, cross_kv,
                     quantize: str = 'none') -> torch.Tensor:
    """One greedy step; tokens (B,) -> logits (B, vocab).

    Writes row `position` of the (L, B, H, Dk, P) caches in place and
    attends over rows 0..position (the JAX body masks rows > position with
    -1e9, which contributes exact zeros). quantize='int8' takes the
    feed-forward and the lm_head through the int8 kernels (dp stacked for
    'int8'); 'int8_kv' keeps the self and cross K/V in int8 (cache:
    init_int8_cache_stacked; cross_kv: quantize_cross_kv) and attends
    through int8_decode_attention."""
    eps = cfg.layer_norm_epsilon
    lay = dp.layers
    self_attention, cross_attention = (
        (_int8_self_attention, _int8_cross_attention)
        if quantize == 'int8_kv'
        else (_float_self_attention, _float_cross_attention))
    x = dp.token_embed[tokens][:, None, :]                    # (B, 1, D)
    x = x + dp.pos_table[position:position + 1]
    for i in range(cfg.num_decoder_layers):
        h = _rms(x, lay['self_norm'][i], eps)
        x = x + self_attention(cfg, lay, i, h, position, cache) \
            @ lay['o'][i]
        h = _rms(x, lay['cross_norm'][i], eps)
        x = x + cross_attention(cfg, lay, i, h, cross_kv) @ lay['cross_o'][i]
        x = x + _feed_forward(lay, i, _rms(x, lay['ff_norm'][i], eps),
                              quantize)
    x = _rms(x, dp.final_norm, eps)
    if quantize == 'int8':
        return int8_matmul.int8_matmul(x[:, 0], dp.lm_head_q,
                                       dp.lm_head_scale)
    return (x @ dp.lm_head)[:, 0]


# Layer i's attention of h (B, 1, D) -> (B, 1, H * Dk), per K/V tier: the
# self-attention also writes row `position` of the cache.

def _attend(cfg: MT3Config, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """q (B, 1, inner); k/v (B, H, Dk, K) -> (B, 1, inner)."""
    batch = q.shape[0]
    q = q.reshape(batch, 1, cfg.num_heads, cfg.d_kv)
    scores = torch.einsum('bqhd,bhdk->bhqk', q, k)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum('bhqk,bhdk->bqhd', probs, v)
    return out.reshape(batch, 1, cfg.num_heads * cfg.d_kv)


def _float_self_attention(cfg, lay, i, h, position, cache):
    k_cache, v_cache = cache
    shape = (h.shape[0], cfg.num_heads, cfg.d_kv)
    k_cache[i, :, :, :, position] = (h[:, 0] @ lay['k'][i]).reshape(shape)
    v_cache[i, :, :, :, position] = (h[:, 0] @ lay['v'][i]).reshape(shape)
    return _attend(cfg, h @ lay['q'][i], k_cache[i, ..., :position + 1],
                   v_cache[i, ..., :position + 1])


def _float_cross_attention(cfg, lay, i, h, cross_kv):
    cross_k, cross_v = cross_kv
    return _attend(cfg, h @ lay['cross_q'][i], cross_k[i], cross_v[i])


def _int8_self_attention(cfg, lay, i, h, position, cache):
    """The K/V row is quantized per position (quantize_kv_rows) as it is
    written."""
    shape = (h.shape[0], cfg.num_heads, cfg.d_kv)
    for name in ('k', 'v'):
        codes, scale = int8_attention.quantize_kv_rows(
            (h[:, 0] @ lay[name][i]).reshape(shape)[..., None])
        cache[name + 'q'][i, ..., position] = codes[..., 0]
        cache[name + 's'][i, ..., position] = scale[..., 0]
    return int8_attention.int8_decode_attention(
        (h[:, 0] @ lay['q'][i]).reshape(shape), cache['kq'][i],
        cache['ks'][i], cache['vq'][i], cache['vs'][i], position)[:, None]


def _int8_cross_attention(cfg, lay, i, h, cross):
    shape = (h.shape[0], cfg.num_heads, cfg.d_kv)
    return int8_attention.int8_decode_attention(
        (h[:, 0] @ lay['cross_q'][i]).reshape(shape), cross['kq'][i],
        cross['ks'][i], cross['vq'][i], cross['vs'][i],
        cross['last'])[:, None]


def _feed_forward(lay: Dict[str, torch.Tensor], i: int, h: torch.Tensor,
                  quantize: str) -> torch.Tensor:
    """Layer i's gated-GELU feed-forward of h (B, 1, D): int8 weights in
    one int8_gated_ff launch ('int8'), else the activation-dtype matmuls."""
    if quantize == 'int8':
        return int8_matmul.int8_gated_ff(
            h[:, 0], lay['wi_0_q'][i], lay['wi_0_s'][i], lay['wi_1_q'][i],
            lay['wi_1_s'][i], lay['wo_q'][i], lay['wo_s'][i])[:, None, :]
    return (gelu_new(h @ lay['wi_0'][i]) * (h @ lay['wi_1'][i])) \
        @ lay['wo'][i]


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
    """Greedy decode; returns tokens (B, max_length + 1). dp must be
    stacked for the tier (stack_decode_params(model, quantize)). The
    caches are allocated once for max_length positions; each step attends
    over the positions decoded so far (the JAX loop grows its cache in
    64-step phases, which gives the same attention: the positions past
    the current one contribute exact zeros). For 'int8_kv' the cross K/V
    is computed in the activation dtype first and then quantized, as JAX
    does."""
    if quantize in FUSED_TIERS:
        return greedy_loop_fused(cfg, dp, encoder_out, max_length,
                                 valid_mask=valid_mask)
    if quantize not in ('none', 'int8', 'int8_kv'):
        raise ValueError(f'unknown quantize mode: {quantize!r}')
    if (dp.lm_head_q is not None) != (quantize == 'int8'):
        raise ValueError(f'the decode parameters were not stacked for '
                         f'quantize={quantize!r}')
    batch = encoder_out.shape[0]
    dev = encoder_out.device
    cross_kv = precompute_cross_kv_stacked(dp, cfg, encoder_out)
    if quantize == 'int8_kv':
        cross_kv = quantize_cross_kv(cross_kv)
        cache = init_int8_cache_stacked(cfg, batch, max_length, dev)
    else:
        cache = init_cache_stacked(cfg, batch, max_length, dev)
    tokens, finished = _start(cfg, batch, max_length, dev, valid_mask)
    for i in range(max_length):
        if i % _EXIT_CHECK_EVERY == 0 and bool(finished.all()):
            break
        logits = decode_step_fast(cfg, dp, tokens[:, i], i, cache, cross_kv,
                                  quantize=quantize)
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
