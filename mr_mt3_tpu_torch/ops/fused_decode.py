"""Whole-decoder greedy-decode window in its three modes (port of
mr_mt3_tpu/ops/fused_decode.py, quantize='fused_bf16', 'fused' and
'fused_int4').

fused_decode_window decodes t_window greedy steps in one launch of the
hand-written CUDA kernel csrc/fused_decode_window.cu (it replaces the TPU
kernel mr_mt3_tpu/ops/fused_decode.py::fused_decode_window). The kernel is
taken for CUDA tensors and fused_decode_window_reference, the plain
PyTorch version of the same math at the same cast points, for CPU tensors.
Nothing falls back: a CUDA tensor launches the kernel or raises.

The mode follows the weights' dtype, as in the JAX package:
  * bfloat16 -> 'fused_bf16': bf16 weights, self-K/V and cross-K/V, every
    sum f32, no scales (FusedParams carries unit column scales, which the
    kernel skips);
  * int8 -> 'fused': int8 codes with f32 scales per output column, int8
    self/cross K/V codes with f32 scales per position; q and the
    probabilities are quantized to int8 per (row, head) for int32 dots;
  * uint8 -> 'fused_int4': the same with codes in [-7, 7] (q and the
    probabilities stay int8), stored two per byte along the last axis, the
    one the kernel reads contiguously (weights: output columns; K/V:
    positions). Byte i holds code 2i in its low nibble and code 2i+1 in
    its high nibble, as 4-bit two's complement (ops/int8_matmul.py).

The TPU kernel's Mosaic/VMEM rules are not carried over: there is no 8-row
padding or grouping and no cache chunking. One launch takes any batch up
to FUSED_MAX_BATCH rows, and the self-K/V cache is allocated once for the
decode budget (the kernel reads only rows before the window).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from mr_mt3_tpu_torch.models.config import MT3Config
from mr_mt3_tpu_torch.models.mt3 import MT3, gelu_new
from mr_mt3_tpu_torch.ops.cuda_build import check_operand
from mr_mt3_tpu_torch.ops.int8_matmul import (
    pack_int4,
    quantize_columns,
    unpack_int4,
)

# greedy steps per launch: a token rule kept from the TPU kernel (the
# window boundary decides which attention rows see the cache's numerics
# and which the window's own bf16 rows)
FUSED_WINDOW = 32

# rows per launch. The kernel tiles the batch in groups of 8 and its
# shared memory does not grow with the batch, so the cap is not a memory
# limit of the card: it is the largest batch measured on the H100 and the
# handler's device-call size (PERF.md).
FUSED_MAX_BATCH = 64

_MAX_DK = 128  # the kernel's d_kv limit (csrc: MAX_DK)

# the window kernel's tiers, and the code range of the integer ones
FUSED_TIERS = ('fused_bf16', 'fused', 'fused_int4')
QMAX = {'fused': 127, 'fused_int4': 7}

# the weight / cache dtype of each tier (int4 packs two codes per uint8)
_TIER_DTYPE = {'fused_bf16': torch.bfloat16, 'fused': torch.int8,
               'fused_int4': torch.uint8}
_MODE_ID = {'fused_bf16': 0, 'fused': 1, 'fused_int4': 2}  # csrc: Mode

# launches of the CUDA kernel per mode; only the kernel path adds to them
LAUNCHES = {tier: 0 for tier in FUSED_TIERS}


class FusedParams(NamedTuple):
    """Decoder weights for the window kernel, (in, out) layout: bf16, int8
    or packed int4 by tier, each with f32 scales per output column (unit
    in bf16 mode)."""
    wqkv: torch.Tensor        # (L, D, 3*inner) — q | k | v
    sqkv: torch.Tensor        # (L, 3*inner)
    wo: torch.Tensor          # (L, inner, D)
    so: torch.Tensor          # (L, D)
    wqc: torch.Tensor         # (L, D, inner) — cross-attention q
    sqc: torch.Tensor         # (L, inner)
    woc: torch.Tensor         # (L, inner, D)
    soc: torch.Tensor         # (L, D)
    wff_in: torch.Tensor      # (L, D, 2F) — wi_0 | wi_1
    sff_in: torch.Tensor      # (L, 2F)
    wff_out: torch.Tensor     # (L, F, D)
    sff_out: torch.Tensor     # (L, D)
    norms: torch.Tensor       # (L, 3, D) f32 — self, cross, ff RMS weights
    final_norm: torch.Tensor  # (D,) f32
    lm: torch.Tensor          # (D, vocab)
    lm_s: torch.Tensor        # (vocab,)
    embed: torch.Tensor       # (vocab, D) bf16 in every tier


# (weight, scale) field pairs of FusedParams
_WEIGHTS = (('wqkv', 'sqkv'), ('wo', 'so'), ('wqc', 'sqc'), ('woc', 'soc'),
            ('wff_in', 'sff_in'), ('wff_out', 'sff_out'), ('lm', 'lm_s'))


def fused_tier(fp: FusedParams) -> str:
    """The tier of packed weights, read from their dtype."""
    for tier, dtype in _TIER_DTYPE.items():
        if fp.wqkv.dtype == dtype:
            return tier
    raise ValueError(f'no fused tier stores weights as {fp.wqkv.dtype}')


def _check_tier(quantize: str) -> None:
    if quantize not in FUSED_TIERS:
        raise ValueError(f'not a fused tier: {quantize!r}')


@torch.no_grad()
def pack_fused_params(model: MT3, quantize: str = 'fused_bf16'
                      ) -> FusedParams:
    """Pack the decoder for the window kernel from the fp32 originals:
    bf16 weights with unit scales ('fused_bf16'), or codes quantized per
    output column at qmax 127 ('fused') or 7 ('fused_int4', packed)."""
    _check_tier(quantize)
    blocks = list(model.decoder.block)

    def pack(w):                       # (..., K, N) f32 -> codes, scales
        if quantize == 'fused_bf16':
            return (w.to(torch.bfloat16).contiguous(),
                    torch.ones(w.shape[:-2] + w.shape[-1:],
                               device=w.device))
        codes, scale = quantize_columns(w, QMAX[quantize])
        if quantize == 'fused_int4':
            codes = pack_int4(codes)
        return codes.contiguous(), scale.contiguous()

    def stacked(*gets):
        return pack(torch.stack([
            torch.cat([get(b).weight.float().t() for get in gets], dim=1)
            for b in blocks]))

    wqkv, sqkv = stacked(lambda b: b.self_attn.q, lambda b: b.self_attn.k,
                         lambda b: b.self_attn.v)
    wo, so = stacked(lambda b: b.self_attn.o)
    wqc, sqc = stacked(lambda b: b.cross_attn.q)
    woc, soc = stacked(lambda b: b.cross_attn.o)
    wff_in, sff_in = stacked(lambda b: b.ff.wi_0, lambda b: b.ff.wi_1)
    wff_out, sff_out = stacked(lambda b: b.ff.wo)
    lm, lm_s = pack(model.lm_head.weight.float().t())
    return FusedParams(
        wqkv=wqkv, sqkv=sqkv, wo=wo, so=so, wqc=wqc, sqc=sqc, woc=woc,
        soc=soc, wff_in=wff_in, sff_in=sff_in, wff_out=wff_out,
        sff_out=sff_out,
        norms=torch.stack([torch.stack([b.norm(i).weight.float()
                                        for i in range(3)])
                           for b in blocks]).contiguous(),
        final_norm=model.decoder.final_layer_norm.weight.detach().float()
        .clone(),
        lm=lm, lm_s=lm_s,
        embed=model.decoder_embed_tokens.weight.to(
            model.cfg.activation_dtype).to(torch.bfloat16).contiguous())


def init_fused_cache(cfg: MT3Config, batch: int, max_len: int, device,
                     quantize: str) -> Dict[str, torch.Tensor]:
    """Head-major self-K/V cache kq/vq (L, H, B, dk, P): bf16 rows, or
    int8 codes, or int4 codes packed along P (L, H, B, dk, P/2), the
    integer tiers with per-position f32 scales ks/vs (L, H, B, P). The
    bf16 tier leaves out the JAX layout's unit scales."""
    _check_tier(quantize)
    L, H, dk = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv
    cols = max_len
    if quantize == 'fused_int4':
        if max_len % 2:
            raise ValueError(f'an int4 cache needs an even length, got '
                             f'{max_len}')
        cols = max_len // 2
    shape = (L, H, batch, dk, cols)
    dtype = _TIER_DTYPE[quantize]
    cache = {'kq': torch.zeros(shape, dtype=dtype, device=device),
             'vq': torch.zeros(shape, dtype=dtype, device=device)}
    if quantize != 'fused_bf16':
        for key in ('ks', 'vs'):
            cache[key] = torch.zeros((L, H, batch, max_len), device=device)
    return cache


def precompute_cross_kv_fused(dp, cfg: MT3Config, encoder_out: torch.Tensor
                              ) -> Dict[str, torch.Tensor]:
    """Encoder K/V for all layers, head-major (L, H, B, dk, Lenc) ckq/cvq,
    in the tier of dp.fused: bf16 (the unit scales cks/cvs of the JAX
    layout are left out), or codes quantized per position over dk with
    f32 scales cks/cvs (L, H, B, Lenc) (int4 packed along Lenc)."""
    from mr_mt3_tpu_torch.ops.fast_decode import precompute_cross_kv_stacked
    quantize = fused_tier(dp.fused)
    k, v = precompute_cross_kv_stacked(dp, cfg, encoder_out)  # (L,B,H,dk,S)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    if quantize == 'fused_bf16':
        return {'ckq': k.to(torch.bfloat16).contiguous(),
                'cvq': v.to(torch.bfloat16).contiguous()}
    out = {}
    for name, x in (('ck', k), ('cv', v)):
        # one scale per position, over dk (fused_decode.py:249-253)
        codes, scale = quantize_columns(x, QMAX[quantize])
        if quantize == 'fused_int4':
            codes = pack_int4(codes)
        out[name + 'q'] = codes.contiguous()
        out[name + 's'] = scale.contiguous()
    return out


def _bf16r(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 (nearest even) and widen back to f32."""
    return x.to(torch.bfloat16).float()


def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's f32 RMS norm (not the model's cast-back RMSNorm)."""
    var = (x * x).mean(-1, keepdim=True)
    return weight * (x * torch.rsqrt(var + eps))


def quantize_rows(x: torch.Tensor, qmax: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., dk) f32 -> (int8 codes, (...) f32 scales), one scale per row:
    max(max|x|, 1e-12) / qmax (the window's emitted K/V rows,
    _math_helpers.quantize_rows)."""
    scale = torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-12) / qmax
    codes = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return codes.to(torch.int8), scale[..., 0]


def _int_scores(q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor
                ) -> torch.Tensor:
    """q (B, H, dk) f32 against integer K codes (H, B, dk, P) with scales
    (H, B, P): q quantized to int8 per (row, head), the integer dot (exact
    in f32: every partial sum is an integer below 2^24), times qscale,
    times the position's scale (scores_mxu)."""
    qs = torch.clamp(q.abs().amax(-1, keepdim=True), min=1e-12) / 127
    qi = torch.clamp(torch.round(q / qs), -127, 127)
    s = torch.einsum('bhd,hbdp->bhp', qi, codes)
    return s * qs * scale.transpose(0, 1)


def _int_values(p: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor
                ) -> torch.Tensor:
    """Probabilities (B, H, P) f32 against integer V codes (H, B, dk, P)
    with scales (H, B, P): p * scale requantized to int8 per (row, head)
    (floor 1e-20), the integer dot, times that scale (values_mxu)."""
    pv = p * scale.transpose(0, 1)
    ps = torch.clamp(pv.abs().amax(-1, keepdim=True), min=1e-20) / 127
    pi = torch.clamp(torch.round(pv / ps), -127, 127)
    return torch.einsum('bhp,hbdp->bhd', pi, codes) * ps


def _codes(t: torch.Tensor, stop: int = None) -> torch.Tensor:
    """f32 values of a bf16 / int8 / packed int4 array, positions (last
    axis) < stop."""
    if t.dtype == torch.uint8:
        t = unpack_int4(t if stop is None else t[..., :stop // 2])
    elif stop is not None:
        t = t[..., :stop]
    return t.float()


def argmax_lowest(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis, ties to the lowest index. A row holding a
    NaN gives the vocabulary size (its max is NaN, so no index equals it),
    the TPU kernel's rule and the CUDA kernel's."""
    vocab = logits.shape[-1]
    ids = torch.arange(vocab, device=logits.device)
    mx = logits.amax(-1, keepdim=True)
    return torch.where(logits == mx, ids, vocab).amin(-1)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """f32 embedding rows of tokens (B,); a token outside the vocabulary
    (the NaN token) embeds as zeros, as a one-hot matmul would."""
    vocab = embed.shape[0]
    inside = (tokens >= 0) & (tokens < vocab)
    rows = embed[torch.where(inside, tokens, 0)].float()
    return torch.where(inside[:, None], rows, 0.0)


def window_pos_rows(dp, position: int, t_window: int) -> torch.Tensor:
    """Position-table rows position..position+T-1 as f32 (T, D); the start
    clamps like jax.lax.dynamic_slice."""
    table = dp.pos_table
    start = max(0, min(position, table.shape[0] - t_window))
    return table[start:start + t_window].float().contiguous()


@torch.no_grad()
def fused_decode_window_reference(cfg: MT3Config, fp: FusedParams,
                                  pos_rows: torch.Tensor,
                                  tokens: torch.Tensor,
                                  finished: torch.Tensor, position: int,
                                  cache: Dict[str, torch.Tensor],
                                  cross: Dict[str, torch.Tensor],
                                  t_window: int = FUSED_WINDOW,
                                  return_logits: bool = False):
    """Plain PyTorch version of the window kernel, step by step.

    Returns (tokens_out (T, B) int32, finished_out (B,) int32, rows), the
    kernel's outputs, plus the per-step logits (T, B, vocab) f32 with
    return_logits=True. rows holds the window's K/V rows (T, L, H*B, dk),
    row h*B + b: {'kq', 'vq'} bf16 in the bf16 tier; in the integer tiers
    int8 codes (unpacked in int4) with their per-row f32 scales {'ks',
    'vs'} (T, L, H*B). The cache is only read (rows < position)."""
    tier = fused_tier(fp)
    L, H, dk = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv
    inner, d_ff, eps = cfg.inner_dim, cfg.d_ff, cfg.layer_norm_epsilon
    batch, T = tokens.shape[0], t_window
    dev = tokens.device
    exact = tier == 'fused_bf16'
    if tier == 'fused_int4' and (position % 2 or T % 2):
        raise ValueError('int4 windows start at an even position and have '
                         'an even length')
    w = {name: _codes(getattr(fp, name)) for name, _ in _WEIGHTS}
    s = {name: None if exact else getattr(fp, sname)
         for name, sname in _WEIGHTS}
    ckq, cvq = _codes(cross['ckq']), _codes(cross['cvq'])
    if position > 0:
        kc = _codes(cache['kq'], position)      # (L, H, B, dk, P0)
        vc = _codes(cache['vq'], position)
    kw = torch.empty((T, L, H * batch, dk), dtype=torch.bfloat16, device=dev)
    vw = torch.empty_like(kw)
    if not exact:
        qmax = QMAX[tier]
        rows_out = {key: torch.empty((T, L, H * batch) + tail, dtype=dtype,
                                     device=dev)
                    for key, tail, dtype in (
                        ('kq', (dk,), torch.int8), ('vq', (dk,), torch.int8),
                        ('ks', (), torch.float32), ('vs', (), torch.float32))}
    toks_out = torch.empty((T, batch), dtype=torch.int32, device=dev)
    logits_all = []
    tok = tokens.long()
    fin = finished.bool().clone()

    def proj(h, name, l=None):          # int8_proj: (h @ W) * column scale
        y = h @ (w[name] if l is None else w[name][l])
        if s[name] is None:
            return y
        return y * (s[name] if l is None else s[name][l])

    def heads(y):                       # (B, inner) -> (B, H, dk)
        return y.reshape(batch, H, dk)

    def rows(y):                        # (B, H, dk) -> (H*B, dk), h*B + b
        return y.transpose(0, 1).reshape(H * batch, dk)

    for t in range(T):
        x = embed_tokens(fp.embed, tok) + pos_rows[t]
        for l in range(L):
            h1 = _bf16r(_rms(x, fp.norms[l, 0], eps))
            qkv = proj(h1, 'wqkv', l)
            q = heads(qkv[:, :inner])
            k_rows = rows(heads(qkv[:, inner:2 * inner]))
            v_rows = rows(heads(qkv[:, 2 * inner:]))
            kw[t, l] = k_rows.to(torch.bfloat16)
            vw[t, l] = v_rows.to(torch.bfloat16)
            if not exact:
                for key, r in (('k', k_rows), ('v', v_rows)):
                    codes, scale = quantize_rows(r, qmax)
                    rows_out[key + 'q'][t, l] = codes
                    rows_out[key + 's'][t, l] = scale
            if position > 0:
                if exact:
                    sc = torch.einsum('bhd,hbdp->bhp', _bf16r(q), kc[l])
                else:
                    sc = _int_scores(q, kc[l], cache['ks'][l, ..., :position])
                m = sc.amax(-1)
                p = torch.exp(sc - m[..., None])
                lsum = p.sum(-1)
                if exact:
                    acc = torch.einsum('bhp,hbdp->bhd', _bf16r(p), vc[l])
                else:
                    acc = _int_values(p, vc[l],
                                      cache['vs'][l, ..., :position])
            else:
                m = torch.full((batch, H), -1e30, device=dev)
                lsum = torch.zeros((batch, H), device=dev)
                acc = torch.zeros((batch, H, dk), device=dev)
            for j in range(t + 1):
                kj = kw[j, l].float().reshape(H, batch, dk).transpose(0, 1)
                vj = vw[j, l].float().reshape(H, batch, dk).transpose(0, 1)
                s_j = (q * kj).sum(-1)
                m_new = torch.maximum(m, s_j)
                alpha = torch.exp(m - m_new)
                p_j = torch.exp(s_j - m_new)
                lsum = lsum * alpha + p_j
                acc = acc * alpha[..., None] + p_j[..., None] * vj
                m = m_new
            attn = _bf16r((acc / lsum[..., None]).reshape(batch, inner))
            x = x + proj(attn, 'wo', l)
            h2 = _bf16r(_rms(x, fp.norms[l, 1], eps))
            qc = heads(proj(h2, 'wqc', l))
            if exact:
                sc = torch.einsum('bhd,hbds->bhs', _bf16r(qc), ckq[l])
                e = torch.exp(sc - sc.amax(-1, keepdim=True))
                probs = _bf16r(e / e.sum(-1, keepdim=True))
                attn_c = torch.einsum('bhs,hbds->bhd', probs, cvq[l])
            else:
                sc = _int_scores(qc, ckq[l], cross['cks'][l])
                e = torch.exp(sc - sc.amax(-1, keepdim=True))
                attn_c = _int_values(e / e.sum(-1, keepdim=True), cvq[l],
                                     cross['cvs'][l])
            x = x + proj(_bf16r(attn_c.reshape(batch, inner)), 'woc', l)
            h3 = _bf16r(_rms(x, fp.norms[l, 2], eps))
            g = proj(h3, 'wff_in', l)
            gated = _bf16r(gelu_new(g[:, :d_ff]) * g[:, d_ff:])
            x = x + proj(gated, 'wff_out', l)
        logits = proj(_bf16r(_rms(x, fp.final_norm, eps)), 'lm')
        if return_logits:
            logits_all.append(logits)
        nxt = torch.where(fin, cfg.pad_token_id, argmax_lowest(logits))
        fin = fin | (nxt == cfg.eos_token_id)
        toks_out[t] = nxt.to(torch.int32)
        tok = nxt
    out = (toks_out, fin.to(torch.int32),
           {'kq': kw, 'vq': vw} if exact else rows_out)
    if return_logits:
        out = out + (torch.stack(logits_all),)
    return out


def _library():
    from mr_mt3_tpu_torch.ops import cuda_build
    lib = cuda_build.load('fused_decode_window')
    if lib.fdw_launch.argtypes is None:
        lib.fdw_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_float, ctypes.c_void_p]
        lib.fdw_launch.restype = ctypes.c_int
        lib.fdw_error_string.argtypes = [ctypes.c_int]
        lib.fdw_error_string.restype = ctypes.c_char_p
    return lib


def fused_decode_window_cuda(cfg: MT3Config, fp: FusedParams,
                             pos_rows: torch.Tensor, tokens: torch.Tensor,
                             finished: torch.Tensor, position: int,
                             cache: Dict[str, torch.Tensor],
                             cross: Dict[str, torch.Tensor],
                             t_window: int = FUSED_WINDOW,
                             logits_out: torch.Tensor = None):
    """Launch the CUDA kernel on the current stream; same arguments and
    outputs as fused_decode_window_reference (without logits). A given
    logits_out (B, vocab) f32 receives the last step's logits."""
    tier = fused_tier(fp)
    exact = tier == 'fused_bf16'
    L, H, dk, D = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv, cfg.d_model
    inner, F, V = cfg.inner_dim, cfg.d_ff, cfg.vocab_size
    B, T = tokens.shape[0], t_window
    per_byte = 2 if tier == 'fused_int4' else 1    # codes per stored byte
    P = cache['kq'].shape[-1] * per_byte
    S = cross['ckq'].shape[-1] * per_byte
    dev = tokens.device
    if not 0 < B <= FUSED_MAX_BATCH:
        raise ValueError(f'batch {B} outside 1..{FUSED_MAX_BATCH}')
    if dk > _MAX_DK or any(n % 8 for n in (D, inner, F, V)):
        raise ValueError('the kernel needs d_kv <= 128 and d_model, inner, '
                         'd_ff and vocab multiples of 8')
    if not 0 <= position <= P - T:
        raise ValueError(f'window {position}..{position + T} exceeds the '
                         f'cache length {P}')
    if per_byte == 2 and (position % 2 or T % 2):
        raise ValueError(f'an int4 window must start at an even position '
                         f'and have an even length (position {position}, '
                         f'length {T})')
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    wdt = _TIER_DTYPE[tier]
    tokens_in = tokens.to(i32).contiguous()
    finished_in = finished.to(i32).contiguous()
    checks = [
        ('wqkv', fp.wqkv, wdt, (L, D, 3 * inner // per_byte)),
        ('sqkv', fp.sqkv, f32, (L, 3 * inner)),
        ('wo', fp.wo, wdt, (L, inner, D // per_byte)),
        ('so', fp.so, f32, (L, D)),
        ('wqc', fp.wqc, wdt, (L, D, inner // per_byte)),
        ('sqc', fp.sqc, f32, (L, inner)),
        ('woc', fp.woc, wdt, (L, inner, D // per_byte)),
        ('soc', fp.soc, f32, (L, D)),
        ('wff_in', fp.wff_in, wdt, (L, D, 2 * F // per_byte)),
        ('sff_in', fp.sff_in, f32, (L, 2 * F)),
        ('wff_out', fp.wff_out, wdt, (L, F, D // per_byte)),
        ('sff_out', fp.sff_out, f32, (L, D)),
        ('norms', fp.norms, f32, (L, 3, D)),
        ('final_norm', fp.final_norm, f32, (D,)),
        ('lm', fp.lm, wdt, (D, V // per_byte)),
        ('lm_s', fp.lm_s, f32, (V,)),
        ('embed', fp.embed, bf16, (V, D)),
        ('pos_rows', pos_rows, f32, (T, D)),
        ('ckq', cross['ckq'], wdt, (L, H, B, dk, S // per_byte)),
        ('cvq', cross['cvq'], wdt, (L, H, B, dk, S // per_byte)),
        ('kq', cache['kq'], wdt, (L, H, B, dk, P // per_byte)),
        ('vq', cache['vq'], wdt, (L, H, B, dk, P // per_byte)),
        ('tokens', tokens_in, i32, (B,)),
        ('finished', finished_in, i32, (B,))]
    if not exact:
        checks += [('cks', cross.get('cks'), f32, (L, H, B, S)),
                   ('cvs', cross.get('cvs'), f32, (L, H, B, S)),
                   ('ks', cache.get('ks'), f32, (L, H, B, P)),
                   ('vs', cache.get('vs'), f32, (L, H, B, P))]
    for name, t, dtype, shape in checks:
        if t is None:
            raise ValueError(f'{name} is missing')
        # the weights are read 8 codes at a time with one vector load
        check_operand(name, t, dtype, shape, dev,
                      align=16 if name in dict(_WEIGHTS) else 1)
    z = dict(device=dev)
    if logits_out is None:
        logits_out = torch.empty((B, V), dtype=f32, **z)
    check_operand('logits_out', logits_out, f32, (B, V), dev)
    toks_out = torch.empty((T, B), dtype=i32, **z)
    fin_out = torch.empty((B,), dtype=i32, **z)
    # bf16 window rows: the output in bf16 mode, scratch in the int modes
    kw = torch.empty((T, L, H * B, dk), dtype=bf16, **z)
    vw = torch.empty_like(kw)
    rows = {'kq': kw, 'vq': vw}
    if not exact:
        rows = {'kq': torch.empty((T, L, H * B, dk), dtype=torch.int8, **z),
                'vq': torch.empty((T, L, H * B, dk), dtype=torch.int8, **z),
                'ks': torch.empty((T, L, H * B), dtype=f32, **z),
                'vs': torch.empty((T, L, H * B), dtype=f32, **z)}
    scratch = [torch.empty((B, D), dtype=f32, **z),           # x
               torch.empty((B, inner), dtype=f32, **z),       # q
               torch.empty((B, inner), dtype=bf16, **z),      # attn
               torch.empty((B, 2 * F), dtype=f32, **z),       # g
               logits_out,                                    # logits
               torch.empty((B,), dtype=i32, **z),             # tok
               torch.empty((B,), dtype=i32, **z),             # fin
               None if exact else
               torch.empty((B, 2 * inner), dtype=f32, **z)]   # kvf
    tensors = [fp.embed, pos_rows, fp.wqkv, fp.wo, fp.wqc, fp.woc,
               fp.wff_in, fp.wff_out, fp.sqkv, fp.so, fp.sqc, fp.soc,
               fp.sff_in, fp.sff_out, fp.norms, fp.final_norm, fp.lm,
               fp.lm_s, cross['ckq'], cross['cvq'], cross.get('cks'),
               cross.get('cvs'), cache['kq'], cache['vq'], cache.get('ks'),
               cache.get('vs'), tokens_in, finished_in, toks_out, fin_out,
               kw, vw, None if exact else rows['kq'],
               None if exact else rows['vq'],
               None if exact else rows['ks'],
               None if exact else rows['vs'], *scratch]
    dims = [B, L, H, dk, D, F, V, S, P, T, int(position), cfg.pad_token_id,
            cfg.eos_token_id, _MODE_ID[tier]]
    lib = _library()
    if len(tensors) != lib.fdw_pointer_count() or \
            len(dims) != lib.fdw_dim_count():
        raise RuntimeError('fused_decode_window: the wrapper and the CUDA '
                           'source disagree on the launch arguments')
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fdw_launch(ptrs, dim_arr, cfg.layer_norm_epsilon, stream)
    if rc != 0:
        raise RuntimeError('fused_decode_window launch failed: '
                           + lib.fdw_error_string(rc).decode())
    LAUNCHES[tier] += 1
    return toks_out, fin_out, rows


def fused_decode_window(cfg: MT3Config, fp: FusedParams, dp,
                        tokens: torch.Tensor, finished: torch.Tensor,
                        position: int, cache: Dict[str, torch.Tensor],
                        cross: Dict[str, torch.Tensor],
                        t_window: int = FUSED_WINDOW
                        ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Decode t_window greedy steps in one launch.

    tokens (B,) int: input token of the first step (at `position`);
    finished (B,) bool. Returns (window_tokens (B, t_window) int32,
    finished (B,) bool, cache), with the window's K/V rows (and, in the
    integer tiers, their scales) written into the cache in place at
    positions position..position+t_window-1. Raises FloatingPointError if
    a row that was not finished met NaN logits."""
    pos_rows = window_pos_rows(dp, position, t_window)
    if tokens.is_cuda:
        out = fused_decode_window_cuda(cfg, fp, pos_rows, tokens, finished,
                                       position, cache, cross, t_window)
    elif tokens.device.type == 'cpu':
        out = fused_decode_window_reference(cfg, fp, pos_rows, tokens,
                                            finished, position, cache,
                                            cross, t_window)
    else:
        raise ValueError(f'unsupported device {tokens.device}')
    toks_w, fin_out, rows = out
    if bool((toks_w >= cfg.vocab_size).any()):
        raise FloatingPointError(
            f'NaN logits in the decode window at position {position}')
    scatter_window_rows(cfg, cache, rows, position)
    return toks_w.t(), fin_out > 0, cache


def scatter_window_rows(cfg: MT3Config, cache: Dict[str, torch.Tensor],
                        rows: Dict[str, torch.Tensor], position: int):
    """Window rows (T, L, H*B, dk) and scales (T, L, H*B) -> cache
    (L, H, B, dk, P) and (L, H, B, P) positions position..position+T-1;
    int4 codes are packed two per byte along P (position is even)."""
    H = cfg.num_heads
    for key, r in rows.items():
        T, L, hb = r.shape[:3]
        r = r.reshape(T, L, H, hb // H, *r.shape[3:])
        r = r.permute(*range(1, r.dim()), 0)          # positions last
        if cache[key].dtype == torch.uint8:
            cache[key][..., position // 2:(position + T) // 2] = pack_int4(r)
        else:
            cache[key][..., position:position + T] = r
