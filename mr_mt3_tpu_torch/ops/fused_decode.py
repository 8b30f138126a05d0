"""Whole-decoder greedy decode in its three modes (port of
mr_mt3_tpu/ops/fused_decode.py, quantize='fused_bf16', 'fused' and
'fused_int4').

Two functions, each a hand-written CUDA kernel for CUDA tensors and a
plain PyTorch version of the same math at the same cast points for CPU
tensors. Nothing falls back: a CUDA tensor launches the kernel or raises.
  * fused_decode_window decodes t_window greedy steps in one launch of
    csrc/fused_decode_window.cu (it replaces the TPU kernel
    mr_mt3_tpu/ops/fused_decode.py::fused_decode_window); plain version
    fused_decode_window_reference.
  * fused_decode_step runs one decoder step and returns its logits, one
    launch of csrc/fused_decode_step.cu (it replaces
    mr_mt3_tpu/ops/fused_decode.py::fused_decode_step); plain version
    fused_decode_step_reference. The JAX package's tests hold its window
    against this step; it keeps the TPU kernel's cache chunks
    (chunk_base_for) as part of its function, and an f32 term for the
    current position.

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
padding or grouping. One launch takes any batch up to FUSED_MAX_BATCH rows,
and the self-K/V cache is allocated once for the decode budget (the kernel
reads only rows before the window). The window takes the cache rows as one
chunk; the step takes the TPU kernel's chunks, which decide its numerics.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from mr_mt3_tpu_torch.models.config import MT3Config
from mr_mt3_tpu_torch.models.mt3 import MT3, gelu_new
from mr_mt3_tpu_torch.ops.cuda_build import check_operand, count_launch
from mr_mt3_tpu_torch.ops.int8_matmul import (
    pack_int4,
    quantize_columns,
    unpack_int4,
)

# greedy steps per launch: a token rule kept from the TPU kernel (the
# window boundary decides which attention rows see the cache's numerics
# and which the window's own bf16 rows)
FUSED_WINDOW = 32

# rows per launch. The kernels tile the batch in groups of 8 and stage at
# most a fixed number of input rows in shared memory, so the cap is not a
# memory limit of the card: it is the largest batch measured on the H100
# and the handler's device-call size (PERF.md).
FUSED_MAX_BATCH = 64

_MAX_DK = 128  # the kernel's d_kv limit (csrc: MAX_DK)

# the TPU kernels' self-K/V cache chunk (mr_mt3_tpu/ops/fused_decode.py:84);
# in the step and the grouped window it is part of the function: each chunk
# is one flash update
CHUNK = 256

# the window kernel's tiers, and the code range of the integer ones
FUSED_TIERS = ('fused_bf16', 'fused', 'fused_int4')
QMAX = {'fused': 127, 'fused_int4': 7}

# the weight / cache dtype of each tier (int4 packs two codes per uint8)
_TIER_DTYPE = {'fused_bf16': torch.bfloat16, 'fused': torch.int8,
               'fused_int4': torch.uint8}
_MODE_ID = {'fused_bf16': 0, 'fused': 1, 'fused_int4': 2}  # csrc: Mode

# launches of the CUDA kernels per mode; only the kernel paths add to them
LAUNCHES = {tier: 0 for tier in FUSED_TIERS}
STEP_LAUNCHES = {tier: 0 for tier in FUSED_TIERS}


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


def chunk_base_for(lenc: int, single_group: bool = False) -> int:
    """The TPU kernels' self-K/V cache chunk for an encoder length
    (mr_mt3_tpu/ops/fused_decode.py:401-421): 256 positions, 512 above 256
    encoder rows (the segment-memory model's 320), and 1024 for a call of
    one group of at most 8 rows (single_group)."""
    if single_group:
        return CHUNK * 4
    return CHUNK * 2 if lenc > 256 else CHUNK


def _positions(kv: torch.Tensor) -> int:
    """Positions along the last axis of a K/V array (int4: two a byte)."""
    return kv.shape[-1] * (2 if kv.dtype == torch.uint8 else 1)


def cache_chunk(cache: Dict[str, torch.Tensor],
                cross: Dict[str, torch.Tensor], chunk_base: int = None
                ) -> int:
    """The chunk of a step or grouped window over this cache:
    min(chunk_base or chunk_base_for(Lenc), cache length), which must divide
    the cache length (mr_mt3_tpu/ops/fused_decode.py:585-589)."""
    max_len = _positions(cache['kq'])
    chunk = min(chunk_base or chunk_base_for(_positions(cross['ckq'])),
                max_len)
    if max_len % chunk:
        raise ValueError(f'fused cache length {max_len} must be a multiple '
                         f'of {chunk}')
    return chunk


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
        t = unpack_int4(t if stop is None else t[..., :(stop + 1) // 2])
    if stop is not None:
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


def _projection(fp: FusedParams):
    """proj(h, name, l=None): h @ W (layer l's) times W's column scales in
    the integer tiers (int8_proj), on the codes widened to f32."""
    exact = fused_tier(fp) == 'fused_bf16'
    w = {name: _codes(getattr(fp, name)) for name, _ in _WEIGHTS}
    s = {name: None if exact else getattr(fp, sname)
         for name, sname in _WEIGHTS}

    def proj(h, name, l=None):
        y = h @ (w[name] if l is None else w[name][l])
        if s[name] is None:
            return y
        return y * (s[name] if l is None else s[name][l])
    return proj


def _cache_rows(cache: Dict[str, torch.Tensor], position: int, layers: int):
    """The cache rows < position: code values as f32 (L, H, B, dk, P0) for
    K and V, and their scales (L, H, B, P0) in the integer tiers (a None
    per layer in bf16)."""
    kc = _codes(cache['kq'], position)
    vc = _codes(cache['vq'], position)
    if 'ks' not in cache:
        return kc, vc, [None] * layers, [None] * layers
    return kc, vc, cache['ks'][..., :position], cache['vs'][..., :position]


def _cache_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     ks, vs, chunk: int, exact: bool):
    """q (B, H, dk) f32 over the cache rows kc / vc (H, B, dk, P0) (code
    values as f32; per-position scales ks / vs (H, B, P0) in the integer
    tiers) as one flash update per chunk of `chunk` positions
    (flash_chunk): the running max takes each chunk's max, and p = exp(s -
    m) enters the value sum rounded to bf16 (exact) or requantized with
    the chunk's own max (_int_values). Returns (m, l, acc): (B, H), (B, H),
    (B, H, dk); with no rows, the flash state's start (-1e30, 0, 0)."""
    batch, H, dk = q.shape
    m = torch.full((batch, H), -1e30, device=q.device)
    lsum = torch.zeros((batch, H), device=q.device)
    acc = torch.zeros((batch, H, dk), device=q.device)
    for c0 in range(0, kc.shape[-1], chunk):
        cut = slice(c0, c0 + chunk)
        if exact:
            sc = torch.einsum('bhd,hbdp->bhp', _bf16r(q), kc[..., cut])
        else:
            sc = _int_scores(q, kc[..., cut], ks[..., cut])
        m_new = sc.amax(-1) if c0 == 0 else torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        if exact:
            vals = torch.einsum('bhp,hbdp->bhd', _bf16r(p), vc[..., cut])
        else:
            vals = _int_values(p, vc[..., cut], vs[..., cut])
        if c0 == 0:
            lsum, acc = p.sum(-1), vals
        else:
            alpha = torch.exp(m - m_new)
            lsum = lsum * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + vals
        m = m_new
    return m, lsum, acc


def _layer_tail(cfg: MT3Config, fp: FusedParams, proj, x: torch.Tensor,
                attn: torch.Tensor, l: int, cross: Dict[str, torch.Tensor],
                ckq: torch.Tensor, cvq: torch.Tensor, exact: bool
                ) -> torch.Tensor:
    """Layer l after self-attention (o_cross_ff): wo on the bf16 attention
    output attn (B, inner), cross-attention over the encoder K/V (code
    values ckq / cvq as f32), the gated-GELU feed-forward. Returns x."""
    batch, H, dk = x.shape[0], cfg.num_heads, cfg.d_kv
    inner, d_ff, eps = cfg.inner_dim, cfg.d_ff, cfg.layer_norm_epsilon
    x = x + proj(attn, 'wo', l)
    h2 = _bf16r(_rms(x, fp.norms[l, 1], eps))
    qc = proj(h2, 'wqc', l).reshape(batch, H, dk)
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
    return x + proj(gated, 'wff_out', l)


@torch.no_grad()
def fused_decode_window_reference(cfg: MT3Config, fp: FusedParams,
                                  pos_rows: torch.Tensor,
                                  tokens: torch.Tensor,
                                  finished: torch.Tensor, position: int,
                                  cache: Dict[str, torch.Tensor],
                                  cross: Dict[str, torch.Tensor],
                                  t_window: int = FUSED_WINDOW,
                                  return_logits: bool = False,
                                  chunk: int = None):
    """Plain PyTorch version of the window kernel, step by step.

    Returns (tokens_out (T, B) int32, finished_out (B,) int32, rows), the
    kernel's outputs, plus the per-step logits (T, B, vocab) f32 with
    return_logits=True. rows holds the window's K/V rows (T, L, H*B, dk),
    row h*B + b: {'kq', 'vq'} bf16 in the bf16 tier; in the integer tiers
    int8 codes (unpacked in int4) with their per-row f32 scales {'ks',
    'vs'} (T, L, H*B). The cache is only read (rows < position), as one
    flash chunk, or in chunks of `chunk` positions (the grouped window)."""
    tier = fused_tier(fp)
    L, H, dk = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv
    inner, eps = cfg.inner_dim, cfg.layer_norm_epsilon
    batch, T = tokens.shape[0], t_window
    dev = tokens.device
    exact = tier == 'fused_bf16'
    if tier == 'fused_int4' and (position % 2 or T % 2):
        raise ValueError('int4 windows start at an even position and have '
                         'an even length')
    proj = _projection(fp)
    ckq, cvq = _codes(cross['ckq']), _codes(cross['cvq'])
    kc, vc, ks, vs = _cache_rows(cache, position, L)
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
            m, lsum, acc = _cache_attention(q, kc[l], vc[l], ks[l], vs[l],
                                            chunk or max(position, 1), exact)
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
            x = _layer_tail(cfg, fp, proj, x, attn, l, cross, ckq, cvq, exact)
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


@torch.no_grad()
def fused_decode_step_reference(cfg: MT3Config, fp: FusedParams,
                                x: torch.Tensor, position: int,
                                cache: Dict[str, torch.Tensor],
                                cross: Dict[str, torch.Tensor], chunk: int):
    """Plain PyTorch version of the step kernel.

    x (B, D) f32 is the input row, embed[token] + pos[position]. Per layer
    the cache rows < position are attended in flash chunks of `chunk`
    positions (_cache_attention), then the current position enters as an
    f32 diagonal term on the unrounded q, k and v (_make_kernel).
    Returns (logits (B, vocab) f32, rows): the step's K/V rows (L, H*B,
    dk), row h*B + b, {'kq', 'vq'} bf16 in the bf16 tier, or int8 codes
    (unpacked in int4) with per-row f32 scales {'ks', 'vs'} (L, H*B) in
    the integer tiers. The cache is only read."""
    tier = fused_tier(fp)
    L, H, dk = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv
    inner, eps = cfg.inner_dim, cfg.layer_norm_epsilon
    batch = x.shape[0]
    exact = tier == 'fused_bf16'
    proj = _projection(fp)
    ckq, cvq = _codes(cross['ckq']), _codes(cross['cvq'])
    kc, vc, ks, vs = _cache_rows(cache, position, L)
    x = x.float()
    k_rows, v_rows = [], []
    for l in range(L):
        h1 = _bf16r(_rms(x, fp.norms[l, 0], eps))
        qkv = proj(h1, 'wqkv', l)
        q, k, v = (qkv[:, i * inner:(i + 1) * inner].reshape(batch, H, dk)
                   for i in range(3))
        k_rows.append(k.transpose(0, 1).reshape(H * batch, dk))
        v_rows.append(v.transpose(0, 1).reshape(H * batch, dk))
        m, lsum, acc = _cache_attention(q, kc[l], vc[l], ks[l], vs[l],
                                        chunk, exact)
        s_cur = (q * k).sum(-1)            # the diagonal term, f32
        m_new = torch.maximum(m, s_cur)
        alpha = torch.exp(m - m_new)
        p_cur = torch.exp(s_cur - m_new)
        lsum = lsum * alpha + p_cur
        acc = acc * alpha[..., None] + p_cur[..., None] * v
        attn = _bf16r((acc / lsum[..., None]).reshape(batch, inner))
        x = _layer_tail(cfg, fp, proj, x, attn, l, cross, ckq, cvq, exact)
    logits = proj(_bf16r(_rms(x, fp.final_norm, eps)), 'lm')
    k_rows, v_rows = torch.stack(k_rows), torch.stack(v_rows)
    if exact:
        return logits, {'kq': k_rows.to(torch.bfloat16),
                        'vq': v_rows.to(torch.bfloat16)}
    kq, ks_row = quantize_rows(k_rows, QMAX[tier])
    vq, vs_row = quantize_rows(v_rows, QMAX[tier])
    return logits, {'kq': kq, 'ks': ks_row, 'vq': vq, 'vs': vs_row}


# the CUDA libraries: (symbol prefix, launch entry points)
_LIBRARIES = {'fused_decode_window': ('fdw', ('fdw_launch',
                                              'fdw_grouped_launch')),
              'fused_decode_step': ('fds', ('fds_launch',))}


def _library(name: str):
    from mr_mt3_tpu_torch.ops import cuda_build
    lib = cuda_build.load(name)
    prefix, entries = _LIBRARIES[name]
    error_string = getattr(lib, prefix + '_error_string')
    if error_string.restype is not ctypes.c_char_p:
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        error_string.argtypes = [ctypes.c_int]
        error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, entry: str, label: str, tensors, dims, eps: float,
            dev) -> None:
    """Call entry of csrc/<name>.cu with the pointers of tensors (None:
    null) and dims, in the order of fused_decode.cuh's Ptr and Dim, on the
    current stream of dev; raise RuntimeError(label ...) if refused."""
    lib = _library(name)
    prefix = _LIBRARIES[name][0]
    if len(tensors) != getattr(lib, prefix + '_pointer_count')() or \
            len(dims) != getattr(lib, prefix + '_dim_count')():
        raise RuntimeError(f'{label}: the wrapper and the CUDA source '
                           f'disagree on the launch arguments')
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(ptrs, dim_arr, eps, stream)
    if rc != 0:
        raise RuntimeError(f'{label} launch failed: '
                           + getattr(lib, prefix + '_error_string')(rc)
                           .decode())


def _check_operands(cfg: MT3Config, fp: FusedParams,
                    cross: Dict[str, torch.Tensor],
                    cache: Dict[str, torch.Tensor], batch: int, lead,
                    extra, dev) -> Tuple[int, int]:
    """Check the weights, the cross K/V and the cache (leading axes lead:
    (L, H, B), or (L*G, H, 8) grouped) and the (name, tensor, dtype,
    shape) entries of extra, as the kernels read them. Returns the cache
    and cross lengths (P, S) in positions."""
    tier = fused_tier(fp)
    L, dk, D = cfg.num_decoder_layers, cfg.d_kv, cfg.d_model
    inner, F, V = cfg.inner_dim, cfg.d_ff, cfg.vocab_size
    per_byte = 2 if tier == 'fused_int4' else 1    # codes per stored byte
    P, S = _positions(cache['kq']), _positions(cross['ckq'])
    if not 0 < batch <= FUSED_MAX_BATCH:
        raise ValueError(f'batch {batch} outside 1..{FUSED_MAX_BATCH}')
    if dk > _MAX_DK or any(n % 8 for n in (D, inner, F, V)):
        raise ValueError('the kernel needs d_kv <= 128 and d_model, inner, '
                         'd_ff and vocab multiples of 8')
    f32, wdt = torch.float32, _TIER_DTYPE[tier]
    lead = tuple(lead)
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
        ('ckq', cross['ckq'], wdt, lead + (dk, S // per_byte)),
        ('cvq', cross['cvq'], wdt, lead + (dk, S // per_byte)),
        ('kq', cache['kq'], wdt, lead + (dk, P // per_byte)),
        ('vq', cache['vq'], wdt, lead + (dk, P // per_byte)),
        *extra]
    if tier != 'fused_bf16':
        checks += [('cks', cross.get('cks'), f32, lead + (S,)),
                   ('cvs', cross.get('cvs'), f32, lead + (S,)),
                   ('ks', cache.get('ks'), f32, lead + (P,)),
                   ('vs', cache.get('vs'), f32, lead + (P,))]
    for name, t, dtype, shape in checks:
        if t is None:
            raise ValueError(f'{name} is missing')
        # the weights are read 8 codes at a time with one vector load
        check_operand(name, t, dtype, shape, dev,
                      align=16 if name in dict(_WEIGHTS) else 1)
    return P, S


def _pointers(fp: FusedParams, cross, cache, **named):
    """The launch pointers in fused_decode.cuh's Ptr order: the weights,
    the cross K/V and the cache, then the named tensors (None: null)."""
    names = ('embed', 'pos_rows', 'wqkv', 'wo', 'wqc', 'woc', 'wff_in',
             'wff_out', 'sqkv', 'so', 'sqc', 'soc', 'sff_in', 'sff_out',
             'norms', 'final_norm', 'lm', 'lm_s', 'ckq', 'cvq', 'cks', 'cvs',
             'kq', 'vq', 'ks', 'vs', 'tokens_in', 'finished_in',
             'tokens_out', 'finished_out', 'kw', 'vw', 'kq_out', 'vq_out',
             'ks_out', 'vs_out', 'x', 'q', 'attn', 'g', 'logits', 'tok',
             'fin', 'kvf', 'sync')
    known = {**fp._asdict(), 'embed': None, **cross, **cache, **named}
    return [known.get(n) for n in names]


def window_launch(cfg: MT3Config, fp: FusedParams, pos_rows: torch.Tensor,
                  tokens: torch.Tensor, finished: torch.Tensor,
                  position: int, cache: Dict[str, torch.Tensor],
                  cross: Dict[str, torch.Tensor], t_window: int,
                  logits_out: torch.Tensor = None, chunk: int = None,
                  groups: int = None):
    """Launch a window kernel on the current stream: the window
    (fdw_launch, the cache rows < position in one chunk), or with groups
    the grouped int8 window over group-major layouts (fdw_grouped_launch,
    chunks of `chunk` positions). Outputs as
    fused_decode_window_reference's (rows in the grouped layout (T, L*G,
    H*8, ...) with groups); a given logits_out (B, vocab) f32 receives the
    last step's logits."""
    tier = fused_tier(fp)
    exact = tier == 'fused_bf16'
    L, H, dk, D = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv, cfg.d_model
    inner, F, V = cfg.inner_dim, cfg.d_ff, cfg.vocab_size
    B, T = tokens.shape[0], t_window
    dev = tokens.device
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    tokens_in = tokens.to(i32).contiguous()
    finished_in = finished.to(i32).contiguous()
    lead = (L, H, B) if groups is None else (L * groups, H, B // groups)
    P, S = _check_operands(
        cfg, fp, cross, cache, B, lead,
        [('embed', fp.embed, bf16, (V, D)),
         ('pos_rows', pos_rows, f32, (T, D)),
         ('tokens', tokens_in, i32, (B,)),
         ('finished', finished_in, i32, (B,))], dev)
    if not 0 <= position <= P - T:
        raise ValueError(f'window {position}..{position + T} exceeds the '
                         f'cache length {P}')
    if tier == 'fused_int4' and (position % 2 or T % 2):
        raise ValueError(f'an int4 window must start at an even position '
                         f'and have an even length (position {position}, '
                         f'length {T})')
    z = dict(device=dev)
    if logits_out is None:
        logits_out = torch.empty((B, V), dtype=f32, **z)
    check_operand('logits_out', logits_out, f32, (B, V), dev)
    # bf16 window rows: the output in bf16 mode, scratch in the int modes
    kw = torch.empty((T, L, H * B, dk), dtype=bf16, **z)
    vw = torch.empty_like(kw)
    rows = {'kq': kw, 'vq': vw}
    if not exact:
        emitted = (T, L, H * B) if groups is None else \
            (T, L * groups, H * (B // groups))
        rows = {'kq': torch.empty(emitted + (dk,), dtype=torch.int8, **z),
                'vq': torch.empty(emitted + (dk,), dtype=torch.int8, **z),
                'ks': torch.empty(emitted, dtype=f32, **z),
                'vs': torch.empty(emitted, dtype=f32, **z)}
    toks_out = torch.empty((T, B), dtype=i32, **z)
    fin_out = torch.empty((B,), dtype=i32, **z)
    tensors = _pointers(
        fp, cross, cache, embed=fp.embed, pos_rows=pos_rows,
        tokens_in=tokens_in, finished_in=finished_in, tokens_out=toks_out,
        finished_out=fin_out, kw=kw, vw=vw,
        **({} if exact else {key + '_out': rows[key] for key in rows}),
        x=torch.empty((B, D), dtype=f32, **z),
        q=torch.empty((B, inner), dtype=f32, **z),
        attn=torch.empty((B, inner), dtype=bf16, **z),
        g=torch.empty((B, 2 * F), dtype=f32, **z), logits=logits_out,
        tok=torch.empty((B,), dtype=i32, **z),
        fin=torch.empty((B,), dtype=i32, **z),
        kvf=None if exact else torch.empty((B, 2 * inner), dtype=f32, **z),
        # the window kernel's grid barrier counts up from 0
        sync=torch.zeros((1,), dtype=i32, **z))
    dims = [B, L, H, dk, D, F, V, S, P, T, int(position), cfg.pad_token_id,
            cfg.eos_token_id, _MODE_ID[tier], chunk or P]
    if groups is None:
        _launch('fused_decode_window', 'fdw_launch', 'fused_decode_window',
                tensors, dims, cfg.layer_norm_epsilon, dev)
    else:
        _launch('fused_decode_window', 'fdw_grouped_launch',
                'fused_decode_window_grouped', tensors, dims,
                cfg.layer_norm_epsilon, dev)
    return toks_out, fin_out, rows


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
    out = window_launch(cfg, fp, pos_rows, tokens, finished, position, cache,
                        cross, t_window, logits_out)
    count_launch(LAUNCHES, fused_tier(fp))
    return out


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
    int4 codes are packed two per byte along P (position is even). The
    grouped layout maps the same way ((T, L*G, H*8, ...) rows)."""
    H = cfg.num_heads
    for key, r in rows.items():
        T, L, hb = r.shape[:3]
        r = r.reshape(T, L, H, hb // H, *r.shape[3:])
        r = r.permute(*range(1, r.dim()), 0)          # positions last
        if cache[key].dtype == torch.uint8:
            cache[key][..., position // 2:(position + T) // 2] = pack_int4(r)
        else:
            cache[key][..., position:position + T] = r


def fused_decode_step_cuda(cfg: MT3Config, fp: FusedParams, x: torch.Tensor,
                           position: int, cache: Dict[str, torch.Tensor],
                           cross: Dict[str, torch.Tensor], chunk: int,
                           logits_out: torch.Tensor = None):
    """Launch the step kernel on the current stream; same arguments and
    outputs as fused_decode_step_reference. A given logits_out (B, vocab)
    f32 receives the logits."""
    tier = fused_tier(fp)
    exact = tier == 'fused_bf16'
    L, H, dk, D = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv, cfg.d_model
    inner, F, V = cfg.inner_dim, cfg.d_ff, cfg.vocab_size
    B, dev = x.shape[0], x.device
    f32, bf16 = torch.float32, torch.bfloat16
    P, S = _check_operands(cfg, fp, cross, cache, B, (L, H, B),
                           [('x', x, f32, (B, D))], dev)
    if not 0 <= position < P:
        raise ValueError(f'position {position} outside the cache length {P}')
    if not 0 < chunk <= P:
        raise ValueError(f'chunk {chunk} outside 1..{P}')
    z = dict(device=dev)
    if logits_out is None:
        logits_out = torch.empty((B, V), dtype=f32, **z)
    check_operand('logits_out', logits_out, f32, (B, V), dev)
    # bf16 rows: the output in bf16 mode, scratch in the int modes
    kw = torch.empty((1, L, H * B, dk), dtype=bf16, **z)
    vw = torch.empty_like(kw)
    rows = {'kq': kw, 'vq': vw}
    if not exact:
        rows = {'kq': torch.empty((1, L, H * B, dk), dtype=torch.int8, **z),
                'vq': torch.empty((1, L, H * B, dk), dtype=torch.int8, **z),
                'ks': torch.empty((1, L, H * B), dtype=f32, **z),
                'vs': torch.empty((1, L, H * B), dtype=f32, **z)}
    tensors = _pointers(
        fp, cross, cache, kw=kw, vw=vw,
        **({} if exact else {key + '_out': rows[key] for key in rows}),
        x=x.clone(),                  # the kernel adds the layers' outputs
        q=torch.empty((B, inner), dtype=f32, **z),
        attn=torch.empty((B, inner), dtype=bf16, **z),
        g=torch.empty((B, 2 * F), dtype=f32, **z), logits=logits_out,
        kvf=torch.empty((B, 2 * inner), dtype=f32, **z),
        # the kernel's grid barrier counts up from 0
        sync=torch.zeros((1,), dtype=torch.int32, **z))
    dims = [B, L, H, dk, D, F, V, S, P, 1, int(position), cfg.pad_token_id,
            cfg.eos_token_id, _MODE_ID[tier], chunk]
    _launch('fused_decode_step', 'fds_launch', 'fused_decode_step', tensors,
            dims, cfg.layer_norm_epsilon, dev)
    count_launch(STEP_LAUNCHES, tier)
    return logits_out, {key: r[0] for key, r in rows.items()}


def fused_decode_step(cfg: MT3Config, fp: FusedParams, dp,
                      tokens: torch.Tensor, position: int,
                      cache: Dict[str, torch.Tensor],
                      cross: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One greedy decoder step in one launch.

    tokens (B,) int -> (logits (B, vocab) f32, cache), the step's K/V rows
    (and in the integer tiers their scales) written into the cache in place
    at `position`. dp supplies token_embed and pos_table: the input row is
    their f32 sum. The cache rows < position are attended in chunks of
    min(chunk_base_for(Lenc), cache length) positions, which must divide
    the cache length (ValueError). The logits come back as they are: no
    argmax and no NaN check, as in the JAX package."""
    chunk = cache_chunk(cache, cross)
    if not (tokens.is_cuda or tokens.device.type == 'cpu'):
        raise ValueError(f'unsupported device {tokens.device}')
    if not 0 <= position < _positions(cache['kq']):
        raise ValueError(f'position {position} outside the cache length '
                         f'{_positions(cache["kq"])}')
    x = dp.token_embed[tokens.long()].float() \
        + dp.pos_table[position].float()
    if tokens.is_cuda:
        logits, rows = fused_decode_step_cuda(cfg, fp, x, position, cache,
                                              cross, chunk)
    else:
        logits, rows = fused_decode_step_reference(cfg, fp, x, position,
                                                   cache, cross, chunk)
    scatter_step_rows(cfg, cache, rows, position)
    return logits, cache


def scatter_step_rows(cfg: MT3Config, cache: Dict[str, torch.Tensor],
                      rows: Dict[str, torch.Tensor], position: int):
    """A step's rows (L, H*B, dk) and scales (L, H*B) -> cache position
    `position`. An int4 code goes into its nibble of the byte (the low one
    at an even position, the high one at an odd), the other kept: it holds
    the neighbouring position."""
    H = cfg.num_heads
    for key, r in rows.items():
        L, hb = r.shape[:2]
        r = r.reshape(L, H, hb // H, *r.shape[2:])
        dst = cache[key]
        if dst.dtype != torch.uint8:
            dst[..., position] = r
            continue
        nib = r.to(torch.int32) & 0xF
        old = dst[..., position // 2].to(torch.int32)
        if position % 2:
            new = (old & 0x0F) | (nib << 4)
        else:
            new = (old & 0xF0) | nib
        dst[..., position // 2] = new.to(torch.uint8)
