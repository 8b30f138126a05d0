"""Whole-decoder greedy-decode window, bf16 mode (port of the exact mode of
mr_mt3_tpu/ops/fused_decode.py, quantize='fused_bf16').

fused_decode_window decodes t_window greedy steps in one launch of the
hand-written CUDA kernel csrc/fused_decode_window.cu (it replaces the TPU
kernel mr_mt3_tpu/ops/fused_decode.py::fused_decode_window). Weights,
self-K/V and cross-K/V are bf16; every sum is f32. The kernel is taken for
CUDA tensors and fused_decode_window_reference, the plain PyTorch version
of the same math at the same cast points, for CPU tensors. Nothing falls
back: a CUDA tensor launches the kernel or raises.

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

# greedy steps per launch: a token rule kept from the TPU kernel (in bf16
# mode the window boundary decides which attention rows see a bf16 q)
FUSED_WINDOW = 32

# rows per launch. The kernel tiles the batch in groups of 8 and its
# shared memory does not grow with the batch, so the cap is not a memory
# limit of the card: it is the largest batch measured on the H100 and the
# handler's device-call size (PERF.md).
FUSED_MAX_BATCH = 64

_MAX_DK = 128  # the kernel's d_kv limit (csrc: MAX_DK)

# launches of the CUDA kernel; only the kernel path adds to it
LAUNCHES = 0


class FusedParams(NamedTuple):
    """Decoder weights for the window kernel, (in, out) layout, bf16."""
    wqkv: torch.Tensor        # (L, D, 3*inner) — q | k | v
    wo: torch.Tensor          # (L, inner, D)
    wqc: torch.Tensor         # (L, D, inner) — cross-attention q
    woc: torch.Tensor         # (L, inner, D)
    wff_in: torch.Tensor      # (L, D, 2F) — wi_0 | wi_1
    wff_out: torch.Tensor     # (L, F, D)
    norms: torch.Tensor       # (L, 3, D) f32 — self, cross, ff RMS weights
    final_norm: torch.Tensor  # (D,) f32
    lm: torch.Tensor          # (D, vocab)
    embed: torch.Tensor       # (vocab, D)


@torch.no_grad()
def pack_fused_params(model: MT3) -> FusedParams:
    """Pack the decoder for the window kernel: bf16 weights rounded from
    the fp32 originals (quantize='fused_bf16'; the int8 and int4 modes of
    the JAX package are not yet ported)."""
    blocks = list(model.decoder.block)
    bf16 = torch.bfloat16
    final_norm = model.decoder.final_layer_norm.weight.detach()

    def stacked(*gets):
        return torch.stack([
            torch.cat([get(b).weight.float().t() for get in gets], dim=1)
            for b in blocks]).to(bf16).contiguous()

    return FusedParams(
        wqkv=stacked(lambda b: b.self_attn.q, lambda b: b.self_attn.k,
                     lambda b: b.self_attn.v),
        wo=stacked(lambda b: b.self_attn.o),
        wqc=stacked(lambda b: b.cross_attn.q),
        woc=stacked(lambda b: b.cross_attn.o),
        wff_in=stacked(lambda b: b.ff.wi_0, lambda b: b.ff.wi_1),
        wff_out=stacked(lambda b: b.ff.wo),
        norms=torch.stack([torch.stack([b.norm(i).weight.float()
                                        for i in range(3)])
                           for b in blocks]).contiguous(),
        final_norm=final_norm.float().clone(),
        lm=model.lm_head.weight.float().t().to(bf16).contiguous(),
        embed=model.decoder_embed_tokens.weight.to(
            model.cfg.activation_dtype).to(bf16).contiguous())


def init_fused_cache(cfg: MT3Config, batch: int, max_len: int, device
                     ) -> Dict[str, torch.Tensor]:
    """Head-major bf16 self-K/V cache kq/vq (L, H, B, dk, P). The JAX
    layout's per-position scales ks/vs are unit-valued in this mode and
    are left out."""
    shape = (cfg.num_decoder_layers, cfg.num_heads, batch, cfg.d_kv, max_len)
    return {'kq': torch.zeros(shape, dtype=torch.bfloat16, device=device),
            'vq': torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def precompute_cross_kv_fused(dp, cfg: MT3Config, encoder_out: torch.Tensor
                              ) -> Dict[str, torch.Tensor]:
    """Encoder K/V for all layers, bf16 head-major (L, H, B, dk, Lenc)
    ckq/cvq (the unit scales cks/cvs of the JAX layout are left out)."""
    from mr_mt3_tpu_torch.ops.fast_decode import precompute_cross_kv_stacked
    k, v = precompute_cross_kv_stacked(dp, cfg, encoder_out)  # (L,B,H,dk,S)
    return {'ckq': k.transpose(1, 2).to(torch.bfloat16).contiguous(),
            'cvq': v.transpose(1, 2).to(torch.bfloat16).contiguous()}


def _bf16r(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 (nearest even) and widen back to f32."""
    return x.to(torch.bfloat16).float()


def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's f32 RMS norm (not the model's cast-back RMSNorm)."""
    var = (x * x).mean(-1, keepdim=True)
    return weight * (x * torch.rsqrt(var + eps))


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

    Returns (tokens_out (T, B) int32, finished_out (B,) int32,
    k_rows (T, L, H*B, dk) bf16, v_rows (T, L, H*B, dk) bf16), the kernel's
    outputs, plus the per-step logits (T, B, vocab) f32 with
    return_logits=True. The cache is only read (rows < position)."""
    L, H, dk = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv
    inner, d_ff, eps = cfg.inner_dim, cfg.d_ff, cfg.layer_norm_epsilon
    batch, T = tokens.shape[0], t_window
    dev = tokens.device
    w = {name: getattr(fp, name).float() for name in
         ('wqkv', 'wo', 'wqc', 'woc', 'wff_in', 'wff_out', 'lm')}
    kw = torch.empty((T, L, H * batch, dk), dtype=torch.bfloat16, device=dev)
    vw = torch.empty_like(kw)
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
            qkv = h1 @ w['wqkv'][l]
            q = heads(qkv[:, :inner])
            kw[t, l] = rows(heads(qkv[:, inner:2 * inner])).to(torch.bfloat16)
            vw[t, l] = rows(heads(qkv[:, 2 * inner:])).to(torch.bfloat16)
            if position > 0:
                kc = cache['kq'][l, ..., :position].float()   # (H,B,dk,P0)
                vc = cache['vq'][l, ..., :position].float()
                s = torch.einsum('bhd,hbdp->bhp', _bf16r(q), kc)
                m = s.amax(-1)
                p = torch.exp(s - m[..., None])
                lsum = p.sum(-1)
                acc = torch.einsum('bhp,hbdp->bhd', _bf16r(p), vc)
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
            x = x + attn @ w['wo'][l]
            h2 = _bf16r(_rms(x, fp.norms[l, 1], eps))
            qc = _bf16r(heads(h2 @ w['wqc'][l]))
            s = torch.einsum('bhd,hbds->bhs', qc, cross['ckq'][l].float())
            e = torch.exp(s - s.amax(-1, keepdim=True))
            probs = _bf16r(e / e.sum(-1, keepdim=True))
            attn_c = torch.einsum('bhs,hbds->bhd', probs,
                                  cross['cvq'][l].float())
            x = x + _bf16r(attn_c.reshape(batch, inner)) @ w['woc'][l]
            h3 = _bf16r(_rms(x, fp.norms[l, 2], eps))
            g = h3 @ w['wff_in'][l]
            gated = _bf16r(gelu_new(g[:, :d_ff]) * g[:, d_ff:])
            x = x + gated @ w['wff_out'][l]
        logits = _bf16r(_rms(x, fp.final_norm, eps)) @ w['lm']
        if return_logits:
            logits_all.append(logits)
        nxt = torch.where(fin, cfg.pad_token_id, argmax_lowest(logits))
        fin = fin | (nxt == cfg.eos_token_id)
        toks_out[t] = nxt.to(torch.int32)
        tok = nxt
    out = (toks_out, fin.to(torch.int32), kw, vw)
    if return_logits:
        out = out + (torch.stack(logits_all),)
    return out


def _check(name: str, t: torch.Tensor, dtype, shape, device):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'{name} has dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                         f'expected {tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


# the projection weights the kernel reads with 16-byte vector loads
_VECTOR_LOADED = ('wqkv', 'wo', 'wqc', 'woc', 'wff_in', 'wff_out', 'lm')


_ARGTYPES = [ctypes.c_void_p] * 28 + [ctypes.c_int] * 13 + [
    ctypes.c_float, ctypes.c_void_p]


def _library():
    from mr_mt3_tpu_torch.ops import cuda_build
    lib = cuda_build.load('fused_decode_window')
    if lib.fdw_launch.argtypes is None:
        lib.fdw_launch.argtypes = _ARGTYPES
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
    global LAUNCHES
    L, H, dk, D = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv, cfg.d_model
    inner, F, V = cfg.inner_dim, cfg.d_ff, cfg.vocab_size
    B, T = tokens.shape[0], t_window
    P, S = cache['kq'].shape[-1], cross['ckq'].shape[-1]
    dev = tokens.device
    if not 0 < B <= FUSED_MAX_BATCH:
        raise ValueError(f'batch {B} outside 1..{FUSED_MAX_BATCH}')
    if dk > _MAX_DK or any(n % 8 for n in (D, inner, F, V)):
        raise ValueError('the kernel needs d_kv <= 128 and d_model, inner, '
                         'd_ff and vocab multiples of 8')
    if not 0 <= position <= P - T:
        raise ValueError(f'window {position}..{position + T} exceeds the '
                         f'cache length {P}')
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    tokens_in = tokens.to(i32).contiguous()
    finished_in = finished.to(i32).contiguous()
    for name, t, dtype, shape in (
            ('wqkv', fp.wqkv, bf16, (L, D, 3 * inner)),
            ('wo', fp.wo, bf16, (L, inner, D)),
            ('wqc', fp.wqc, bf16, (L, D, inner)),
            ('woc', fp.woc, bf16, (L, inner, D)),
            ('wff_in', fp.wff_in, bf16, (L, D, 2 * F)),
            ('wff_out', fp.wff_out, bf16, (L, F, D)),
            ('norms', fp.norms, f32, (L, 3, D)),
            ('final_norm', fp.final_norm, f32, (D,)),
            ('lm', fp.lm, bf16, (D, V)),
            ('embed', fp.embed, bf16, (V, D)),
            ('pos_rows', pos_rows, f32, (T, D)),
            ('ckq', cross['ckq'], bf16, (L, H, B, dk, S)),
            ('cvq', cross['cvq'], bf16, (L, H, B, dk, S)),
            ('kq', cache['kq'], bf16, (L, H, B, dk, P)),
            ('vq', cache['vq'], bf16, (L, H, B, dk, P)),
            ('tokens', tokens_in, i32, (B,)),
            ('finished', finished_in, i32, (B,))):
        _check(name, t, dtype, shape, dev)
        if name in _VECTOR_LOADED and t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')
    z = dict(device=dev)
    if logits_out is None:
        logits_out = torch.empty((B, V), dtype=f32, **z)
    _check('logits_out', logits_out, f32, (B, V), dev)
    toks_out = torch.empty((T, B), dtype=i32, **z)
    fin_out = torch.empty((B,), dtype=i32, **z)
    kw = torch.empty((T, L, H * B, dk), dtype=bf16, **z)
    vw = torch.empty_like(kw)
    scratch = [torch.empty((B, D), dtype=f32, **z),           # x
               torch.empty((B, inner), dtype=f32, **z),       # q
               torch.empty((B, inner), dtype=bf16, **z),      # attn
               torch.empty((B, 2 * F), dtype=f32, **z),       # g
               logits_out,                                    # logits
               torch.empty((B,), dtype=i32, **z),             # tok
               torch.empty((B,), dtype=i32, **z)]             # fin
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (
            fp.embed, pos_rows, fp.wqkv, fp.wo, fp.wqc, fp.woc, fp.wff_in,
            fp.wff_out, fp.norms, fp.final_norm, fp.lm, cross['ckq'],
            cross['cvq'], cache['kq'], cache['vq'], tokens_in, finished_in,
            toks_out, fin_out, kw, vw, *scratch)]
        rc = lib.fdw_launch(*ptrs, B, L, H, dk, D, F, V, S, P, T,
                            int(position), cfg.pad_token_id,
                            cfg.eos_token_id, cfg.layer_norm_epsilon, stream)
    if rc != 0:
        raise RuntimeError('fused_decode_window launch failed: '
                           + lib.fdw_error_string(rc).decode())
    LAUNCHES += 1
    return toks_out, fin_out, kw, vw


def fused_decode_window(cfg: MT3Config, fp: FusedParams, dp,
                        tokens: torch.Tensor, finished: torch.Tensor,
                        position: int, cache: Dict[str, torch.Tensor],
                        cross: Dict[str, torch.Tensor],
                        t_window: int = FUSED_WINDOW
                        ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Decode t_window greedy steps in one launch.

    tokens (B,) int: input token of the first step (at `position`);
    finished (B,) bool. Returns (window_tokens (B, t_window) int32,
    finished (B,) bool, cache), with the window's K/V rows written into
    the cache in place at positions position..position+t_window-1. Raises
    FloatingPointError if a row that was not finished met NaN logits."""
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
    toks_w, fin_out, kw, vw = out
    if bool((toks_w >= cfg.vocab_size).any()):
        raise FloatingPointError(
            f'NaN logits in the decode window at position {position}')
    scatter_window_rows(cfg, cache, kw, vw, position)
    return toks_w.t(), fin_out > 0, cache


def scatter_window_rows(cfg: MT3Config, cache: Dict[str, torch.Tensor],
                        kw: torch.Tensor, vw: torch.Tensor, position: int):
    """(T, L, H*B, dk) window rows -> cache (L, H, B, dk, P) positions
    position..position+T-1."""
    T, L, hb, dk = kw.shape
    H = cfg.num_heads
    sl = slice(position, position + T)
    for key, rows in (('kq', kw), ('vq', vw)):
        cache[key][..., sl] = rows.reshape(T, L, H, hb // H, dk).permute(
            1, 2, 3, 4, 0)
