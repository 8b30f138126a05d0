"""The greedy decoder of the window tiers, teacher-forced, as plain float32
PyTorch: the logits at every step of a segment whose tokens are given.

The configuration states the tier's arithmetic and this file works it out
again from the float32 weights:

  * weights: codes per output column, scale max|w| / qmax (qmax 7 for
    int4, 127 for int8), round half to even; a product is (h @ codes)
    times the column scales;
  * the inputs of every projection, the attention outputs, the gated
    hidden and the embedding rows are rounded to bf16 (`act`);
  * the decode runs in windows of 32 steps. A step's self-attention reads
    the rows of earlier windows as integer codes, one scale a position
    over d_kv, with q quantized per (row, head) to `qmax_act` levels and
    the probabilities times the value scales requantized the same way;
    it reads its own window's rows as bf16, against q in f32;
  * the cross-attention reads the encoder's K/V as codes per position,
    with q and the probabilities quantized as above.

A control passes another `act` rounding and `qmax_act`.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from perfbench.reference.model import Weights, gelu_tanh, rms

WINDOW = 32
QMAX = {'fused_int4': 7, 'fused': 127}


def bf16r(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def fp8r(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 (saturating at 448) and widen back."""
    return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()


def quantize(x: torch.Tensor, qmax: int, dim: int):
    """Symmetric codes of x along `dim`: (codes as float, scales with dim
    kept), scale = max(max|x|, 1e-12) / qmax."""
    scale = x.abs().amax(dim, keepdim=True).clamp(min=1e-12) / qmax
    return torch.clamp(torch.round(x / scale), -qmax, qmax), scale


def pack_weights(w: Weights, sizes: dict, tier: str) -> Dict[str, tuple]:
    """The decoder's matrices in (in, out) layout as (codes, column
    scales), quantized from the float32 weights."""
    qmax = QMAX[tier]
    L = sizes['num_decoder_layers']

    def blk(i, key):
        return w[f'decoder.block.{i}.layer.{key}.weight'].t()

    def stacked(*keys):
        return torch.stack([torch.cat([blk(i, k) for k in keys], 1)
                            for i in range(L)])

    mats = {
        'wqkv': stacked('0.SelfAttention.q', '0.SelfAttention.k',
                        '0.SelfAttention.v'),
        'wo': stacked('0.SelfAttention.o'),
        'wqc': stacked('1.EncDecAttention.q'),
        'wkc': stacked('1.EncDecAttention.k'),
        'wvc': stacked('1.EncDecAttention.v'),
        'woc': stacked('1.EncDecAttention.o'),
        'wff_in': stacked('2.DenseReluDense.wi_0', '2.DenseReluDense.wi_1'),
        'wff_out': stacked('2.DenseReluDense.wo'),
    }
    out = {k: quantize(v, qmax, -2) for k, v in mats.items()
           if k not in ('wkc', 'wvc')}
    out['lm'] = quantize(w['lm_head.weight'].t(), qmax, -2)
    # the cross K/V projections stay float: the encoder's K/V are made in
    # the model's dtype and then quantized per position
    out['wkc'], out['wvc'] = mats['wkc'], mats['wvc']
    return out


def _int_scores(q, kc, ks, qmax_act):
    """q (B, H, T, dk) f32 against K codes (B, H, P, dk) with scales
    (B, H, P): q quantized per (row, head, step)."""
    qi, qs = quantize(q, qmax_act, -1)
    return (qi @ kc.transpose(-1, -2)) * qs * ks[:, :, None, :]


def _int_values(p, vc, vs, qmax_act):
    """Probabilities (B, H, T, P) times the value scales, requantized per
    (row, head, step), against V codes (B, H, P, dk)."""
    pv = p * vs[:, :, None, :]
    scale = pv.abs().amax(-1, keepdim=True).clamp(min=1e-20) / qmax_act
    pi = torch.clamp(torch.round(pv / scale), -qmax_act, qmax_act)
    return (pi @ vc) * scale


@torch.no_grad()
def decode_logits(w: Weights, packed: Dict[str, tuple], sizes: dict,
                  tier: str, enc: torch.Tensor, tokens: torch.Tensor,
                  pos_table: torch.Tensor, act: Callable = bf16r,
                  qmax_act: int = 127,
                  model_rnd: Callable = None) -> torch.Tensor:
    """Teacher-forced logits (B, T, vocab): enc (B, Lenc, D) the encoder
    output the cross K/V are made from, tokens (B, T) the step inputs
    (the start token, then the served tokens), pos_table (>= T, D);
    model_rnd rounds the cross K/V projection as the model's dtype
    stores it (None: float32)."""
    L, H, dk = sizes['num_decoder_layers'], sizes['num_heads'], sizes['d_kv']
    D, inner, F = sizes['d_model'], H * dk, sizes['d_ff']
    eps = sizes['layer_norm_epsilon']
    qmax = QMAX[tier]
    b, T = tokens.shape
    dev = enc.device

    def proj(h, key, l=None):
        codes, scale = packed[key]
        if l is not None:
            codes, scale = codes[l], scale[l]
        return (h @ codes) * scale

    def heads(y):                           # (B, T, inner) -> (B, H, T, dk)
        return y.view(b, -1, H, dk).transpose(1, 2)

    emb = act(w['decoder_embed_tokens.weight'][tokens.long()])
    x = emb + pos_table[:T].to(dev)
    t_idx = torch.arange(T, device=dev)
    start = (t_idx // WINDOW) * WINDOW
    # key j of query t: cache row if j < start(t), window row if
    # start(t) <= j <= t, unseen after t
    in_cache = t_idx[None, :] < start[:, None]
    in_window = (t_idx[None, :] >= start[:, None]) & \
        (t_idx[None, :] <= t_idx[:, None])
    lenc = enc.shape[1]
    for l in range(L):
        p = f'decoder.block.{l}.layer'
        h1 = act(rms(x, w[f'{p}.0.layer_norm.weight'], eps))
        qkv = proj(h1, 'wqkv', l)
        q = heads(qkv[..., :inner])
        k = heads(qkv[..., inner:2 * inner])
        v = heads(qkv[..., 2 * inner:])
        kc, ks = quantize(k, qmax, -1)
        vc, vs = quantize(v, qmax, -1)
        s_cache = _int_scores(q, kc, ks[..., 0], qmax_act)
        s_win = q @ act(k).transpose(-1, -2)
        s = torch.where(in_cache, s_cache,
                        torch.where(in_window, s_win,
                                    torch.full_like(s_win, -torch.inf)))
        pr = torch.exp(s - s.amax(-1, keepdim=True))
        pr_cache = torch.where(in_cache, pr, torch.zeros_like(pr))
        pr_win = torch.where(in_window, pr, torch.zeros_like(pr))
        num = _int_values(pr_cache, vc, vs[..., 0], qmax_act) \
            + pr_win @ act(v)
        att = act((num / pr.sum(-1, keepdim=True))
                  .transpose(1, 2).reshape(b, T, inner))
        x = x + proj(att, 'wo', l)
        # cross-attention over the encoder's K/V codes
        mr = model_rnd or (lambda t: t)
        ck = mr(enc @ mr(packed['wkc'][l])).view(b, lenc, H, dk) \
            .transpose(1, 2)
        cv = mr(enc @ mr(packed['wvc'][l])).view(b, lenc, H, dk) \
            .transpose(1, 2)
        ckc, cks = quantize(ck, qmax, -1)
        cvc, cvs = quantize(cv, qmax, -1)
        h2 = act(rms(x, w[f'{p}.1.layer_norm.weight'], eps))
        qc = heads(proj(h2, 'wqc', l))
        sc = _int_scores(qc, ckc, cks[..., 0], qmax_act)
        e = torch.exp(sc - sc.amax(-1, keepdim=True))
        att_c = _int_values(e / e.sum(-1, keepdim=True), cvc, cvs[..., 0],
                            qmax_act)
        x = x + proj(act(att_c.transpose(1, 2).reshape(b, T, inner)),
                     'woc', l)
        h3 = act(rms(x, w[f'{p}.2.layer_norm.weight'], eps))
        g = proj(h3, 'wff_in', l)
        x = x + proj(act(gelu_tanh(g[..., :F]) * g[..., F:]), 'wff_out', l)
    h = act(rms(x, w['decoder.final_layer_norm.weight'], eps))
    return proj(h, 'lm')
