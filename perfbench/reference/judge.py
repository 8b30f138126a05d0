"""The comparison that decides `correct`: the reference's logits over the
served tokens of a sample of segments, and the widest gap by which a
served token's logit lies below the reference's best at its step.

The control, computed here too, is the reference one precision step below
what the configuration states: its matmuls in TF32 where the model is
float32, its model-dtype activations in fp8 where the model is bfloat16,
the window tier's bf16 roundings in fp8 and its int8 quantization of q
and the probabilities at int4. Its reading is the gap, under the
reference's logits, of the token the control puts first.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from perfbench.reference import frontend, model, tier


def _numerics(config: dict, control: bool):
    """(the model dtype's rounding, TF32 on, the window tier's rounding,
    qmax of q and the probabilities) of the reference or its control."""
    bf16 = config['dtype'] == 'bfloat16'
    if not control:
        return (tier.bf16r if bf16 else model.identity), False, \
            tier.bf16r, 127
    if bf16:
        return tier.fp8r, False, tier.fp8r, 7
    return model.identity, True, tier.fp8r, 7


def _served_mask(targets: torch.Tensor, eos: int) -> torch.Tensor:
    """Steps whose served token counts: up to and including the first
    EOS of the row."""
    after = torch.cumsum((targets == eos).int(), dim=-1)
    return (after == 0) | ((after == 1) & (targets == eos))


@torch.no_grad()
def logits(config: dict, w, packed, segs: List[dict], device,
           control: bool = False) -> torch.Tensor:
    """Teacher-forced logits (B, T, vocab) of a block of segments, each a
    dict of 'samples' (FRAMES * HOP,), 'valid', 'tokens' (max_length + 1,)
    and, for the segment-memory model, 'memory' (max_length,)."""
    sizes = config['sizes']
    rnd, use_tf32, act, qmax_act = _numerics(config, control)
    samples = torch.as_tensor(np.stack([s['samples'] for s in segs]),
                              device=device)
    mel = frontend.logmel(samples, [s['valid'] for s in segs])
    with model.tf32(use_tf32):
        enc = model.encode(w, mel, sizes, rnd)
        if sizes.get('segmem_length'):
            mem = torch.as_tensor(np.stack([s['memory'] for s in segs]),
                                  device=device)
            enc = torch.cat([enc, model.memory(w, mem, sizes, rnd)], dim=1)
        enc = rnd(enc)
        tokens = torch.as_tensor(np.stack([s['tokens'] for s in segs]),
                                 device=device)
        T = sizes['max_length']
        pos = rnd(model.sinusoid_table(sizes['d_model'], T).to(device))
        return tier.decode_logits(w, packed, sizes, config['tier'], enc,
                                  tokens[:, :T], pos, act=act,
                                  qmax_act=qmax_act, model_rnd=rnd)


def gaps(ref: torch.Tensor, picked: torch.Tensor) -> torch.Tensor:
    """By how much the reference's logit of each picked token lies below
    the reference's best at its step."""
    return ref.amax(-1) - ref.gather(-1, picked[..., None])[..., 0]


def readings(gap: torch.Tensor, mask: torch.Tensor) -> dict:
    g = gap[mask]
    return {'max_logit_gap': float(g.max()),
            'sum_logit_gap': float(g.sum()),
            'not_first': int((g > 0).sum()), 'steps': int(g.numel())}


def _merge(total: dict, part: dict) -> None:
    for k, v in part.items():
        total[k] = max(total.get(k, v), v) if k.startswith('max') \
            else total.get(k, 0) + v


@torch.no_grad()
def judge(config: dict, seed: int, segs: List[dict], device,
          block: int = 8, control: bool = False) -> dict:
    """The served tokens of `segs` under the reference: the widest gap,
    the mean gap a served step, the share of steps whose served token is
    not the reference's first; with control=True the same of the
    control's first tokens, under 'control_...'."""
    sizes = config['sizes']
    eos = config['eos_token_id']
    w = model.make_weights(sizes, seed, device)
    packed = tier.pack_weights(w, sizes, config['tier'])
    T = sizes['max_length']
    total, low = {}, {}
    for i in range(0, len(segs), block):
        part = segs[i:i + block]
        ref = logits(config, w, packed, part, device)
        served = torch.as_tensor(np.stack([s['tokens'] for s in part]),
                                 device=device)[:, 1:T + 1].long()
        mask = _served_mask(served, eos)
        _merge(total, readings(gaps(ref, served), mask))
        if control:
            pick = logits(config, w, packed, part, device,
                          control=True).argmax(-1)
            _merge(low, readings(gaps(ref, pick), mask))
        del ref
    out = summary(total)
    out['segments'] = len(segs)
    if control:
        out.update({'control_' + k: v for k, v in summary(low).items()
                    if k != 'steps'})
    return out


def summary(total: dict) -> dict:
    steps = max(total.get('steps', 0), 1)
    return {'max_logit_gap': total.get('max_logit_gap', 0.0),
            'mean_logit_gap': total.get('sum_logit_gap', 0.0) / steps,
            'not_first_share': total.get('not_first', 0) / steps,
            'steps': total.get('steps', 0)}
