"""The attention kernels' tile order (csrc/fused_attention_fwd.cu,
csrc/fused_attention_bwd.cu) emulated in plain PyTorch on the CPU and
held against the plain versions (fused_attention_reference,
fused_attention_backward_reference) within chip_smoke's ATTN_BOUNDS and
ATTN_BWD_BOUNDS, the bounds the kernels meet on the card:

- forward: an online row max and sum over 64-key tiles, then a second
  sweep that normalizes each probability before it rounds it to bf16,
  exp(s - m) taken as exp2((s - m) log2(e)) and p as e times 1 / l;
- backward: the dq kernel's merged first sweep (online max, sum and
  u = sum exp(s - m) dp, so delta = u / l), its second sweep
  (ds = p (dp - delta), rounded, times k), and the dk/dv kernel's sums
  over 64-row query tiles from the stored (m, l, delta).

The emulation lives here, not in the package: the package's plain
versions are the function, this is the kernels' order of operations.
chip_smoke's forward control, which divides by the row sum after the
value product (p rounded before it is normalized), must break
ATTN_BOUNDS here as on the card; its backward control (FlashAttention-2's
rowsum(dO * O) delta) is another function."""

import numpy as np
import pytest
import torch

import chip_smoke
from mr_mt3_tpu_torch.ops import train_attention as ta

TILE = ta._KT      # keys (or query rows) per streamed tile
LOG2E = 1.4426950408889634


def _exp_shifted(s, m):
    """exp(s - m) as the kernels take it: exp2((s - m) log2(e))."""
    return torch.exp2((s - m[..., None]) * LOG2E)


def _masks(lq, cols, kv_valid, causal):
    """(Lq, len(cols)) bool: column visible to row."""
    row = torch.arange(lq)[:, None]
    keep = (cols < kv_valid)[None, :].expand(lq, len(cols))
    return keep & (cols[None, :] <= row) if causal else keep


def _scores(a, b):
    """f32 a . b^T per (batch row, head): (B, H, La, Lb)."""
    return torch.einsum('bqhd,bkhd->bhqk', a.float(), b.float())


def _online_stats(q, k, dof, v, causal, kv_valid):
    """Sweep 1 (forward) or AB (dq kernel): per row the running max m,
    sum l and, with dO, u = sum exp(s - m) dp, over 64-key tiles in order;
    f32 (B, H, Lq) each."""
    b, lq, h, _ = q.shape
    m = torch.full((b, h, lq), -float('inf'))
    l, u = torch.zeros(b, h, lq), torch.zeros(b, h, lq)
    for k0 in range(0, kv_valid, TILE):
        cols = torch.arange(k0, k0 + TILE)
        vis = _masks(lq, cols, kv_valid, causal)
        s = _scores(q, k[:, k0:k0 + TILE])
        mnew = torch.maximum(m, torch.where(vis, s, -float('inf')).amax(-1))
        e = torch.where(vis, _exp_shifted(s, mnew), 0.0)
        scale = torch.where(m == -float('inf'), 0.0,
                            torch.exp2((m - mnew) * LOG2E))
        l = l * scale + e.sum(-1)
        if dof is not None:
            dp = _scores(dof, v[:, k0:k0 + TILE])
            u = u * scale + (e * dp).sum(-1)
        m = mnew
    return m, l, u


def _probabilities(s, m, l, vis):
    """p = exp(s - m) times 1 / l, 0 where masked."""
    return torch.where(vis, _exp_shifted(s, m) * (1 / l)[..., None], 0.0)


def emulated_forward(q, k, v, causal, kv_valid):
    """fused_attention_fwd's order: sweep 1, then p = exp(s - m) / l
    rounded to bf16 and o summed over the 64-key tiles in order."""
    b, lq, h, d = q.shape
    m, l, _ = _online_stats(q, k, None, None, causal, kv_valid)
    o = torch.zeros(b, h, lq, d)
    for k0 in range(0, kv_valid, TILE):
        cols = torch.arange(k0, k0 + TILE)
        vis = _masks(lq, cols, kv_valid, causal)
        s = _scores(q, k[:, k0:k0 + TILE])
        p = _probabilities(s, m, l, vis).to(torch.bfloat16).float()
        o += torch.einsum('bhqk,bkhd->bhqd', p, v[:, k0:k0 + TILE].float())
    return o.transpose(1, 2).to(q.dtype)


def emulated_backward(q, k, v, do, causal, kv_valid):
    """fused_attention_bwd's order: the dq kernel's sweeps AB and C; the
    dk/dv kernel's sums over 64-row query tiles from the stored stats."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    dof = do.float()
    m, l, u = _online_stats(q, k, dof, v, causal, kv_valid)
    delta = u / l
    dq = torch.zeros(b, h, lq, d)
    for k0 in range(0, kv_valid, TILE):
        cols = torch.arange(k0, k0 + TILE)
        vis = _masks(lq, cols, kv_valid, causal)
        s = _scores(q, k[:, k0:k0 + TILE])
        dp = _scores(dof, v[:, k0:k0 + TILE])
        ds = _probabilities(s, m, l, vis) * (dp - delta[..., None])
        dq += torch.einsum('bhqk,bkhd->bhqd', ds.to(torch.bfloat16).float(),
                           k[:, k0:k0 + TILE].float())
    dk, dv = torch.zeros(b, h, lk, d), torch.zeros(b, h, lk, d)
    cols = torch.arange(lk)
    for r0 in range(0, lq, TILE):
        rows = slice(r0, r0 + TILE)
        vis = _masks(lq, cols, kv_valid, causal)[rows]
        s = _scores(q[:, rows], k)
        p = _probabilities(s, m[..., rows], l[..., rows], vis)
        dv += torch.einsum('bhqk,bqhd->bhkd', p.to(torch.bfloat16).float(),
                           dof[:, rows])
        dp = _scores(dof[:, rows], v)
        ds = p * (dp - delta[..., rows, None])
        dk += torch.einsum('bhqk,bqhd->bhkd', ds.to(torch.bfloat16).float(),
                           q[:, rows].float())
    return tuple(g.transpose(1, 2).to(q.dtype) for g in (dq, dk, dv))


def _inputs(seed, b, lq, lk, h, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, n, h, d)).astype(
        np.float32)).to(torch.bfloat16) for n in (lq, lk, lk, lq)]


def _fwd_readings(got, want):
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return {'rel_err': float(diff.max()) / float(want.abs().max()),
            'unequal': float((got != want).float().mean())}


# (Lq, Lk, kv_valid, causal, D): square, a ragged Lq with causal, a padded
# cross length, the parity model's head width 24
CASES = [
    pytest.param(256, 256, 256, False, 64, id='256sq'),
    pytest.param(200, 256, 200, True, 64, id='200_causal_ragged'),
    pytest.param(192, 128, 100, False, 64, id='192x100_padded'),
    pytest.param(256, 256, 256, False, 24, id='256sq_d24'),
]


@pytest.mark.parametrize('lq,lk,kv_valid,causal,d', CASES)
def test_forward_tile_order_within_attn_bounds(lq, lk, kv_valid, causal, d):
    q, k, v, _ = _inputs(lq + d, 2, lq, lk, 2, d)
    want = ta.fused_attention_reference(q, k, v, causal, kv_valid)
    got = _fwd_readings(emulated_forward(q, k, v, causal, kv_valid), want)
    print(f'emulated forward {lq}x{lk} causal {causal} D {d}: {got}')
    assert all(got[key] <= bound
               for key, bound in chip_smoke.ATTN_BOUNDS.items()), got
    control = _fwd_readings(
        chip_smoke.attention_control(torch, q, k, v, causal, kv_valid), want)
    print(f'control (divide after the product): {control}')
    assert any(control[key] > bound
               for key, bound in chip_smoke.ATTN_BOUNDS.items()), control


@pytest.mark.parametrize('lq,lk,kv_valid,causal,d', CASES)
def test_backward_tile_order_within_attn_bwd_bounds(lq, lk, kv_valid, causal,
                                                    d):
    q, k, v, do = _inputs(lq + d + 1, 2, lq, lk, 2, d)
    want = ta.fused_attention_backward_reference(q, k, v, do, causal,
                                                 kv_valid)
    got = emulated_backward(q, k, v, do, causal, kv_valid)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        reading = {'rel_err': float(diff.max()) / float(w.abs().max()),
                   'unequal': float((g != w).float().mean()),
                   'ulp_apart': chip_smoke.bf16_steps_apart(torch, g, w)}
        print(f'emulated backward {lq}x{lk} causal {causal} D {d} {name}: '
              f'{reading}')
        assert all(reading[key] <= bound for key, bound in
                   chip_smoke.ATTN_BWD_BOUNDS.items()), (name, reading)
    assert not got[1][:, kv_valid:].any() and not got[2][:, kv_valid:].any()
    control = chip_smoke.attention_backward_control(torch, q, k, v, do,
                                                    causal, kv_valid)
    assert not torch.equal(control[0], want[0])
    torch.testing.assert_close(control[2], want[2], rtol=0, atol=0)
