"""The window kernel's split attention (csrc/fused_decode.cuh,
attend_split) emulated in plain PyTorch on the CPU and held against the
plain version's one-chunk attention (ops/fused_decode.py::_cache_attention,
the function): a (row, head) pair's cache rows < pos0 are cut into ranges
of whole 16-byte vectors (8 bf16, 16 int8 or 32 int4 positions), two in
the kernel, one on each block of a cluster of two (the emulation takes any
count, which the function does not depend on), and

- the splits agree on the chunk's score max m (an exchange) before
  p = exp(s - m) is rounded to bf16 or multiplied by the position scales;
- in the int modes they also agree on the chunk's max |p vs| before
  p vs is requantized to int8 codes;
- each split's lsum and value sums (int32 in the int modes, f32 in bf16)
  are combined in split order.

So the bf16 probabilities and the int codes and int32 sums are the plain
version's, bit for bit; only lsum's and the bf16 value sums' f32 order
differs. A control that lets each split keep its own maxima (a flash
update per split) is another function, and the readings here must tell it
apart. Cross-attention splits the encoder rows the same way and also
adds the two splits' sums of exp(s - m) before it normalizes p, which
moves a probability on a rounding tie at most. The emulation lives here,
not in the package."""

import numpy as np
import pytest
import torch

import chip_smoke
from mr_mt3_tpu_torch.ops import fused_decode as fd

VEC = {'fused_bf16': 8, 'fused': 16, 'fused_int4': 32}   # positions a vector


def _split_ranges(pos0, splits, vec):
    """The kernel's split ranges: ceil(pos0 / splits) rounded up to whole
    vectors; the last ranges may be short or empty."""
    per_split = -(-pos0 // splits)
    r = -(-per_split // vec) * vec
    return [(min(pos0, s * r), min(pos0, (s + 1) * r)) for s in range(splits)]


def _quant(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127)


def emulated_split_attention(q, kc, vc, ks, vs, tier, splits,
                             own_max=False):
    """q (B, H, dk) f32 over cache rows kc / vc (H, B, dk, P0) as code
    values (int scales ks / vs (H, B, P0)). Returns (m, lsum, acc) and the
    probabilities as they enter the value sums: bf16 p (exact tier) or the
    int8 codes with their scale (int tiers), each (B, H, P0). With
    own_max, each split takes its own score max and max |p vs| and the
    splits combine as flash updates: the control."""
    exact = tier == 'fused_bf16'
    pos0 = kc.shape[-1]
    if exact:
        s = torch.einsum('bhd,hbdp->bhp', fd._bf16r(q), kc)
    else:
        s = fd._int_scores(q, kc, ks)
    ranges = [(a, b) for a, b in _split_ranges(pos0, splits, VEC[tier])
              if b > a]
    m_split = [s[..., a:b].amax(-1) for a, b in ranges]
    m_all = torch.stack(m_split).amax(0)
    probs = torch.empty_like(s)
    pv = torch.empty_like(s)
    lsums, accs, ints, pscales = [], [], [], []
    for (a, b), ms in zip(ranges, m_split):
        m = ms if own_max else m_all
        e = torch.exp(s[..., a:b] - m[..., None])
        lsums.append(e.sum(-1))
        if exact:
            probs[..., a:b] = fd._bf16r(e)
            accs.append(torch.einsum('bhp,hbdp->bhd', probs[..., a:b],
                                     vc[..., a:b]))
        else:
            pv[..., a:b] = e * vs.transpose(0, 1)[..., a:b]
    if not exact:
        pmax_split = [pv[..., a:b].abs().amax(-1) for a, b in ranges]
        pmax_all = torch.stack(pmax_split).amax(0)
        for (a, b), pm in zip(ranges, pmax_split):
            ps = torch.clamp(pm if own_max else pmax_all, min=1e-20) / 127
            probs[..., a:b] = _quant(pv[..., a:b], ps[..., None])
            # the int32 value dot: exact integers (f64 holds them)
            ints.append(torch.einsum('bhp,hbdp->bhd',
                                     probs[..., a:b].double(),
                                     vc[..., a:b].double()))
            pscales.append(ps)
    if own_max:                 # flash updates, split after split
        m, lsum, acc = None, None, None
        for i, ms in enumerate(m_split):
            part = accs[i] if exact else \
                ints[i].float() * pscales[i][..., None]
            if m is None:
                m, lsum, acc = ms, lsums[i], part
                continue
            m_new = torch.maximum(m, ms)
            a_old, a_new = torch.exp(m - m_new), torch.exp(ms - m_new)
            lsum = lsum * a_old + lsums[i] * a_new
            acc = acc * a_old[..., None] + part * a_new[..., None]
            m = m_new
        return (m, lsum, acc), probs, None
    lsum = torch.stack(lsums).sum(0)
    if exact:
        return (m_all, lsum, torch.stack(accs).sum(0)), probs, None
    total = torch.stack(ints).sum(0)
    return (m_all, lsum, total.float() * pscales[0][..., None]), probs, total


def _cache(tier, batch, heads, dk, pos0, seed):
    """Seeded cache rows as code values (chip_smoke.seeded_cache's
    distributions) and q."""
    gen = torch.Generator().manual_seed(seed)
    shape = (heads, batch, dk, pos0)
    q = torch.randn((batch, heads, dk), generator=gen) * 2
    if tier == 'fused_bf16':
        kc = torch.randn(shape, generator=gen).to(torch.bfloat16).float()
        vc = torch.randn(shape, generator=gen).to(torch.bfloat16).float()
        return q, kc, vc, None, None
    qmax = fd.QMAX[tier]
    kc = torch.randint(-qmax, qmax + 1, shape, generator=gen).float()
    vc = torch.randint(-qmax, qmax + 1, shape, generator=gen).float()
    ks = (torch.rand(shape[:2] + (pos0,), generator=gen) + 0.5) / qmax
    vs = (torch.rand(shape[:2] + (pos0,), generator=gen) + 0.5) / qmax
    return q, kc, vc, ks, vs


def _reference_probs(q, kc, ks, vs, tier):
    """The plain version's probabilities as they enter its value sum (one
    chunk): bf16 p, or the int8 codes, their scale and the int32 sums."""
    if tier == 'fused_bf16':
        s = torch.einsum('bhd,hbdp->bhp', fd._bf16r(q), kc)
        return fd._bf16r(torch.exp(s - s.amax(-1, keepdim=True))), None
    s = fd._int_scores(q, kc, ks)
    pv = torch.exp(s - s.amax(-1, keepdim=True)) * vs.transpose(0, 1)
    ps = torch.clamp(pv.abs().amax(-1, keepdim=True), min=1e-20) / 127
    return _quant(pv, ps), ps


CASES = [(tier, splits, pos0) for tier in ('fused_bf16', 'fused',
                                           'fused_int4')
         for splits, pos0 in ((2, 992), (8, 992), (3, 100), (8, 40))]


@pytest.mark.parametrize('tier,splits,pos0', CASES)
def test_exchanged_maxima_keep_the_one_chunk_function(tier, splits, pos0):
    """B 2, 3 heads of 64 (MT3's head width): the probabilities entering
    the value sums equal the plain version's bit for bit (bf16 p; int
    codes), the int32 value sums equal its integer dot exactly and the int
    output equals _cache_attention's; m equals it; lsum and the bf16
    output within 1e-5 relative (f32 sums in another order: ~sqrt(P0)
    roundings of 2^-24), far inside BOUNDS' kv_rel_err 4e-2."""
    q, kc, vc, ks, vs = _cache(tier, 2, 3, 64, pos0, seed=splits + pos0)
    exact = tier == 'fused_bf16'
    (m, lsum, acc), probs, total = emulated_split_attention(
        q, kc, vc, ks, vs, tier, splits)
    rm, rl, racc = fd._cache_attention(
        q, kc, vc, ks, vs, pos0, exact)
    want_p, ps = _reference_probs(q, kc, ks, vs, tier)
    assert torch.equal(probs, want_p)
    assert torch.equal(m, rm)
    torch.testing.assert_close(lsum, rl, rtol=1e-5, atol=0)
    if exact:
        err = float((acc - racc).abs().max() / racc.abs().max())
        assert err < 1e-5 < chip_smoke.BOUNDS['fused_bf16']['kv_rel_err']
    else:
        want_int = torch.einsum('bhp,hbdp->bhd', want_p.double(),
                                vc.double())
        assert torch.equal(total, want_int)
        assert torch.equal(acc, racc)


@pytest.mark.parametrize('tier,splits,pos0', [c for c in CASES
                                              if c[1] * VEC[c[0]] < c[2]])
def test_per_split_maxima_are_caught(tier, splits, pos0):
    """The control, each split on its own maxima, against the plain
    version, where the emulation above is equal bit for bit: bf16 rounds
    the other splits' p relative to their own max, so a quarter or more of
    them differ (its output moves only ~1e-5 to 3e-4, like the f32
    reordering: p is what tells it apart); the int modes requantize each
    split on its own max |p vs|, so codes differ and the output moves by
    more than 1e-3 of the largest value (the emulation: 0)."""
    q, kc, vc, ks, vs = _cache(tier, 2, 3, 64, pos0, seed=splits + pos0)
    (_, lsum, acc), probs, _ = emulated_split_attention(
        q, kc, vc, ks, vs, tier, splits, own_max=True)
    _, rl, racc = fd._cache_attention(q, kc, vc, ks, vs, pos0,
                                      tier == 'fused_bf16')
    want_p, _ = _reference_probs(q, kc, ks, vs, tier)
    out, ref = acc / lsum[..., None], racc / rl[..., None]
    moved = float((out - ref).abs().max() / ref.abs().max())
    unequal = float((probs != want_p).float().mean())
    print(tier, splits, pos0, 'unequal', unequal, 'moved', moved)
    if tier == 'fused_bf16':
        assert unequal > 0.25
    else:
        assert unequal > 0
        assert moved > 1e-3


@pytest.mark.parametrize('pos0,splits,vec', [(992, 2, 32), (992, 8, 8),
                                             (100, 3, 16), (40, 8, 32),
                                             (1, 8, 8)])
def test_split_ranges_cover_the_rows_once(pos0, splits, vec):
    """Every position < pos0 in exactly one range; each range starts on a
    whole vector, so its 16-byte loads stay aligned."""
    ranges = _split_ranges(pos0, splits, vec)
    covered = np.concatenate([np.arange(a, b) for a, b in ranges])
    assert np.array_equal(covered, np.arange(pos0))
    assert all(a % vec == 0 or a == pos0 for a, _ in ranges)
    assert len(ranges) == splits


def emulated_cross_split(q, ck, cks, cvs, tier):
    """The cross-attention split (attend_split with normalize): two splits
    agree on m, then on lsum = l0 + l1 in split order (and in the int modes
    on max |p vs|) before p = e / lsum is rounded or requantized. Returns
    the probabilities as they enter the value sums (bf16 p, or int codes)."""
    exact = tier == 'fused_bf16'
    lenc = ck.shape[-1]
    s = torch.einsum('bhd,hbdp->bhp', fd._bf16r(q), ck) if exact else \
        fd._int_scores(q, ck, cks)
    ranges = _split_ranges(lenc, 2, VEC[tier])
    e = torch.exp(s - s.amax(-1, keepdim=True))
    lsum = sum(e[..., a:b].sum(-1) for a, b in ranges)
    p = e / lsum[..., None]
    if exact:
        return fd._bf16r(p)
    pv = p * cvs.transpose(0, 1)
    ps = torch.clamp(pv.abs().amax(-1, keepdim=True), min=1e-20) / 127
    return _quant(pv, ps)


@pytest.mark.parametrize('tier', ['fused_bf16', 'fused', 'fused_int4'])
@pytest.mark.parametrize('lenc', [256, 320])
def test_cross_split_sums_in_another_order(tier, lenc):
    """Cross-attention normalizes p by the sum over all positions, which
    the two splits add in split order: lsum may differ from the plain
    version's f32 sum in its last bits, so a probability that sits on a
    rounding tie may round the other way. At most 1% of them move, by one
    bf16 ulp or one int8 step, the class of difference the old kernel's
    block sum had; the max, and so the function, is unchanged."""
    q, ck, _, cks, cvs = _cache(tier, 2, 3, 64, lenc, seed=lenc)
    got = emulated_cross_split(q, ck, cks, cvs, tier)
    exact = tier == 'fused_bf16'
    s = torch.einsum('bhd,hbdp->bhp', fd._bf16r(q), ck) if exact else \
        fd._int_scores(q, ck, cks)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    if exact:
        want = fd._bf16r(p)
        moved = got != want
        assert float((got - want).abs().max()) <= \
            float(want.abs().max()) * 2 ** -8
    else:
        pv = p * cvs.transpose(0, 1)
        ps = torch.clamp(pv.abs().amax(-1, keepdim=True), min=1e-20) / 127
        want = _quant(pv, ps)
        moved = got != want
        assert float((got - want).abs().max()) <= 1
    assert float(moved.float().mean()) <= 0.01
