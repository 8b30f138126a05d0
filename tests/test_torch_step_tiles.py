"""The step kernel's and the grouped window's order of operations
(csrc/fused_decode.cuh: attend_chunks, the projections' dealing) emulated
plain PyTorch on the CPU and held against the plain version
(ops/fused_decode.py::_cache_attention, the TPU kernel's flash chunks).

A (row, head) pair's cache rows < pos0 are cut into chunks of `chunk`
positions. The kernel spreads the chunks over the blocks of a cluster
(split s takes the s-th run of ceil(nc / splits) chunks; two splits on the
card, any count here). A chunk's running max is the prefix max of the
chunk maxima, M_c = max(M_{c-1}, max_c), and its bf16 p = exp(s - M_c), or
its int8 codes of p vs requantized with the chunk's own max, depend on M_c
alone. So

- the splits exchange only their chunk maxima, and each computes every
  M_c;
- each split attends its own chunks: the bf16 probabilities and the int
  codes are the sequential flash update's, bit for bit;
- the partial sums combine as sum_c vals_c exp(M_c - M_last) (lsum
  likewise): only that f32 order differs from the plain version's.

A control in which each split keeps its own running maxima (no exchange,
the splits combined as flash updates) is another function, and the same
readings must tell it apart. The projections' dealing (4-column units
round robin over the blocks up to 8 rows, 32-column x 8-row tiles above,
a tile's rows one group of the grouped layout) must cover every (row,
column) of every projection exactly once. The emulation lives here, not
in the package."""

import pytest
import torch

from mr_mt3_tpu_torch.ops import fused_decode as fd

TIERS = ('fused_bf16', 'fused', 'fused_int4')
QMAX = {'fused': 127, 'fused_int4': 7}
# the f32 combination's order: lsum and the value sums within this
# relative tolerance of the plain version's (a sum of <= 4 chunk terms
# each ~1e-7 apart; read <= 1.6e-7 over the cases below)
SUM_RTOL = 2e-6


def _chunks_of_split(nc, splits, s):
    """The kernel's chunk runs: split s takes chunks [s per, (s+1) per),
    per = ceil(nc / splits) (two splits: the first ceil(nc / 2))."""
    per = -(-nc // splits)
    return range(min(nc, s * per), min(nc, (s + 1) * per))


def _scores(q, kc, ks, tier):
    if tier == 'fused_bf16':
        return torch.einsum('bhd,hbdp->bhp', fd._bf16r(q), kc)
    return fd._int_scores(q, kc, ks)


def _chunk_probs(s, vs, m, tier):
    """A chunk's probabilities as they enter its value sum, and its sum of
    exp(s - m): bf16 p, or the int8 codes of p vs with their scale."""
    e = torch.exp(s - m[..., None])
    if tier == 'fused_bf16':
        return fd._bf16r(e), None, e.sum(-1)
    pv = e * vs.transpose(0, 1)
    ps = torch.clamp(pv.abs().amax(-1, keepdim=True), min=1e-20) / 127
    return torch.clamp(torch.round(pv / ps), -127, 127), ps, e.sum(-1)


def _chunk_values(p, ps, vc, tier):
    vals = torch.einsum('bhp,hbdp->bhd', p, vc)
    return vals if ps is None else vals * ps


def emulated_chunk_attention(q, kc, vc, ks, vs, tier, chunk, splits,
                             exchange=True):
    """q (B, H, dk) f32 over cache rows kc / vc (H, B, dk, P0) as code
    values (int scales ks / vs (H, B, P0)) in the kernel's order. Returns
    (m, lsum, acc) and each chunk's probabilities (bf16 p or int codes).
    Without exchange each split takes the running max of its own chunks
    only, and the splits combine as flash updates: the control."""
    pos0 = kc.shape[-1]
    nc = -(-pos0 // chunk)
    s = _scores(q, kc, ks, tier)
    cut = [slice(c * chunk, min(pos0, (c + 1) * chunk)) for c in range(nc)]
    cmax = [s[..., c].amax(-1) for c in cut]
    probs, parts = [], []
    for sp in range(splits):
        own = list(_chunks_of_split(nc, splits, sp))
        if not own:
            continue
        run, m_c = None, {}
        for c in (range(nc) if exchange else own):
            run = cmax[c] if run is None else torch.maximum(run, cmax[c])
            m_c[c] = run
        m_last = run
        lsum = acc = None
        for c in own:
            p, ps, lc = _chunk_probs(s[..., cut[c]],
                                     None if ks is None else vs[..., cut[c]],
                                     m_c[c], tier)
            probs.append(p)
            w = torch.exp(m_c[c] - m_last)
            vals = _chunk_values(p, ps, vc[..., cut[c]], tier)
            lsum = lc * w if lsum is None else lsum + lc * w
            acc = vals * w[..., None] if acc is None \
                else acc + vals * w[..., None]
        parts.append((m_last, lsum, acc))
    if exchange:                          # one M_last: add in split order
        m = parts[0][0]
        return (m, sum(p[1] for p in parts), sum(p[2] for p in parts)), \
            probs
    m, lsum, acc = parts[0]               # the control: flash updates
    for m2, l2, a2 in parts[1:]:
        mn = torch.maximum(m, m2)
        a1, b1 = torch.exp(m - mn), torch.exp(m2 - mn)
        lsum = lsum * a1 + l2 * b1
        acc = acc * a1[..., None] + a2 * b1[..., None]
        m = mn
    return (m, lsum, acc), probs


def reference_chunk_probs(q, kc, ks, vs, tier, chunk):
    """The plain version's chunk probabilities (_cache_attention's loop:
    the running max, then bf16 p or the requantized codes)."""
    s = _scores(q, kc, ks, tier)
    out, m = [], None
    for c0 in range(0, kc.shape[-1], chunk):
        sc = s[..., c0:c0 + chunk]
        m = sc.amax(-1) if m is None else torch.maximum(m, sc.amax(-1))
        out.append(_chunk_probs(sc, None if ks is None
                                else vs[..., c0:c0 + chunk], m, tier)[0])
    return out


def _cache(tier, batch, heads, dk, pos0, seed, peak_first=False):
    """q and a cache of pos0 rows as code values: bf16 N(0, 1), or codes
    uniform in +-qmax with per-position scales 0.5-1.5 / qmax (chip_smoke's
    seeded_cache), q scaled so that the softmax is peaked. peak_first
    turns the first row's key toward q: the first chunk then holds the
    largest score, and every later chunk's running max is the first's; in
    the int modes q is 30x larger, so that the first score stands some 300
    above the others, past the range of exp."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((batch, heads, dk), generator=gen) * 0.6
    shape = (heads, batch, dk, pos0)
    if tier == 'fused_bf16':
        kc, vc = (fd._bf16r(torch.randn(shape, generator=gen))
                  for _ in range(2))
        if peak_first:
            kc[..., 0] = fd._bf16r(q.transpose(0, 1).sign() * 2)
        return q, kc, vc, None, None
    qmax = QMAX[tier]
    kc, vc = (torch.randint(-qmax, qmax + 1, shape, generator=gen).float()
              for _ in range(2))
    if peak_first:
        kc[..., 0] = q.transpose(0, 1).sign() * qmax
        q = q * 30
    ks, vs = ((torch.rand(shape[:2] + shape[3:], generator=gen) + 0.5)
              / qmax for _ in range(2))
    return q * qmax / 4, kc, vc, ks, vs


# (pos0, chunk): 2, 3 and 4 live chunks of 256, a ragged last chunk, and
# chunks shorter than a 16-byte vector (the GPU tests' chunk 8)
CASES = [(512, 256), (700, 256), (1023, 256), (1000, 512), (24, 8)]


@pytest.mark.parametrize('tier', TIERS)
@pytest.mark.parametrize('splits', [2, 4])
@pytest.mark.parametrize('pos0,chunk', CASES)
def test_exchanged_chunk_maxima_keep_the_flash_function(tier, splits, pos0,
                                                        chunk):
    q, kc, vc, ks, vs = _cache(tier, 3, 2, 16, pos0, pos0 + splits)
    (m, lsum, acc), probs = emulated_chunk_attention(
        q, kc, vc, ks, vs, tier, chunk, splits)
    want_probs = reference_chunk_probs(q, kc, ks, vs, tier, chunk)
    assert len(probs) == len(want_probs)
    for got, want in zip(probs, want_probs):
        assert torch.equal(got, want)      # bf16 p or int codes, bit for bit
    m_ref, l_ref, a_ref = fd._cache_attention(q, kc, vc, ks, vs, chunk,
                                              tier == 'fused_bf16')
    assert torch.equal(m, m_ref)
    torch.testing.assert_close(lsum, l_ref, rtol=SUM_RTOL, atol=0)
    scale = a_ref.abs().amax()
    assert float((acc - a_ref).abs().max() / scale) <= SUM_RTOL


@pytest.mark.parametrize('tier', TIERS)
@pytest.mark.parametrize('splits', [2, 4])
@pytest.mark.parametrize('pos0,chunk', CASES)
def test_per_block_maxima_are_caught(tier, splits, pos0, chunk):
    """The control (each split its own running maxima, no exchange) breaks
    the bit-for-bit probabilities or the sums' tolerance wherever a later
    split's chunk has a running max below an earlier split's: here every
    later one's, the first row's key turned toward q. bf16 rounds p =
    exp(s - m) with the wrong m. The int codes of p vs are invariant to the
    max subtracted (p vs and its chunk's max |p vs| scale together), so in
    the int modes the control is the function up to f32 rounding except
    where exp runs out of range: the function's later chunks, ~300 below
    the first's max, underflow to zero codes, the control's do not."""
    q, kc, vc, ks, vs = _cache(tier, 3, 2, 16, pos0, pos0 + splits,
                               peak_first=True)
    (_, lsum, acc), probs = emulated_chunk_attention(
        q, kc, vc, ks, vs, tier, chunk, splits, exchange=False)
    want_probs = reference_chunk_probs(q, kc, ks, vs, tier, chunk)
    m_ref, l_ref, a_ref = fd._cache_attention(q, kc, vc, ks, vs, chunk,
                                              tier == 'fused_bf16')
    equal_probs = all(torch.equal(g, w) for g, w in zip(probs, want_probs))
    sums_close = bool(((lsum - l_ref).abs() <= SUM_RTOL * l_ref.abs()).all()
                      ) and float((acc - a_ref).abs().max()
                                  / a_ref.abs().amax()) <= SUM_RTOL
    assert not (equal_probs and sums_close)


# ---- the projections' dealing ------------------------------------------

UNIT, ROWS, TILE_N, MAX_SUB = 4, 8, 32, 4   # csrc: UNIT, ROWS, TILE_N, MAX_SUB


def _subunits(units, paired, blk, grid):
    """fused_decode.cuh::proj_subunits: units blk, blk + grid, ... (a pair
    of sub-units each in FFIN)."""
    n = (units - blk + grid - 1) // grid if blk < units else 0
    return 2 * n if paired else n


def _sub_col0(paired, blk, grid, i, d_ff):
    """fused_decode.cuh::sub_col0: the first column of sub-unit i."""
    if paired:
        return UNIT * (blk + (i // 2) * grid) + (i % 2) * d_ff
    return UNIT * (blk + i * grid)


# (name, columns N, paired): MT3's projections at full width
PROJECTIONS = [('qkv', 3 * 384, False), ('wo', 512, False),
               ('wqc', 384, False), ('woc', 512, False),
               ('ff_in', 2 * 1024, True), ('ff_out', 512, False),
               ('lm', 1536, False)]


@pytest.mark.parametrize('batch', [1, 8, 16, 64])
@pytest.mark.parametrize('name,n,paired', PROJECTIONS)
def test_projections_cover_each_row_and_column_once(batch, name, n, paired):
    """Up to 8 rows fw_project deals 4-column units round robin over the
    132 blocks (at most MAX_SUB a block), every block holding every row;
    above 8 rows the step and the grouped window deal matvec_phase's
    32-column x 8-row tiles (grouped: a tile's rows are one group) over
    the blocks. Either way every (row, column) of every projection is
    computed exactly once."""
    grid, d_ff = 132, 1024
    seen = torch.zeros((batch, n), dtype=torch.int32)
    if batch <= ROWS:
        units = (n // 2 if paired else n) // UNIT
        for blk in range(grid):
            nsub = _subunits(units, paired, blk, grid)
            assert nsub <= MAX_SUB
            for i in range(nsub):
                c0 = _sub_col0(paired, blk, grid, i, d_ff)
                seen[:, c0:c0 + UNIT] += 1
    else:
        ntile = -(-n // TILE_N)
        items = ntile * -(-batch // ROWS)
        for blk in range(grid):
            for item in range(blk, items, grid):
                grp, n0 = item // ntile, (item % ntile) * TILE_N
                seen[grp * ROWS:(grp + 1) * ROWS, n0:n0 + TILE_N] += 1
    assert int(seen.min()) == 1 and int(seen.max()) == 1
