"""The int8 tiers' kernels as their Hopper designs order the arithmetic
(csrc/int8_decode_attention.cu, csrc/int8_matmul.cu's int8_gated_ff),
emulated in plain PyTorch on the CPU and held against the plain versions
(int8_decode_attention_reference, int8_gated_ff_reference), the JAX
kernels (interpreted) and chip_smoke's INT8_BOUNDS, the bounds the kernels
meet on the card.

- Attention: one block a (row, head) pair; its threads own groups of 16
  positions x a few rows for the integer dots (whose partials add exactly
  in any order), and positions tid, tid + threads, ... for the softmax:
  the max and max |p vs| are exact in any order, the sum of exp(s - max)
  is each thread's positions in order, a shuffle tree over the 32 lanes
  of a warp, then the warps in order. So the codes are the plain
  version's except where that f32 order moves a p vs / ps that lies
  within an ulp of a rounding midpoint: counted here. A control that
  lets each warp keep its own maxima is another function.
- Feed-forward: tasks of 16 columns; each sum over K takes chunks of 64
  k's, each a sequence of fused multiply-adds from zero, the chunks then
  added in order (cuBLAS's order for the plain version's products on the
  card); a and b scaled after their dots, g = bf16(gelu_new(a) * b), then
  the same sums over g. The control leaves g in f32.
- Matmul (the lm_head): tasks of 16 columns x 8 rows (B <= 8) or 16 rows;
  a block owns a row tile and walks its column units, Q groups of 128
  threads summing Q units at once; in a group, half-warp h sums chunks
  h, h + 8, ..., a thread 4 columns x RT / 4 rows of a chunk, each
  chunk's sum a sequence of fused multiply-adds from zero, the chunks
  added in order, then the scale. Every output is one task's; the
  controls are what a bf16 tensor-core product would compute (f32 x
  rounded to bf16) and the product on weights dequantized to bf16.

The emulations live here, not in the package, and this module imports
JAX only inside the tests that call it, so the card's tests can import
the emulations where no JAX is installed."""

import numpy as np
import pytest
import torch

import chip_smoke
from mr_mt3_tpu_torch.models.mt3 import gelu_new
from mr_mt3_tpu_torch.ops import int8_attention as i8a
from mr_mt3_tpu_torch.ops import int8_matmul as i8m
from tests.torch_threads import two_torch_threads  # noqa: F401

# csrc/int8_decode_attention.cu
PG_POS = 16            # positions a position group
MAX_PG = 64            # position groups a pass
MAX_THREADS = 512      # threads a block at most
# csrc/int8_matmul.cu
FF_CHUNK = 64          # k's a chunk of a sum
UNIT = 16              # columns a task
# |p vs / ps| this close to a half-integer is a rounding tie the kernel's
# other f32 sum order may break the other way
TIE = 1e-5


# ---- attention ------------------------------------------------------------

def layout(n, dk):
    """The kernel's thread layout (csrc: layout, threads): position groups
    of a pass (a power of 2, at most MAX_PG), row groups, rows a group,
    threads a block."""
    npg = -(-n // PG_POS)
    pgp = 1
    while pgp < npg and pgp < MAX_PG:
        pgp *= 2
    dg = min(-(-dk // 4), MAX_THREADS // pgp)
    rows = -(-dk // dg)
    return pgp, dg, rows, -(-pgp * dg // 32) * 32


def block_sum(x, threads):
    """Sum of x (..., n) as the kernel's block reduction adds it: thread t
    its positions t, t + threads, ... in order; a butterfly over the 32
    lanes of a warp (lane 0's association); the warps in order."""
    n = x.shape[-1]
    per = -(-n // threads)
    pad = torch.zeros(*x.shape[:-1], per * threads - n)
    v = torch.cat([x, pad], -1).reshape(*x.shape[:-1], per, threads)
    t = v[..., 0, :]
    for j in range(1, per):
        t = t + v[..., j, :]
    w = t.reshape(*x.shape[:-1], threads // 32, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[..., lane ^ o]
    out = w[..., 0, 0]
    for k in range(1, threads // 32):
        out = out + w[..., k, 0]
    return out


def _plain_scores(q, kq, ks, position):
    """The plain version's q codes and scores (int8_decode_attention_
    reference's steps 1-3); the kernel's are the same numbers, its integer
    dots being exact in any order."""
    n = position + 1
    qf = q.float()
    qs = torch.clamp(qf.abs().amax(-1, keepdim=True), min=1e-12) / 127
    qi = torch.clamp(torch.round(qf / qs), -127, 127)
    s = torch.einsum('bhd,bhdk->bhk', qi.double(),
                     kq[..., :n].double()).float()
    return s * qs * ks[:, :, 0, :n]


def reference_codes(q, kq, ks, vq, vs, position):
    """The plain version's requantized probabilities and p vs / ps, and its
    output rebuilt from them (asserted equal to int8_decode_attention_
    reference's)."""
    n = position + 1
    s = _plain_scores(q, kq, ks, position)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    pv = e / e.sum(-1, keepdim=True) * vs[:, :, 0, :n]
    ps = torch.clamp(pv.abs().amax(-1, keepdim=True), min=1e-20) / 127
    pi = torch.clamp(torch.round(pv / ps), -127, 127)
    out = torch.einsum('bhk,bhdk->bhd', pi.double(),
                       vq[..., :n].double()).float() * ps
    return pi, pv / ps, out.reshape(q.shape[0], -1).to(q.dtype)


def emulated_attention(q, kq, ks, vq, vs, position, own_max=False):
    """The kernel's arithmetic: exact integer scores, the block's max, its
    sum of exp(s - max) in block_sum's order, max |p vs|, the codes and
    exact int32 value sums. With own_max each warp's positions keep their
    own max and max |p vs| (the control). Returns the output (B, H * dk)
    in q's dtype, the codes (B, H, n) and the int32 sums (B, H, dk) as
    f64."""
    n = position + 1
    threads = layout(n, q.shape[-1])[3]
    s = _plain_scores(q, kq, ks, position)
    if own_max:     # positions of warp w: p % threads in [32 w, 32 w + 32)
        warp = (torch.arange(n) % threads) // 32
        m = torch.stack([torch.where(warp == w, s, -torch.inf).amax(-1)
                         for w in range(threads // 32)], -1)
        m = m[..., warp]
    else:
        m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    pv = e / block_sum(e, threads)[..., None] * vs[:, :, 0, :n]
    if own_max:
        pm = torch.stack([torch.where(warp == w, pv.abs(), 0).amax(-1)
                          for w in range(threads // 32)], -1)[..., warp]
    else:
        pm = pv.abs().amax(-1, keepdim=True)
    ps = torch.clamp(pm, min=1e-20) / 127
    codes = torch.clamp(torch.round(pv / ps), -127, 127)
    acc = torch.einsum('bhk,bhdk->bhd', codes.double(),
                       vq[..., :n].double())
    if own_max:
        out = torch.einsum('bhk,bhdk->bhd', (codes * ps).double(),
                           vq[..., :n].double()).float()
    else:
        out = acc.float() * ps
    return out.reshape(q.shape[0], -1).to(q.dtype), codes, acc


def _attention_inputs(seed, batch, heads, dk, k_len, dtype):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(batch, heads, dk)).astype(
        np.float32)).to(getattr(torch, dtype))
    kv = [torch.from_numpy(rng.normal(size=(batch, heads, dk, k_len))
                           .astype(np.float32)) for _ in range(2)]
    (kq, ks), (vq, vs) = (i8a.quantize_kv_rows(t) for t in kv)
    return q, kq, ks, vq, vs


ATTN_POSITIONS = [0, 31, 255, 319, 700, 1023]   # 700: a ragged last pass


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('heads,dk', [(3, 64), (4, 24), (2, 128)])
@pytest.mark.parametrize('position', ATTN_POSITIONS)
def test_kernel_order_keeps_the_codes(position, heads, dk, dtype):
    """B 2 over a 1024 cache: the emulated kernel's codes equal the plain
    version's except at counted ties (|p vs / ps| within TIE of a
    half-integer), its int32 value sums equal the plain integer dot of
    those codes, and its output meets INT8_BOUNDS against the plain
    version's."""
    args = _attention_inputs(dk * 7 + position, 2, heads, dk, 1024, dtype)
    pi, ratio, rebuilt = reference_codes(*args, position)
    want = i8a.int8_decode_attention_reference(*args, position)
    assert torch.equal(rebuilt, want)
    got, codes, acc = emulated_attention(*args, position)
    n = position + 1
    moved = codes != pi
    frac = ratio.abs() - torch.floor(ratio.abs())
    ties = (frac - 0.5).abs() < TIE
    print(f'position {position} dk {dk} {dtype}: {int(moved.sum())} codes '
          f'moved, {int((moved & ties).sum())} at ties')
    assert not bool((moved & ~ties).any())
    assert float((codes - pi).abs().max()) <= 1
    assert torch.equal(acc, torch.einsum('bhk,bhdk->bhd', codes.double(),
                                         args[3][..., :n].double()))
    readings = chip_smoke.output_readings(torch, got, want, dk)
    assert not chip_smoke.int8_violations('int8_decode_attention', dtype,
                                          readings), readings


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('position', [31, 255, 1023])
def test_controls_are_caught(position, dtype):
    """INT8_BOUNDS tell the emulated kernel from int8_attention_control
    (p vs in f32, not requantized) at every position > 0, as chip_smoke
    asks of the kernel; and where the positions span more than one warp,
    per-warp maxima move codes and the output by more than 1e-3 of its
    largest value."""
    args = _attention_inputs(position, 2, 6, 64, 1024, dtype)
    got, codes, _ = emulated_attention(*args, position)
    ctrl = chip_smoke.int8_attention_control(torch, *args, position)
    readings = chip_smoke.output_readings(torch, got, ctrl, 64)
    assert chip_smoke.int8_violations('int8_decode_attention', dtype,
                                      readings), readings
    if position + 1 > 32:
        own_out, own, _ = emulated_attention(*args, position, own_max=True)
        want = i8a.int8_decode_attention_reference(*args, position)
        moved = float((own_out.float() - want.float()).abs().max()
                      / want.float().abs().max())
        print(f'position {position} {dtype}: own maxima move '
              f'{float((own != codes).float().mean()):.4f} of the codes, '
              f'the output {moved:.3g}')
        assert bool((own != codes).any()) and moved > 1e-3


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_kernel_order_meets_jax(seed, dtype):
    """The emulated kernel against the JAX kernel (interpreted) at
    tests/test_torch_int8_decode.py's sizes and tolerances."""
    from mr_mt3_tpu.ops.int8_attention import (
        int8_decode_attention as jax_attention,
    )
    from mr_mt3_tpu.ops.int8_attention import (
        quantize_kv_rows as jax_quantize_kv,
    )
    from tests.test_torch_int8_decode import (ATTN_CASES, WIDTHS, _agree,
                                              _inputs)
    for width, (*_, heads, dk) in WIDTHS.items():
        k_len, position = ATTN_CASES[width]
        (qj, kj, vj), (qt, _, _) = _inputs(
            seed, dtype, (2, heads, dk), (2, heads, dk, k_len),
            (2, heads, dk, k_len))
        (kq, ks), (vq, vs) = jax_quantize_kv(kj), jax_quantize_kv(vj)
        want = jax_attention(qj, kq, ks, vq, vs, position, interpret=True)
        got, _, _ = emulated_attention(
            qt, *[torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs)],
            position)
        _agree(f'kernel order {width} seed {seed} {dtype}', got, want,
               dtype, 'attention')


@pytest.mark.parametrize('n,dk,want', [
    (1, 64, (1, 16, 4, 32)), (32, 64, (2, 16, 4, 32)),
    (256, 64, (16, 16, 4, 256)), (320, 64, (32, 16, 4, 512)),
    (1024, 64, (64, 8, 8, 512)), (1024, 24, (64, 6, 4, 384)),
    (1024, 128, (64, 8, 16, 512)), (4096, 64, (64, 8, 8, 512)),
    (12, 8, (1, 2, 4, 32)), (201, 128, (16, 32, 4, 512))])
def test_layout(n, dk, want):
    """The thread layouts of the main path's shapes and the GPU tests':
    every row in one row group, every position group in a pass, at most
    512 threads and 16 rows a thread."""
    pgp, dg, rows, threads = layout(n, dk)
    assert (pgp, dg, rows, threads) == want
    assert dg * rows >= dk and threads <= MAX_THREADS and rows <= 16
    assert pgp >= min(-(-n // PG_POS), MAX_PG)


# ---- feed-forward ---------------------------------------------------------

def chunk_dot(x, w):
    """x (B, K) f32 @ w (K, N) codes as the kernel sums a task: chunks of
    FF_CHUNK k's, each a sequence of fused multiply-adds from zero (f64
    product and sum, one rounding each), the chunks then added in order."""
    xd, wd = x.double(), w.double()
    out = None
    for c0 in range(0, x.shape[1], FF_CHUNK):
        acc = torch.zeros(x.shape[0], w.shape[1])
        for k in range(c0, min(x.shape[1], c0 + FF_CHUNK)):
            acc = (acc.double() + xd[:, k:k + 1] * wd[k]).float()
        out = acc if out is None else out + acc
    return out


def tasks_dot(x, w):
    """chunk_dot over the kernel's tasks of UNIT columns: a column's sum
    does not depend on which task holds it, so all columns at once."""
    return chunk_dot(x, w)


def emulated_gated_ff(h, w0, s0, w1, s1, wo, so, round_g=True):
    """The kernel's feed-forward: a and b of each task, scaled after the
    dot, g rounded to bf16 (round_g=False: the control), then the
    down-projection's tasks over g. Returns (out in h's dtype, g f32)."""
    hf = h.float()
    a = tasks_dot(hf, w0.float()) * s0
    b = tasks_dot(hf, w1.float()) * s1
    g = gelu_new(a) * b
    if round_g:
        g = g.to(torch.bfloat16).float()
    return (tasks_dot(g, wo.float()) * so).to(h.dtype), g


def _plain_g(h, w0, s0, w1, s1):
    hf = h.float()
    return (gelu_new((hf @ w0.float()) * s0) * ((hf @ w1.float()) * s1)
            ).to(torch.bfloat16).float()


def _ff_inputs(seed, batch, d, f, dtype):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.normal(size=(batch, d)).astype(np.float32))
    weights = []
    for k, n in ((d, f), (d, f), (f, d)):
        codes, scale = i8m.quantize_columns(torch.from_numpy(
            (rng.normal(size=(k, n)) * 0.05).astype(np.float32)))
        weights += [codes, scale[None]]
    return (h.to(getattr(torch, dtype)), *weights)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('batch,d,f', [(8, 512, 1024), (3, 96, 192),
                                       (13, 64, 100)])
def test_gated_ff_tasks_meet_the_plain_version(batch, d, f, dtype):
    """The full width (B 8), the parity widths and ragged sizes (13 rows,
    100 columns): the emulation's g equals the plain version's except at
    bf16 rounding ties (at most 0.5%), and its output meets INT8_BOUNDS
    against int8_gated_ff_reference's; the control (g in f32) moves most
    g and breaks INT8_BOUNDS in bf16 (in f32 only narrowly, rel_err
    1.5e-3 to 2.8e-3 against 1.5e-3 here: the bound was set wide for a
    tie's move, so g is what tells it apart there)."""
    args = _ff_inputs(batch + d + f, batch, d, f, dtype)
    got, g = emulated_gated_ff(*args)
    want = i8m.int8_gated_ff_reference(*args)
    plain_g = _plain_g(*args[:5])
    unequal = float((g != plain_g).float().mean())
    readings = chip_smoke.output_readings(torch, got, want)
    print(f'B {batch} {d}/{f} {dtype}: g unequal {unequal:.4f}, {readings}')
    assert unequal <= 0.005
    assert not chip_smoke.int8_violations('int8_gated_ff', dtype, readings)
    ctrl, g_ctrl = emulated_gated_ff(*args, round_g=False)
    assert float((g_ctrl != plain_g).float().mean()) > 0.9
    if dtype == 'bfloat16':
        caught = chip_smoke.int8_violations(
            'int8_gated_ff', dtype, chip_smoke.output_readings(
                torch, got, ctrl))
        assert caught


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_gated_ff_tasks_meet_jax(seed, dtype):
    """The emulation against the JAX kernel (interpreted) at
    tests/test_torch_int8_decode.py's sizes and tolerances."""
    from mr_mt3_tpu.ops.int8_matmul import int8_gated_ff as jax_gated_ff
    from tests.test_torch_int8_decode import (WIDTHS, _agree, _inputs,
                                              _quantized)
    for width, (d, _, f, *_) in WIDTHS.items():
        (hj,), (ht,) = _inputs(seed, dtype, (3, d))
        jq, tq = _quantized(seed, (d, f), (d, f), (f, d), scale=0.2)
        want = jax_gated_ff(hj, *[a for pair in jq for a in pair],
                            interpret=True)
        got, _ = emulated_gated_ff(ht, *[a for pair in tq for a in pair])
        _agree(f'gated_ff tasks {width} seed {seed} {dtype}', got, want,
               dtype, 'gated_ff')


# ---- matmul ---------------------------------------------------------------
# csrc/int8_matmul.cu, int8_matmul
MM_THREADS = 128       # threads a group: 8 half-warps
MM_CHUNK = 64          # k's a chunk
MM_SKEW = 16           # elements after each chunk of a row of x
SMS = 132              # the H100's SMs
SMEM_OPTIN = 232448    # bytes of shared memory a block can opt into (H100)


def mm_rows(batch):
    """Rows a tile (csrc: mm_rows, RT = 4 R): 8 up to 8 rows, else 16."""
    return 8 if batch <= 8 else 16


def mm_grid(batch, n, k, elt, sms=SMS):
    """csrc: mm_grid: (blocks, groups of MM_THREADS a block)."""
    tiles, units = -(-batch // mm_rows(batch)), -(-n // UNIT)
    grid = tiles * units if tiles * units <= sms else \
        tiles if tiles >= sms else sms // tiles * tiles
    q = min(4, -(-units // (grid // tiles)))
    while q > 1 and mm_smem(mm_rows(batch), k, elt, q) > SMEM_OPTIN:
        q -= 1
    return grid, q


def mm_tasks(batch, n, k=512, elt=4):
    """(block, group, round, first row, column unit) of every task the
    kernel's blocks walk: block b owns row tile b % tiles and the units
    b // tiles + i * stride, group q the i = m Q + q of round m."""
    rt = mm_rows(batch)
    tiles, units = -(-batch // rt), -(-n // UNIT)
    grid, q_n = mm_grid(batch, n, k, elt)
    stride = grid // tiles
    tasks = []
    for b in range(grid):
        for m in range(-(-units // stride)):
            for q in range(q_n):
                u = b // tiles + (m * q_n + q) * stride
                if u < units:
                    tasks.append((b, q, m, b % tiles * rt, u))
    return tasks


def mm_ld(k, elt):
    """Elements between rows of x in shared memory (csrc: mm_ld)."""
    span = 32 if elt == 4 else 64
    return -(-(-(-k // MM_CHUNK) * (MM_CHUNK + MM_SKEW)) // span) * span \
        + 16 // elt


def mm_smem(rt, k, elt, q):
    """Bytes of shared memory a block takes (csrc: mm_smem)."""
    chunks = -(-k // MM_CHUNK)
    return elt * rt * mm_ld(k, elt) + 2 * q * (k + chunks) * UNIT \
        + 4 * q * chunks * rt * UNIT


def mm_thread_sums(t, rt, k):
    """The (chunk, row, column) sums of a unit that thread t of a group
    computes."""
    j, rg, r = t & 3, (t >> 2) & 3, rt // 4
    return [(c, rg + 4 * i, 4 * j + cc)
            for c in range(t >> 4, -(-k // MM_CHUNK), MM_THREADS // 16)
            for i in range(r) for cc in range(4)]


def emulated_int8_matmul(x, w, s):
    """The kernel's int8_matmul: every output written by exactly one task
    (mm_tasks), its sum in chunk_dot's order (a column's sum does not
    depend on the task that holds it), then its column scale; x's
    dtype."""
    b, n = x.shape[0], w.shape[1]
    rt = mm_rows(b)
    sums = chunk_dot(x.float(), w.float())
    out = torch.full((b, n), float('nan'))
    written = torch.zeros((b, n), dtype=torch.int32)
    for *_, r0, u in mm_tasks(b, n, x.shape[1], x.element_size()):
        rows, cols = slice(r0, min(b, r0 + rt)), slice(UNIT * u,
                                                       UNIT * u + UNIT)
        out[rows, cols] = sums[rows, cols] * s[0, cols]
        written[rows, cols] += 1
    assert bool((written == 1).all())
    return out.to(x.dtype)


def _mm_inputs(seed, batch, k, n, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(batch, k)).astype(np.float32))
    codes, scale = i8m.quantize_columns(torch.from_numpy(
        (rng.normal(size=(k, n)) * 0.05).astype(np.float32)))
    return x.to(getattr(torch, dtype)), codes, scale[None]


def _bf16_violations(kernel, got, args, plain):
    """chip_smoke's tie-aware INT8_BOUNDS check of a bf16 output."""
    want = plain(*args)
    readings = chip_smoke.output_readings(torch, got, want)
    readings.update(chip_smoke.bf16_tie_readings(
        torch, got, want, plain(args[0].float(), *args[1:]), None,
        chip_smoke.TIE_MOVEMENT[kernel](torch, *args)))
    return chip_smoke.int8_bf16_violations(kernel, readings), readings


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('batch,k,n', [(8, 512, 1536), (64, 512, 1536),
                                       (1, 96, 132), (9, 64, 132),
                                       (17, 100, 52)])
def test_int8_matmul_tasks_meet_the_plain_version(batch, k, n, dtype):
    """The lm_head's width (B 8 and 64) and ragged sizes (B 1 / 9 / 17, N
    a multiple of 4 but not of 16, a K with a short last chunk): the
    emulation meets INT8_BOUNDS against int8_matmul_reference (in bf16
    through the tie-aware check, as on the card), and both controls are
    caught: chip_smoke.int8_matmul_control's x rounded to bf16 (f32) and
    product on bf16-dequantized weights (bf16)."""
    args = _mm_inputs(batch * k + n, batch, k, n, dtype)
    got = emulated_int8_matmul(*args)
    if dtype == 'float32':
        readings = chip_smoke.output_readings(
            torch, got, i8m.int8_matmul_reference(*args))
        bad = chip_smoke.int8_violations('int8_matmul', dtype, readings)
    else:
        bad, readings = _bf16_violations('int8_matmul', got, args,
                                         i8m.int8_matmul_reference)
    ctrl = chip_smoke.output_readings(
        torch, got, chip_smoke.int8_matmul_control(torch, *args))
    caught = chip_smoke.int8_violations('int8_matmul', dtype, ctrl)
    print(f'B {batch} {k} x {n} {dtype}: {readings}; control {ctrl}')
    assert not bad, readings
    assert caught, ctrl


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_int8_matmul_tasks_meet_jax(seed, dtype):
    """The emulation against the JAX kernel (interpreted, as
    tests/test_torch_int8_decode.py runs it) at its sizes and tolerances."""
    from mr_mt3_tpu.ops.int8_matmul import int8_matmul as jax_matmul
    from tests.test_torch_int8_decode import (WIDTHS, _agree, _inputs,
                                              _quantized)
    for width, (d, vocab, *_) in WIDTHS.items():
        (xj,), (xt,) = _inputs(seed, dtype, (3, d))
        [(wq, s)], [(wt, st)] = _quantized(seed, (d, vocab), scale=0.05)
        want = jax_matmul(xj, wq, s, interpret=True)
        _agree(f'int8_matmul tasks {width} seed {seed} {dtype}',
               emulated_int8_matmul(xt, wt, st), want, dtype, 'matmul')


@pytest.mark.parametrize('batch,k', [(8, 512), (64, 512), (1, 96),
                                     (17, 100), (3, 33), (200, 512)])
def test_int8_matmul_thread_layout(batch, k):
    """Every (chunk, row, column) sum of a unit is one thread's; the two
    half-warps of a warp (chunks c, c + 1) and the four row groups of a
    half-warp read x from other banks, in f32 (4-byte loads of 16 bytes, a
    quarter-warp at a time) and in bf16 (8 bytes, a half-warp at a time);
    every x copy lands 16-byte aligned; the lm_head's grids (B 8: 96
    blocks of one group; B 64: 132 blocks of 3 groups, one round) and a
    block's shared memory fit the card."""
    rt = mm_rows(batch)
    owned = [s for t in range(MM_THREADS) for s in mm_thread_sums(t, rt, k)]
    chunks = -(-k // MM_CHUNK)
    assert len(owned) == len(set(owned)) == chunks * rt * UNIT
    for elt in (4, 2):
        ld = mm_ld(k, elt)
        assert ld >= chunks * (MM_CHUNK + MM_SKEW)
        assert ld * elt % 128 == 16 and MM_SKEW * elt % 16 == 0
        words = 4 * elt // 4               # 4-byte banks a row's load takes
        for c in range(0, chunks - 1, 2):
            pair = (c, c + 1) if elt == 4 else (c,)   # f32: a warp's two
            banks = [((rg * ld + cc * (MM_CHUNK + MM_SKEW)) * elt // 4 + e)
                     % 32 for cc in pair for rg in range(4)
                     for e in range(words)]
            assert len(set(banks)) == len(banks)
        assert mm_smem(rt, k, elt, mm_grid(batch, 1536, k, elt)[1]) \
            <= SMEM_OPTIN
    grid, q = mm_grid(batch, 1536, k, 4)
    if (batch, k) == (8, 512):
        assert (grid, q) == (96, 1)
    if (batch, k) == (64, 512):
        assert (grid, q) == (132, 3)
        assert max(m for *_, m, _, _ in mm_tasks(batch, 1536)) == 0
