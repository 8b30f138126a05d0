"""The CUDA kernels against their plain PyTorch versions on the card:
fused_decode_window and fused_decode_step in their three modes, the
grouped int8 window, fused_attention_fwd, fused_attention_bwd,
int8_matmul, int8_gated_ff, int8_decode_attention and logmel. Imports no JAX, so it runs where the card is:

    python -m pytest tests/test_torch_fused_decode_gpu.py -m gpu -q

Without a card every test here skips (the kernels have no CPU form).
"""

import pytest
import torch

import chip_smoke
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.ops import fused_decode as fd
from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params
from mr_mt3_tpu_torch.ops.int8_matmul import unpack_int4
from mr_mt3_tpu_torch.utils.builders import init_params

pytestmark = pytest.mark.gpu

# the kernel and the plain version sum in different orders: bf16 rows
# may round one ulp apart, and such flips pass on from layer to layer
KV_RTOL = 2e-2
LOGIT_RTOL = 2e-2
# integer modes: a flipped rounding moves a code by one step, and a later
# step that reads the row moves with it
CODE_SHARE = 0.99
CODE_DIFF = 2
SCALE_RTOL = 2e-2

SMALL = MT3Config(vocab_size=256, d_model=32, d_kv=8, d_ff=48, num_heads=4,
                  num_encoder_layers=1, num_decoder_layers=2, mel_bins=16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU form')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _setup(cfg, batch, lenc, cache_len, dev, seed=0, tier='fused_bf16'):
    model = init_params(MT3(cfg), seed=seed).to(dev).eval()
    dp = stack_decode_params(model, quantize=tier)
    gen = torch.Generator().manual_seed(seed + 1)
    enc = torch.randn((batch, lenc, cfg.d_model), generator=gen).to(dev)
    cross = fd.precompute_cross_kv_fused(dp, cfg, enc)
    cache = fd.init_fused_cache(cfg, batch, cache_len, dev, tier)
    tokens = torch.randint(3, cfg.vocab_size, (batch,), generator=gen,
                           dtype=torch.int32).to(dev)
    return dp, cross, cache, tokens


def _window_case(dev, tier, batch, pos0, cache_len):
    """The cache rows < pos0 decoded by the kernel itself, the last row
    finished; returns (cfg, args of one window at pos0)."""
    cfg, T = SMALL, 8
    dp, cross, cache, tokens = _setup(cfg, batch, 8, cache_len, dev,
                                      tier=tier)
    finished = torch.zeros(batch, dtype=torch.bool, device=dev)
    for p in range(0, pos0, T):
        toks_w, finished, cache = fd.fused_decode_window(
            cfg, dp.fused, dp, tokens, finished, p, cache, cross, T)
        tokens = toks_w[:, -1].contiguous()
    finished = finished.clone()
    finished[-1] = True
    pos_rows = fd.window_pos_rows(dp, pos0, T)
    return cfg, (cfg, dp.fused, pos_rows, tokens, finished, pos0, cache,
                 cross, T)


def _agreeing_rows(cfg, toks, w_toks, logits):
    """Rows whose tokens all agree; a row may diverge only where the plain
    version scores the two tokens within 2 x LOGIT_RTOL."""
    agree = (toks == w_toks).all(0)
    for b in torch.nonzero(~agree).flatten().tolist():
        d = int(torch.nonzero(toks[:, b] != w_toks[:, b])[0])
        row = logits[d, b]
        gap = float(row[w_toks[d, b]] - row[toks[d, b]])
        assert gap < 2 * LOGIT_RTOL * float(row.abs().max()), (b, d)
    return agree


@pytest.mark.parametrize('batch,pos0', [(3, 0), (3, 8), (8, 16), (64, 8)])
def test_kernel_matches_plain_version(cuda, batch, pos0):
    _, args = _window_case(cuda, 'fused_bf16', batch, pos0, 32)
    cfg = args[0]
    last = torch.empty((batch, cfg.vocab_size), device=cuda)
    before = fd.LAUNCHES['fused_bf16']
    toks, fin, rows = fd.fused_decode_window_cuda(*args, logits_out=last)
    torch.cuda.synchronize()
    assert fd.LAUNCHES['fused_bf16'] == before + 1
    w_toks, w_fin, w_rows, logits = fd.fused_decode_window_reference(
        *args, return_logits=True)
    assert (toks[:, -1] == cfg.pad_token_id).all()
    agree = _agreeing_rows(cfg, toks, w_toks, logits)
    if agree.all():
        assert torch.equal(fin, w_fin)
        scale = float(logits[-1].abs().max())
        assert float((last - logits[-1]).abs().max()) <= LOGIT_RTOL * scale
        for key in ('kq', 'vq'):
            a, r = rows[key].float(), w_rows[key].float()
            err = float((a - r).abs().max())
            assert err <= KV_RTOL * float(r.abs().max())


@pytest.mark.parametrize('tier', ['fused', 'fused_int4'])
@pytest.mark.parametrize('batch', [1, 8, 64])
@pytest.mark.parametrize('pos0', [0, 32, 992])
def test_int_kernel_matches_plain_version(cuda, tier, batch, pos0):
    """Integer modes: tokens (up to an allowed near-tie divergence), the
    window's codes and per-row scales up to the first divergence, and the
    last-step logits of a window whose tokens all agree."""
    _, args = _window_case(cuda, tier, batch, pos0, 1024)
    cfg = args[0]
    last = torch.empty((batch, cfg.vocab_size), device=cuda)
    before = fd.LAUNCHES[tier]
    toks, fin, rows = fd.fused_decode_window_cuda(*args, logits_out=last)
    torch.cuda.synchronize()
    assert fd.LAUNCHES[tier] == before + 1
    assert set(rows) == {'kq', 'vq', 'ks', 'vs'}
    w_toks, w_fin, w_rows, logits = fd.fused_decode_window_reference(
        *args, return_logits=True)
    assert (toks[:, -1] == cfg.pad_token_id).all()
    agree = _agreeing_rows(cfg, toks, w_toks, logits)
    qmax = fd.QMAX[tier]
    H = cfg.num_heads
    for b in range(batch):
        diff = torch.nonzero(toks[:, b] != w_toks[:, b])
        n = int(diff[0]) + 1 if len(diff) else toks.shape[0]

        def row_b(t):          # (T, L, H*B, ...) -> steps < n of row b
            return t[:n].reshape(n, -1, H, batch, *t.shape[3:])[:, :, :, b]
        for key in ('kq', 'vq'):
            a, r = row_b(rows[key]).int(), row_b(w_rows[key]).int()
            assert int(a.abs().max()) <= qmax
            assert float((a == r).float().mean()) >= CODE_SHARE, (key, b)
            assert int((a - r).abs().max()) <= CODE_DIFF, (key, b)
        for key in ('ks', 'vs'):
            a, r = row_b(rows[key]), row_b(w_rows[key])
            err = float((a - r).abs().max())
            assert err <= SCALE_RTOL * float(r.abs().max()), (key, b)
    if agree.all():
        assert torch.equal(fin, w_fin)
        scale = float(logits[-1].abs().max())
        assert float((last - logits[-1]).abs().max()) <= LOGIT_RTOL * scale


@pytest.mark.parametrize('tier', ['fused_bf16', 'fused', 'fused_int4'])
def test_nan_logits_give_the_vocab_token(cuda, tier):
    """A NaN in lm_head column 7 (in the integer modes its column scale):
    the kernel emits the vocabulary size in every unfinished row, as the
    plain version does, and pad in a finished one; the wrapper raises."""
    cfg, T = SMALL, 8
    dp, cross, cache, tokens = _setup(cfg, 3, 8, 16, cuda, tier=tier)
    if tier == 'fused_bf16':
        dp.fused.lm[:, 7] = float('nan')
    else:
        dp.fused.lm_s[7] = float('nan')
    finished = torch.tensor([False, False, True], device=cuda)
    args = (cfg, dp.fused, fd.window_pos_rows(dp, 0, T), tokens, finished, 0,
            cache, cross, T)
    toks = fd.fused_decode_window_cuda(*args)[0]
    assert torch.equal(toks, fd.fused_decode_window_reference(*args)[0])
    assert (toks[:, :2] == cfg.vocab_size).all()
    assert (toks[:, 2] == cfg.pad_token_id).all()
    with pytest.raises(FloatingPointError, match='NaN'):
        fd.fused_decode_window(cfg, dp.fused, dp, tokens, finished, 0, cache,
                               cross, T)


def test_wrapper_checks_operands(cuda):
    cfg = SMALL
    dp, cross, cache, tokens = _setup(cfg, 3, 8, 16, cuda)
    finished = torch.zeros(3, dtype=torch.bool, device=cuda)
    pos_rows = fd.window_pos_rows(dp, 0, 8)
    bad = dict(cache, kq=cache['kq'].float())
    with pytest.raises(ValueError, match='dtype'):
        fd.fused_decode_window_cuda(cfg, dp.fused, pos_rows, tokens,
                                    finished, 0, bad, cross, 8)
    with pytest.raises(ValueError, match='exceeds'):
        fd.fused_decode_window_cuda(cfg, dp.fused, pos_rows, tokens,
                                    finished, 12, cache, cross, 8)
    with pytest.raises(ValueError, match='is on cpu'):
        fd.fused_decode_window_cuda(cfg, dp.fused, pos_rows.cpu(), tokens,
                                    finished, 0, cache, cross, 8)


def test_int_wrapper_checks_operands(cuda):
    """Integer modes: an odd int4 position, a bf16 cache under int
    weights, a missing scale array, and an unpacked int4 cache raise."""
    cfg = SMALL
    dp, cross, cache, tokens = _setup(cfg, 3, 8, 16, cuda,
                                      tier='fused_int4')
    finished = torch.zeros(3, dtype=torch.bool, device=cuda)
    pos_rows = fd.window_pos_rows(dp, 1, 6)
    with pytest.raises(ValueError, match='even'):
        fd.fused_decode_window_cuda(cfg, dp.fused, pos_rows, tokens,
                                    finished, 1, cache, cross, 6)
    pos_rows = fd.window_pos_rows(dp, 0, 8)
    bf16 = fd.init_fused_cache(cfg, 3, 16, cuda, 'fused_bf16')
    with pytest.raises(ValueError, match='dtype'):
        fd.fused_decode_window_cuda(cfg, dp.fused, pos_rows, tokens,
                                    finished, 0, bf16, cross, 8)
    no_scale = {k: v for k, v in cache.items() if k != 'vs'}
    with pytest.raises(ValueError, match='vs is missing'):
        fd.fused_decode_window_cuda(cfg, dp.fused, pos_rows, tokens,
                                    finished, 0, no_scale, cross, 8)
    unpacked = dict(cache, kq=unpack_int4(cache['kq']).view(torch.uint8))
    with pytest.raises(ValueError, match='shape'):
        fd.fused_decode_window_cuda(cfg, dp.fused, pos_rows, tokens,
                                    finished, 0, unpacked, cross, 8)


# fused_attention_fwd against its plain version: the two sum in other
# orders, so a bf16 output or probability near a rounding midpoint may
# round one ulp apart
ATTN_MAX_UNEQUAL = 2e-3
ATTN_MAX_REL = 2.0 ** -7


# (B, Lq, Lk, H, D, causal, kv_valid, neighbour): neighbour scales head 1
# of every operand by 1e3 (D 24: a 32-wide copy from head 0 would read
# head 1's first 8 columns) and compares the other heads only
ATTN_GPU_CASES = [
    (2, 64, 64, 2, 64, False, None, False),
    (2, 128, 100, 2, 24, False, None, False),
    (1, 96, 96, 3, 64, True, None, False),
    (1, 40, 40, 2, 128, True, None, False),
    (2, 64, 256, 2, 32, False, 200, False),
    (2, 64, 80, 2, 32, False, None, False),
    (1, 48, 48, 2, 16, True, None, False),
    (1, 520, 520, 2, 64, True, None, False),      # ragged Lq
    (1, 128, 4096, 2, 64, False, None, False),    # past the old smem cap
    (2, 136, 136, 3, 24, False, None, True),
]


def _attention_inputs(cuda, b, lq, lk, h, d, neighbour, seed, with_do=False):
    """Unit-normal bf16 q, k, v (and dO), head 1 x 1e3 with neighbour;
    and the heads to compare."""
    gen = torch.Generator().manual_seed(seed)
    scale = torch.ones(h)
    if neighbour:
        scale[1] = 1e3
    out = [(torch.randn((b, n, h, d), generator=gen) * scale[:, None]).to(
        cuda, torch.bfloat16) for n in (lq, lk, lk) + ((lq,) if with_do
                                                       else ())]
    return out, [i for i in range(h) if scale[i] == 1]


@pytest.mark.parametrize('b,lq,lk,h,d,causal,kv_valid,neighbour',
                         ATTN_GPU_CASES)
def test_attention_kernel_matches_plain_version(cuda, b, lq, lk, h, d,
                                                causal, kv_valid, neighbour):
    from mr_mt3_tpu_torch.ops import train_attention as ta
    (q, k, v), heads = _attention_inputs(cuda, b, lq, lk, h, d, neighbour,
                                         lq + lk + d)
    before = ta.LAUNCHES[ta.KERNEL]
    got = ta.fused_attention(q, k, v, causal=causal, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert ta.LAUNCHES[ta.KERNEL] == before + 1
    kp, vp, real = ta._pad_kv(k, v)
    want = ta.fused_attention_reference(q, kp, vp, causal,
                                        kv_valid or real)
    assert got.shape == want.shape
    assert got.dtype == want.dtype == torch.bfloat16
    got, want = got[:, :, heads].float(), want[:, :, heads].float()
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert float((got != want).float().mean()) <= ATTN_MAX_UNEQUAL
    assert err <= ATTN_MAX_REL


def test_attention_wrapper_on_the_card(cuda):
    """A gradient runs the backward kernel; float32 raises (the kernel is
    bf16 only); a long Lk (4096) launches, since shared memory no longer
    grows with Lk; a model at bf16 routes its long attention to the
    kernel."""
    from mr_mt3_tpu_torch.ops import train_attention as ta
    q = torch.randn((1, 16, 2, 16), device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    before = ta.LAUNCHES[ta.KERNEL_BWD]
    ta.fused_attention(q, q, q).sum().backward()
    torch.cuda.synchronize()
    assert ta.LAUNCHES[ta.KERNEL_BWD] == before + 1
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    f32 = torch.zeros((1, 16, 2, 16), device=cuda)
    before = ta.LAUNCHES[ta.KERNEL]
    with pytest.raises(ValueError, match='bfloat16 only'):
        ta.fused_attention(f32, f32, f32)
    assert ta.LAUNCHES[ta.KERNEL] == before
    big = torch.zeros((1, 4096, 2, 16), device=cuda, dtype=torch.bfloat16)
    out = ta.fused_attention(big[:, :16], big, big)
    torch.cuda.synchronize()
    assert ta.LAUNCHES[ta.KERNEL] == before + 1
    assert out.shape == (1, 16, 2, 16) and not out.any()
    cfg = SMALL.replace(dtype='bfloat16', segmem_variant='encoder_append',
                        segmem_length=8)
    model = init_params(MT3(cfg), seed=0).to(cuda).eval()
    before = ta.LAUNCHES[ta.KERNEL]
    with torch.no_grad():
        model(torch.rand((1, 256, cfg.mel_bins), device=cuda),
              torch.zeros((1, 512), dtype=torch.long, device=cuda))
    torch.cuda.synchronize()
    # memory encoder + 2 decoder layers x (causal self, cross)
    assert ta.LAUNCHES[ta.KERNEL] == before + 1 + 2 * 2


# fused_attention_bwd against its plain version: sums in other orders
# round some bf16 outputs one step apart; dq sums ds k, whose terms cancel
# (each row of ds sums to zero), so its f32 noise is large against its
# value and more of its roundings flip: share more than one bf16 step
# apart read 1.49% for dq at D 128, L 40 (run Q, PERF.md), at most 1% for
# dk and dv
ATTN_BWD_MAX_REL = 2.0 ** -6
ATTN_BWD_MAX_ULP_APART = {'q': 4.5e-2, 'k': 1e-2, 'v': 1e-2}


def _bwd_inputs(cuda, b, lq, lk, h, d, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((b, n, h, d), generator=gen).to(cuda, torch.bfloat16)
            for n in (lq, lk, lk, lq)]


@pytest.mark.parametrize('b,lq,lk,h,d,causal,kv_valid,neighbour', [
    (2, 64, 64, 2, 64, False, None, False),
    (2, 128, 100, 2, 24, False, None, False),
    (1, 96, 96, 3, 64, True, None, False),
    (1, 40, 40, 2, 128, True, None, False),
    (2, 64, 256, 2, 32, False, 200, False),
    (1, 48, 48, 2, 16, True, None, False),
    (2, 136, 136, 2, 48, True, None, False),
    (1, 520, 520, 2, 64, True, None, False),      # ragged Lq
    (1, 128, 4096, 2, 64, False, None, False),    # past the old smem cap
    (2, 136, 136, 3, 24, False, None, True),
])
def test_attention_backward_matches_plain_version(cuda, b, lq, lk, h, d,
                                                  causal, kv_valid,
                                                  neighbour):
    """Autograd through fused_attention on the card (the backward kernel,
    the padding's gradient trimmed) against the plain backward on the
    padded K/V, trimmed the same way; rows past kv_valid get zeros. With
    neighbour, head 1 of every operand is 1e3 larger and only the other
    heads are compared."""
    from mr_mt3_tpu_torch.ops import train_attention as ta
    (q, k, v, do), heads = _attention_inputs(cuda, b, lq, lk, h, d,
                                             neighbour, lq + lk + d,
                                             with_do=True)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = ta.LAUNCHES[ta.KERNEL_BWD]
    out = ta.fused_attention(*leaves, causal=causal, kv_valid=kv_valid)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert ta.LAUNCHES[ta.KERNEL_BWD] == before + 1
    kp, vp, real = ta._pad_kv(k, v)
    want = ta.fused_attention_backward_reference(q, kp, vp, do, causal,
                                                 kv_valid or real)
    for name, g, w in zip('qkv', got, want):
        w = w[:, :g.shape[1]]
        assert g.shape == w.shape and g.dtype == torch.bfloat16, name
        g, w = g[:, :, heads].float(), w[:, :, heads].float()
        err = float((g - w).abs().max()) / float(w.abs().max())
        assert err <= ATTN_BWD_MAX_REL, (name, err)
        assert chip_smoke.bf16_steps_apart(torch, g, w) <= \
            ATTN_BWD_MAX_ULP_APART[name], name
    if kv_valid is not None:
        for g in got[1:]:
            assert not g[:, kv_valid:].any()


def test_attention_backward_is_deterministic(cuda):
    """No atomics: the same inputs give the same bits twice."""
    from mr_mt3_tpu_torch.ops import train_attention as ta
    q, k, v, do = _bwd_inputs(cuda, 2, 256, 256, 3, 64, 7)
    for causal in (False, True):
        a = ta.fused_attention_backward_cuda(q, k, v, do, causal, 256)
        b = ta.fused_attention_backward_cuda(q, k, v, do, causal, 256)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_attention_backward_wrapper_checks_operands(cuda):
    from mr_mt3_tpu_torch.ops import train_attention as ta
    q, k, v, do = _bwd_inputs(cuda, 1, 32, 128, 2, 16, 0)
    before = ta.LAUNCHES[ta.KERNEL_BWD]
    with pytest.raises(ValueError, match='bfloat16 only'):
        ta.fused_attention_backward_cuda(q.float(), k, v, do, False, 128)
    with pytest.raises(ValueError, match='padded'):
        ta.fused_attention_backward_cuda(q, k[:, :100], v[:, :100], do,
                                         False, 100)
    with pytest.raises(ValueError, match='does not match'):
        ta.fused_attention_backward_cuda(q, k, v, do[:, :16], False, 128)
    with pytest.raises(ValueError, match='kv_valid'):
        ta.fused_attention_backward_cuda(q, k, v, do, False, 129)
    with pytest.raises(ValueError, match='contiguous'):
        ta.fused_attention_backward_cuda(q.transpose(1, 2), k, v, do, False,
                                         128)
    with pytest.raises(ValueError, match='is on cpu'):
        ta.fused_attention_backward_cuda(q, k, v, do.cpu(), False, 128)
    assert ta.LAUNCHES[ta.KERNEL_BWD] == before


# ---- the int8 tiers' kernels -------------------------------------------
# Held to chip_smoke.INT8_BOUNDS (the full-width readings' bounds) at
# small and ragged shapes: batches that are not a multiple of the 8-row
# tile, column counts that are not a multiple of the 64-column tile.


def _randn(gen, *shape, scale=1.0, device='cuda', dtype=torch.float32):
    return (torch.randn(shape, generator=gen) * scale).to(device, dtype)


def _quantized(gen, k, n, device):
    from mr_mt3_tpu_torch.ops.int8_matmul import quantize_columns
    codes, scale = quantize_columns(_randn(gen, k, n, scale=0.05,
                                           device=device))
    return codes.contiguous(), scale[None].contiguous()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('b,d,n,f', [(1, 32, 256, 48), (3, 96, 1536, 192),
                                     (9, 512, 1536, 1024),
                                     (17, 64, 132, 100)])
def test_int8_matmul_kernels_match_plain_version(cuda, b, d, n, f, dtype):
    from mr_mt3_tpu_torch.ops import int8_matmul as i8m
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(b + d + n)
    x = _randn(gen, b, d, device=cuda, dtype=tdt)
    w, s = _quantized(gen, d, n, cuda)
    before = dict(i8m.LAUNCHES)
    got = i8m.int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert i8m.LAUNCHES['int8_matmul'] == before['int8_matmul'] + 1
    assert got.dtype == tdt and got.shape == (b, n)
    readings = chip_smoke.output_readings(
        torch, got, i8m.int8_matmul_reference(x, w, s))
    assert not chip_smoke.int8_violations('int8_matmul', dtype, readings)
    args = (x, *_quantized(gen, d, f, cuda), *_quantized(gen, d, f, cuda),
            *_quantized(gen, f, d, cuda))
    got = i8m.int8_gated_ff(*args)
    torch.cuda.synchronize()
    assert i8m.LAUNCHES['int8_gated_ff'] == before['int8_gated_ff'] + 1
    assert got.dtype == tdt and got.shape == (b, d)
    readings = chip_smoke.output_readings(
        torch, got, i8m.int8_gated_ff_reference(*args))
    assert not chip_smoke.int8_violations('int8_gated_ff', dtype, readings)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('b,h,dk,k_len,pos', [
    (1, 4, 8, 64, 0), (3, 4, 24, 64, 31), (2, 6, 64, 1024, 1023),
    (5, 4, 8, 12, 11), (2, 2, 128, 260, 200), (1, 1, 4, 4, 3),
    (9, 6, 64, 320, 319)])
def test_int8_attention_kernel_matches_plain_version(cuda, b, h, dk, k_len,
                                                     pos, dtype):
    from mr_mt3_tpu_torch.ops import int8_attention as i8a
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(b + h + dk + k_len)
    q = _randn(gen, b, h, dk, device=cuda, dtype=tdt)
    (kq, ks), (vq, vs) = (i8a.quantize_kv_rows(
        _randn(gen, b, h, dk, k_len, device=cuda)) for _ in range(2))
    args = (q, kq, ks, vq, vs, pos)
    before = i8a.LAUNCHES[i8a.KERNEL]
    got = i8a.int8_decode_attention(*args)
    torch.cuda.synchronize()
    assert i8a.LAUNCHES[i8a.KERNEL] == before + 1
    assert got.dtype == tdt and got.shape == (b, h * dk)
    readings = chip_smoke.output_readings(
        torch, got, i8a.int8_decode_attention_reference(*args), dk)
    assert not chip_smoke.int8_violations('int8_decode_attention', dtype,
                                          readings)
    if pos:
        ctrl = chip_smoke.output_readings(
            torch, got, chip_smoke.int8_attention_control(torch, *args), dk)
        assert chip_smoke.int8_violations('int8_decode_attention', dtype,
                                          ctrl)


def test_int8_wrappers_check_operands(cuda):
    """Bad operands raise before any launch: a dtype, a device, a shape,
    contiguity, a width the kernels do not read in 4s, a position past the
    cache, a head width past the kernel's limit."""
    from mr_mt3_tpu_torch.ops import int8_attention as i8a
    from mr_mt3_tpu_torch.ops import int8_matmul as i8m
    gen = torch.Generator().manual_seed(0)
    x = _randn(gen, 3, 32, device=cuda)
    w, s = _quantized(gen, 32, 64, cuda)
    before = {**i8m.LAUNCHES, **i8a.LAUNCHES}
    with pytest.raises(ValueError, match='dtype'):
        i8m.int8_matmul(x.half(), w, s)
    with pytest.raises(ValueError, match='is on cpu'):
        i8m.int8_matmul(x, w.cpu(), s)
    with pytest.raises(ValueError, match='contiguous'):
        i8m.int8_matmul(x, w.t().contiguous().t(), s)
    with pytest.raises(ValueError, match='shape'):
        i8m.int8_matmul(x, w, s[0])
    w6, s6 = _quantized(gen, 32, 6, cuda)
    with pytest.raises(ValueError, match='multiple of 4'):
        i8m.int8_matmul(x, w6, s6)
    with pytest.raises(ValueError, match='shape'):
        i8m.int8_gated_ff(x, w, s, w, s, w, s)
    q = _randn(gen, 2, 4, 8, device=cuda)
    (kq, ks), (vq, vs) = (i8a.quantize_kv_rows(
        _randn(gen, 2, 4, 8, 16, device=cuda)) for _ in range(2))
    with pytest.raises(ValueError, match='position'):
        i8a.int8_decode_attention(q, kq, ks, vq, vs, 16)
    with pytest.raises(ValueError, match='multiple of 4'):
        i8a.int8_decode_attention(q, kq[..., :6].contiguous(),
                                  ks[..., :6].contiguous(),
                                  vq[..., :6].contiguous(),
                                  vs[..., :6].contiguous(), 3)
    with pytest.raises(ValueError, match='dtype'):
        i8a.int8_decode_attention(q, kq.float(), ks, vq, vs, 3)
    wide = _randn(gen, 1, 1, 132, device=cuda)
    codes = torch.zeros((1, 1, 132, 4), dtype=torch.int8, device=cuda)
    scales = torch.ones((1, 1, 1, 4), device=cuda)
    with pytest.raises(ValueError, match='limit'):
        i8a.int8_decode_attention(wide, codes, scales, codes, scales, 0)
    assert {**i8m.LAUNCHES, **i8a.LAUNCHES} == before


def _int8_violations(kernel, dtype, got, args, plain, head_width=None):
    """chip_smoke's INT8_BOUNDS violations of got against plain(*args);
    in bf16 with the tie-aware check (chip_smoke.int8_bf16_violations): a
    share bound coarser than one element holds only through every unequal
    output being a rounding tie of the plain version."""
    readings = chip_smoke.output_readings(torch, got, plain(*args),
                                          head_width)
    if dtype != 'bfloat16':
        return chip_smoke.int8_violations(kernel, dtype, readings)
    readings.update(chip_smoke.bf16_tie_readings(
        torch, got, plain(*args), plain(args[0].float(), *args[1:]),
        head_width, chip_smoke.TIE_MOVEMENT[kernel](torch, *args)))
    return chip_smoke.int8_bf16_violations(kernel, readings)


# bf16 at B 1 under the tie-aware check: INT8_BOUNDS' share of unequal
# bf16 outputs (1e-3) is set for thousands of outputs; one row has 512,
# and a single output on a bf16 rounding tie (the kernel's f32 order
# against cuBLAS's one-row product) is 0.2% of them
@pytest.mark.parametrize('b,dtype', [(1, 'float32'), (13, 'float32'),
                                     (64, 'float32'), (1, 'bfloat16'),
                                     (13, 'bfloat16'), (64, 'bfloat16')])
def test_int8_gated_ff_full_width_batches(cuda, b, dtype):
    """The feed-forward at the decoder's 512 / 1024 at B 1, 13 (a ragged
    second row tile) and 64 (8 tiles, several tasks a block), one launch
    each, within INT8_BOUNDS; its grid barrier's words are zero again
    after the launches, and another stream gets its own."""
    from mr_mt3_tpu_torch.ops import int8_matmul as i8m
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(b)
    h = _randn(gen, b, 512, device=cuda, dtype=tdt)
    args = (h, *_quantized(gen, 512, 1024, cuda),
            *_quantized(gen, 512, 1024, cuda),
            *_quantized(gen, 1024, 512, cuda))
    before = i8m.LAUNCHES['int8_gated_ff']
    for _ in range(3):
        got = i8m.int8_gated_ff(*args)
    torch.cuda.synchronize()
    assert i8m.LAUNCHES['int8_gated_ff'] == before + 3
    assert not _int8_violations('int8_gated_ff', dtype, got, args,
                                i8m.int8_gated_ff_reference)
    stream = torch.cuda.current_stream().cuda_stream
    bar = i8m._barrier(h.device, stream)
    assert bar.tolist()[0] == 0       # the count; bar[1] is the generation
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        other = i8m.int8_gated_ff(*args)
    torch.cuda.synchronize()
    assert i8m._barrier(h.device, side.cuda_stream).data_ptr() \
        != bar.data_ptr()
    assert torch.equal(other, got)


# (batch, heads, d_kv, cache, position): B 1, 13 and 64; positions 0 and
# ragged ones; the layout's boundaries (1 / 2 position groups at 16 / 17
# positions, 32 at 512, two passes past 1024); caches whose length is a
# multiple of 4 or 8 but not 16 (8- and 4-byte loads); either side of the
# design rule (stream_wins: B H >= #SMs and n (2 dk + 8) > 40 KB, at 132
# pairs n 301 / 302)
INT8_ATTN_EDGE_CASES = [
    (1, 6, 64, 1024, 0), (1, 6, 64, 1024, 1023), (13, 6, 64, 1024, 700),
    (13, 6, 64, 320, 319), (64, 6, 64, 1024, 0), (64, 6, 64, 1024, 517),
    (64, 6, 64, 256, 255), (8, 6, 64, 1024, 15), (8, 6, 64, 1024, 16),
    (8, 6, 64, 1024, 511), (8, 6, 64, 1024, 512), (2, 4, 64, 2048, 1500),
    (3, 6, 64, 260, 259), (3, 6, 64, 264, 200), (2, 2, 128, 1024, 1023),
    (22, 6, 64, 512, 300), (22, 6, 64, 512, 301)]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('b,h,dk,k_len,pos', INT8_ATTN_EDGE_CASES)
def test_int8_attention_edges(cuda, b, h, dk, k_len, pos, dtype):
    """The attention kernel at the edges of its layouts and of its design
    rule, one launch each, within INT8_BOUNDS; the control caught wherever
    a position past 0 takes part. In f32 the bounds ask every head to
    agree (the codes are the plain version's); in bf16 the share of heads
    apart (6%) is less than one head below 17 pairs, so there the
    tie-aware check holds it: every unequal output is a rounding tie of
    the plain version (of the output, of a probability code, or of a q
    code of its head)."""
    from mr_mt3_tpu_torch.ops import int8_attention as i8a
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(b * 7 + pos)
    q = _randn(gen, b, h, dk, device=cuda, dtype=tdt)
    (kq, ks), (vq, vs) = (i8a.quantize_kv_rows(
        _randn(gen, b, h, dk, k_len, device=cuda)) for _ in range(2))
    args = (q, kq, ks, vq, vs, pos)
    before = i8a.LAUNCHES[i8a.KERNEL]
    got = i8a.int8_decode_attention(*args)
    torch.cuda.synchronize()
    assert i8a.LAUNCHES[i8a.KERNEL] == before + 1
    assert not _int8_violations('int8_decode_attention', dtype, got, args,
                                i8a.int8_decode_attention_reference, dk)
    if pos:
        ctrl = chip_smoke.output_readings(
            torch, got, chip_smoke.int8_attention_control(torch, *args), dk)
        assert chip_smoke.int8_violations('int8_decode_attention', dtype,
                                          ctrl)


def test_int8_kernels_refuse_what_they_do_not_take(cuda):
    """Codes that are not 4-byte aligned, a d_model that is not a multiple
    of 4 and a head wider than 128 raise before any launch."""
    from mr_mt3_tpu_torch.ops import int8_attention as i8a
    from mr_mt3_tpu_torch.ops import int8_matmul as i8m
    gen = torch.Generator().manual_seed(1)
    before = {**i8m.LAUNCHES, **i8a.LAUNCHES}
    q = _randn(gen, 1, 2, 8, device=cuda)
    (kq, ks), (vq, vs) = (i8a.quantize_kv_rows(
        _randn(gen, 1, 2, 8, 16, device=cuda)) for _ in range(2))
    store = torch.zeros(kq.numel() + 1, dtype=torch.int8, device=cuda)
    shifted = store[1:].view(kq.shape)
    shifted.copy_(kq)
    with pytest.raises(ValueError, match='aligned'):
        i8a.int8_decode_attention(q, shifted, ks, vq, vs, 5)
    h = _randn(gen, 2, 30, device=cuda)
    w, s = _quantized(gen, 30, 64, cuda)
    wo, so = _quantized(gen, 64, 30, cuda)
    with pytest.raises(ValueError, match='multiple of 4'):
        i8m.int8_gated_ff(h, w, s, w, s, wo, so)
    wide = _randn(gen, 1, 1, 136, device=cuda)
    codes = torch.zeros((1, 1, 136, 4), dtype=torch.int8, device=cuda)
    scales = torch.ones((1, 1, 1, 4), device=cuda)
    with pytest.raises(ValueError, match='limit'):
        i8a.int8_decode_attention(wide, codes, scales, codes, scales, 0)
    assert {**i8m.LAUNCHES, **i8a.LAUNCHES} == before


@pytest.mark.parametrize('b,k,n', [(8, 512, 1024), (9, 512, 1024),
                                   (64, 512, 1024), (8, 1024, 512),
                                   (64, 1024, 512)])
def test_cublas_f32_products_take_the_chunk_order(cuda, b, k, n):
    """int8_gated_ff sums in the order cuBLAS takes for the plain
    version's f32 products at the decoder's shapes (csrc/int8_matmul.cu,
    ff_chunk_partials): chunks of 64 k's, each a sequence of fused
    multiply-adds from zero, the chunks added in order; so its bf16 g is
    the plain version's. Held here, so that a cuBLAS that orders its sums
    otherwise shows (the kernel's bounds would still hold: g would move
    at rounding ties)."""
    gen = torch.Generator().manual_seed(k + n + b)
    x = _randn(gen, b, k, device=cuda)
    w = torch.randint(-127, 128, (k, n), generator=gen).float().to(cuda)
    xd, wd = x.double(), w.double()
    total = None
    for c0 in range(0, k, 64):
        acc = torch.zeros((b, n), device=cuda)
        for i in range(c0, c0 + 64):
            acc = (acc.double() + xd[:, i:i + 1] * wd[i]).float()
        total = acc if total is None else total + acc
    assert torch.equal(total, x @ w)


@pytest.mark.parametrize('tier', ['int8', 'int8_kv'])
def test_int8_launch_failure_stops_the_server(cuda, tier, monkeypatch):
    """A launch the card refuses (the library returns an error code)
    raises out of the wrapper, the decode, the probe ladder and
    prepare_handler: the server does not start, and the tier stays."""
    import types

    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.ops import int8_attention as i8a
    from mr_mt3_tpu_torch.ops import int8_matmul as i8m
    refuse = lambda *args: 1                      # cudaErrorInvalidValue
    text = lambda code: b'invalid argument'
    monkeypatch.setattr(i8m, '_library', lambda: types.SimpleNamespace(
        i8mm_launch=refuse, i8ff_launch=refuse, i8mm_error_string=text))
    monkeypatch.setattr(i8a, '_library', lambda: types.SimpleNamespace(
        i8att_launch=refuse, i8att_error_string=text))
    cfg = SMALL.replace(mel_bins=512)
    model = init_params(MT3(cfg), seed=0)
    handler = InferenceHandler(model=model, max_length=8, batch_size=2,
                               quantize=tier, device=cuda)
    with pytest.raises(RuntimeError, match='launch failed'):
        serve.prepare_handler(handler)
    assert handler.quantize == tier


@pytest.mark.parametrize('kind', ['tone', 'noise', 'zeros'])
@pytest.mark.parametrize('style', ['torch', 'tf'])
def test_logmel_kernel_matches_compute_logmel(cuda, style, kind):
    """The log-mel kernel against its plain version at
    tests/test_mel_pallas.py's bounds (chip_smoke.LOGMEL_BOUNDS), one
    launch a call; zeros give log(1e-5)."""
    import math

    from mr_mt3_tpu_torch.audio import SpectrogramConfig, compute_logmel
    from mr_mt3_tpu_torch.ops import mel_kernel
    cfg = SpectrogramConfig(filterbank_style=style)
    x = torch.from_numpy(chip_smoke.logmel_inputs(kind, 4, 20000)).to(cuda)
    before = mel_kernel.LAUNCHES['logmel']
    got = mel_kernel.logmel(x, cfg)
    torch.cuda.synchronize()
    assert mel_kernel.LAUNCHES['logmel'] == before + 1
    assert got.shape == (4, 157, 512)
    readings = chip_smoke.logmel_readings(torch, got, compute_logmel(x, cfg))
    assert chip_smoke.logmel_violations(
        chip_smoke.LOGMEL_BOUNDS['vs_plain'], readings) == []
    if kind == 'zeros':
        assert (got - math.log(1e-5)).abs().max() < 1e-4


def test_logmel_wrapper_checks_operands(cuda):
    from mr_mt3_tpu_torch.audio import SpectrogramConfig
    from mr_mt3_tpu_torch.ops import mel_kernel
    before = dict(mel_kernel.LAUNCHES)
    x = torch.zeros((2, 4096), device=cuda)
    with pytest.raises(ValueError, match='float32'):
        mel_kernel.logmel(x.double())
    with pytest.raises(ValueError, match='contiguous'):
        mel_kernel.logmel(torch.zeros((4096, 2), device=cuda).t())
    # the launcher refuses a hop, fft_size or mel count it does not take
    for cfg in (SpectrogramConfig(hop_width=256),
                SpectrogramConfig(fft_size=1024),
                SpectrogramConfig(num_mel_bins=1024)):
        with pytest.raises(RuntimeError, match='launch failed for hop'):
            mel_kernel.logmel(x, cfg)
    assert mel_kernel.LAUNCHES == before


def test_handler_mel_on_the_card_is_the_kernel(cuda):
    """InferenceHandler._compute_mel on the card launches the kernel once
    per call; its normalized mel meets the CPU handler's (compute_logmel)
    within 2e-3 of log-mel where that is above -4, and zeroes the frames
    past `valid` alike."""
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.ops import mel_kernel
    model = init_params(MT3(SMALL.replace(mel_bins=512)), seed=0)
    audio = chip_smoke.parity_corpus()[0][0][:50000]
    on_card = InferenceHandler(model=model, device=cuda)
    on_cpu = InferenceHandler(model=model, device='cpu')
    segments, _, valid = on_card._audio_to_segments(audio)
    before = mel_kernel.LAUNCHES['logmel']
    got = on_card._compute_mel(segments, valid).cpu()
    assert mel_kernel.LAUNCHES['logmel'] == before + 1
    want = on_cpu._compute_mel(segments, valid)
    energy = want > 8 / 17           # log-mel > -4 in [0, 1] units
    assert energy.float().mean() > 0.5
    assert (got - want).abs()[energy].max() < 2e-3 / 17
    assert not got[1, valid[1]:].any()


# ---- fused_decode_step and the grouped window ------------------------------


def _step_case(dev, tier, batch, pos, cache_len=512):
    """A step at pos of a cache whose rows < 320 the window kernel decoded
    (chunk 256 at Lenc 8: pos 300 reads two live chunks)."""
    cfg = SMALL
    dp, cross, cache, tokens = _setup(cfg, batch, 8, cache_len, dev,
                                      tier=tier)
    finished = torch.zeros(batch, dtype=torch.bool, device=dev)
    for p in range(0, 320, 32):
        toks_w, finished, cache = fd.fused_decode_window(
            cfg, dp.fused, dp, tokens, finished, p, cache, cross, 32)
        tokens = toks_w[:, -1].contiguous()
    x = dp.token_embed[tokens.long()].float() + dp.pos_table[pos].float()
    return dp, (cfg, dp.fused, x, pos, cache, cross,
                fd.cache_chunk(cache, cross))


@pytest.mark.parametrize('tier', ['fused_bf16', 'fused', 'fused_int4'])
@pytest.mark.parametrize('batch,pos', [(3, 0), (8, 255), (8, 300), (64, 301)])
def test_step_kernel_matches_plain_version(cuda, tier, batch, pos):
    """Logits and emitted rows against the plain version, before, at and
    across the first chunk boundary (read on an H100: within 1e-7)."""
    _, args = _step_case(cuda, tier, batch, pos)
    before = fd.STEP_LAUNCHES[tier]
    logits, rows = fd.fused_decode_step_cuda(*args)
    torch.cuda.synchronize()
    assert fd.STEP_LAUNCHES[tier] == before + 1
    want, w_rows = fd.fused_decode_step_reference(*args)
    scale = float(want.abs().max())
    assert float((logits - want).abs().max()) <= LOGIT_RTOL * scale
    assert set(rows) == set(w_rows)
    for key in ('kq', 'vq'):
        a, r = rows[key].float(), w_rows[key].float()
        if tier == 'fused_bf16':
            assert float((a - r).abs().max()) <= \
                KV_RTOL * float(r.abs().max())
        else:
            assert float((a == r).float().mean()) >= CODE_SHARE, key
            assert float((a - r).abs().max()) <= CODE_DIFF, key
    for key in set(rows) & {'ks', 'vs'}:
        assert float((rows[key] - w_rows[key]).abs().max()) <= \
            SCALE_RTOL * float(w_rows[key].abs().max())


def test_int4_odd_position_scatter_on_the_card(cuda):
    """An int4 step at odd position 301 through the wrapper writes the high
    nibble of byte 150 and keeps position 300's low nibble; no other
    position of the cache moves."""
    from mr_mt3_tpu_torch.ops.int8_matmul import unpack_int4
    dp, args = _step_case(cuda, 'fused_int4', 8, 301)
    cfg, cache, cross = args[0], args[4], args[5]
    tokens = torch.arange(3, 11, device=cuda)
    x = dp.token_embed[tokens].float() + dp.pos_table[301].float()
    before = {k: unpack_int4(cache[k]).clone() for k in ('kq', 'vq')}
    _, rows = fd.fused_decode_step_reference(cfg, args[1], x, 301, cache,
                                             cross, args[6])
    fd.fused_decode_step(cfg, dp.fused, dp, tokens, 301, cache, cross)
    for key in ('kq', 'vq'):
        after = unpack_int4(cache[key])
        keep = [p for p in range(after.shape[-1]) if p != 301]
        assert torch.equal(after[..., keep], before[key][..., keep])
        got = after[..., 301].reshape(cfg.num_decoder_layers, -1)
        want = rows[key].reshape(cfg.num_decoder_layers, -1)
        assert float((got == want).float().mean()) >= CODE_SHARE


def test_step_wrapper_checks_operands(cuda):
    """A bad dtype, a position past the cache, a chunk of 0 and a tensor on
    the CPU raise before any launch; a cache length that the chunk does not
    divide raises in the wrapper."""
    dp, args = _step_case(cuda, 'fused', 3, 4, cache_len=512)
    cfg, fp, x, pos, cache, cross, chunk = args
    before = dict(fd.STEP_LAUNCHES)
    with pytest.raises(ValueError, match='dtype'):
        fd.fused_decode_step_cuda(cfg, fp, x.half(), pos, cache, cross, chunk)
    with pytest.raises(ValueError, match='outside'):
        fd.fused_decode_step_cuda(cfg, fp, x, 512, cache, cross, chunk)
    with pytest.raises(ValueError, match='chunk'):
        fd.fused_decode_step_cuda(cfg, fp, x, pos, cache, cross, 0)
    with pytest.raises(ValueError, match='expected cpu'):
        fd.fused_decode_step_cuda(cfg, fp, x.cpu(), pos, cache, cross, chunk)
    bad = fd.init_fused_cache(cfg, 3, 300, cuda, 'fused')
    with pytest.raises(ValueError, match='multiple'):
        fd.fused_decode_step(cfg, fp, dp, torch.zeros(3, device=cuda,
                                                      dtype=torch.long),
                             0, bad, cross)
    assert fd.STEP_LAUNCHES == before


def _grouped_case(dev, groups, pos0, t_window=8, chunk=8, cache_len=32):
    from mr_mt3_tpu_torch.ops import group_axis_kernel as gk
    cfg, batch = SMALL, 8 * groups
    dp, cross, _, tokens = _setup(cfg, batch, 8, cache_len, dev,
                                  tier='fused')
    cross = gk.regroup_cross_kv(cross, groups)
    cache = gk.init_fused_cache_grouped(cfg, groups, cache_len, dev)
    finished = torch.zeros(batch, dtype=torch.bool, device=dev)
    for p in range(0, pos0, t_window):
        toks_w, finished, cache = gk.fused_decode_window_grouped(
            cfg, dp.fused, dp, tokens, finished, p, cache, cross, t_window,
            chunk)
        tokens = toks_w[:, -1].contiguous()
    finished = finished.clone()
    finished[-1] = True
    return dp, (cfg, dp.fused, fd.window_pos_rows(dp, pos0, t_window), tokens,
                finished, pos0, cache, cross, t_window, chunk)


@pytest.mark.parametrize('groups,pos0', [(1, 0), (2, 8), (2, 16), (8, 16)])
def test_grouped_kernel_matches_plain_version(cuda, groups, pos0):
    """Tokens (up to an allowed near-tie divergence), codes and the
    bf16-rounded scales of the window against the plain version; the cache
    rows < pos0 in chunks of 8 (two live at pos0 16)."""
    from mr_mt3_tpu_torch.ops import group_axis_kernel as gk
    _, args = _grouped_case(cuda, groups, pos0)
    cfg = args[0]
    before = gk.LAUNCHES['fused']
    toks, _, rows = gk.fused_decode_window_grouped_cuda(*args)
    torch.cuda.synchronize()
    assert gk.LAUNCHES['fused'] == before + 1
    w_toks, _, w_rows, logits = gk.fused_decode_window_grouped_reference(
        *args, return_logits=True)
    assert (toks[:, -1] == cfg.pad_token_id).all()
    agree = _agreeing_rows(cfg, toks, w_toks, logits)
    for key in ('ks', 'vs'):
        assert torch.equal(rows[key], rows[key].to(torch.bfloat16).float())
    if agree.all():
        for key in ('kq', 'vq'):
            a, r = rows[key].int(), w_rows[key].int()
            assert float((a == r).float().mean()) >= CODE_SHARE, key
            assert int((a - r).abs().max()) <= CODE_DIFF, key
        for key in ('ks', 'vs'):
            assert float((rows[key] - w_rows[key]).abs().max()) <= \
                SCALE_RTOL * float(w_rows[key].abs().max())


def test_grouped_wrapper_checks_operands(cuda):
    """Rows that are not whole groups, an int4 model and an ungrouped cache
    (its leading axis reads as one group of 8) raise before any launch."""
    from mr_mt3_tpu_torch.ops import group_axis_kernel as gk
    dp, args = _grouped_case(cuda, 2, 0)
    cfg, fp, pos_rows, tokens, finished, pos0, cache, cross, T, chunk = args
    before = dict(gk.LAUNCHES)
    with pytest.raises(ValueError, match='groups'):
        gk.fused_decode_window_grouped_cuda(cfg, fp, pos_rows, tokens[:12],
                                            finished[:12], pos0, cache,
                                            cross, T, chunk)
    int4 = stack_decode_params(init_params(MT3(cfg), seed=0).to(cuda),
                               quantize='fused_int4').fused
    with pytest.raises(NotImplementedError, match='int8'):
        gk.fused_decode_window_grouped_cuda(cfg, int4, pos_rows, tokens,
                                            finished, pos0, cache, cross, T,
                                            chunk)
    flat = {k: gk.ungroup(v, 2).contiguous() for k, v in cache.items()}
    with pytest.raises(ValueError, match='groups'):
        gk.fused_decode_window_grouped_cuda(cfg, fp, pos_rows, tokens,
                                            finished, pos0, flat, cross, T,
                                            chunk)
    assert gk.LAUNCHES == before


# ---- the redesigned step and grouped window (fw_kernel, ft_kernel) ------
# At B 8 the chunks of a pair are split between the two blocks of a
# cluster (2 H B <= the grid); at B 64 one block takes a pair, and the
# projections run in 32-column x 8-row tiles (ft_kernel).


@pytest.mark.parametrize('tier', ['fused_bf16', 'fused', 'fused_int4'])
@pytest.mark.parametrize('batch,pos', [(8, 1000), (64, 1000)])
def test_step_kernel_is_bit_identical_run_to_run(cuda, tier, batch, pos):
    """Three launches of the step on the same inputs (four live chunks)
    give the same logits and rows bit for bit (fixed sum orders, no float
    atomics), one launch each."""
    _, args = _step_case(cuda, tier, batch, pos, cache_len=1024)
    before = fd.STEP_LAUNCHES[tier]
    outs = [fd.fused_decode_step_cuda(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert fd.STEP_LAUNCHES[tier] == before + 3
    for logits, rows in outs[1:]:
        assert torch.equal(logits, outs[0][0])
        for key in rows:
            assert torch.equal(rows[key], outs[0][1][key])


def test_grouped_kernel_is_bit_identical_run_to_run(cuda):
    """Three grouped windows at G 8 (ft_kernel) on the same inputs are
    equal bit for bit, one launch each."""
    from mr_mt3_tpu_torch.ops import group_axis_kernel as gk
    _, args = _grouped_case(cuda, 8, 24)
    before = gk.LAUNCHES['fused']
    outs = [gk.fused_decode_window_grouped_cuda(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert gk.LAUNCHES['fused'] == before + 3
    for toks, fin, rows in outs[1:]:
        assert torch.equal(toks, outs[0][0]) and torch.equal(fin, outs[0][1])
        for key in rows:
            assert torch.equal(rows[key], outs[0][2][key])


@pytest.mark.parametrize('tier', ['fused_bf16', 'fused', 'fused_int4'])
@pytest.mark.parametrize('batch', [8, 64])
def test_step_kernel_equals_the_chunk_emulation(cuda, tier, batch,
                                                monkeypatch):
    """The step on the card against the plain version whose cache
    attention is tests/test_torch_step_tiles.py's emulation of the
    kernel's order (two splits that exchange their chunk maxima at B 8,
    one block a pair at B 64), at four live chunks: within the bounds that
    hold the kernel to the plain version; and the emulated step within
    them of the plain one on the card."""
    from test_torch_step_tiles import emulated_chunk_attention
    _, args = _step_case(cuda, tier, batch, 1000, cache_len=1024)
    cfg = args[0]
    splits = 2 if 2 * cfg.num_heads * batch <= \
        torch.cuda.get_device_properties(cuda).multi_processor_count else 1
    logits, rows = fd.fused_decode_step_cuda(*args)
    plain_logits, plain_rows = fd.fused_decode_step_reference(*args)
    monkeypatch.setattr(
        fd, '_cache_attention',
        lambda q, kc, vc, ks, vs, chunk, exact: emulated_chunk_attention(
            q, kc, vc, ks, vs, tier, chunk, splits)[0])
    want, w_rows = fd.fused_decode_step_reference(*args)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((logits - want).abs().max()) <= LOGIT_RTOL * scale
    assert float((plain_logits - want).abs().max()) <= LOGIT_RTOL * scale
    for key in ('kq', 'vq'):
        a, r = rows[key].float(), w_rows[key].float()
        if tier == 'fused_bf16':
            assert float((a - r).abs().max()) <= \
                KV_RTOL * float(r.abs().max())
        else:
            assert float((a == r).float().mean()) >= CODE_SHARE, key
            assert float((a - r).abs().max()) <= CODE_DIFF, key
            assert float((plain_rows[key] == w_rows[key]).float().mean()) \
                >= CODE_SHARE, key


_NEVER_REACHED = r'''
import sys, torch
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import test_torch_fused_decode_gpu as t
from mr_mt3_tpu_torch.ops import fused_decode as fd
_, args = t._step_case(torch.device('cuda'), 'fused', 8, 300)
real = fd._launch
def launch(name, entry, label, tensors, dims, eps, dev):
    tensors[-1].fill_(-8)   # the barrier word: 132 arrivals wrap short of 132
    real(name, entry, label, tensors, dims, eps, dev)
fd._launch = launch
fd.fused_decode_step_cuda(*args)
torch.cuda.synchronize()
print('NO TRAP')
'''


def test_a_barrier_never_reached_traps(cuda):
    """A step whose grid barrier can never fill (its word starts just
    below 2^32, so the arrivals wrap short of the target) ends with an
    error after the 4 s spin limit instead of hanging the card; run in its
    own process, whose context the trap spoils."""
    import os
    import subprocess
    import sys
    import time
    tests = os.path.dirname(os.path.abspath(__file__))
    code = _NEVER_REACHED.format(root=os.path.dirname(tests), tests=tests)
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and 'NO TRAP' not in proc.stdout
    assert 'CUDA' in proc.stderr or 'cuda' in proc.stderr, proc.stderr[-2000:]
    assert time.monotonic() - t0 < 120


def _check_window(cfg, tier, batch, got, want):
    """The kernel's window against the plain version's: tokens up to a
    near-tie divergence; bf16 rows within KV_RTOL, or integer codes and
    scales (CODE_SHARE, CODE_DIFF, SCALE_RTOL) up to each row's first
    divergence; the finished flags where every token agrees."""
    toks, fin, rows = got
    w_toks, w_fin, w_rows, logits = want
    agree = _agreeing_rows(cfg, toks, w_toks, logits)
    H = cfg.num_heads
    for b in range(batch):
        diff = torch.nonzero(toks[:, b] != w_toks[:, b])
        n = int(diff[0]) + 1 if len(diff) else toks.shape[0]

        def row_b(t):          # (T, L, H*B, ...) -> steps < n of row b
            return t[:n].reshape(n, -1, H, batch, *t.shape[3:])[:, :, :, b]
        for key in ('kq', 'vq'):
            a, r = row_b(rows[key]), row_b(w_rows[key])
            if tier == 'fused_bf16':
                a, r = a.float(), r.float()
                assert float((a - r).abs().max()) <= \
                    KV_RTOL * float(r.abs().max()), (key, b)
            else:
                a, r = a.int(), r.int()
                assert float((a == r).float().mean()) >= CODE_SHARE, (key, b)
                assert int((a - r).abs().max()) <= CODE_DIFF, (key, b)
        for key in set(rows) & {'ks', 'vs'}:
            a, r = row_b(rows[key]), row_b(w_rows[key])
            assert float((a - r).abs().max()) <= \
                SCALE_RTOL * float(r.abs().max()), (key, b)
    if agree.all():
        assert torch.equal(fin, w_fin)


@pytest.mark.parametrize('tier', ['fused_bf16', 'fused', 'fused_int4'])
@pytest.mark.parametrize('batch,pos0', [(1, 32), (24, 40), (3, 1)])
def test_window_splits_and_ragged_batches(cuda, tier, batch, pos0):
    """The window at B=1 (most clusters idle), B=24 (not a multiple of the
    8-row groups; int4's 3 groups of warps, the two blocks of a cluster
    staging 16 and 8 rows; bf16 and int8 take fd_kernel's phases above 8
    rows)
    and pos0 = 1 (a cache of one row: the second block of each pair's
    cluster gets no position, and the split boundaries fall off the 16-byte
    vectors) against its plain version. An int4 window starts at an even
    position, so pos0 = 1 raises there and 2 runs in its place."""
    if tier == 'fused_int4' and pos0 % 2:
        _, args = _window_case(cuda, tier, batch, 2, 64)
        bad = args[:5] + (1,) + args[6:]
        with pytest.raises(ValueError, match='even position'):
            fd.fused_decode_window_cuda(*bad)
    else:
        _, args = _window_case(cuda, tier, batch, pos0, 64)
    cfg = args[0]
    before = fd.LAUNCHES[tier]
    got = fd.fused_decode_window_cuda(*args)
    torch.cuda.synchronize()
    assert fd.LAUNCHES[tier] == before + 1
    assert (got[0][:, -1] == cfg.pad_token_id).all()
    want = fd.fused_decode_window_reference(*args, return_logits=True)
    _check_window(cfg, tier, batch, got, want)


@pytest.mark.parametrize('tier', ['fused_bf16', 'fused', 'fused_int4'])
@pytest.mark.parametrize('batch', [1, 8])
def test_repeated_windows_are_bit_identical(cuda, tier, batch):
    """Sums stay in a fixed order (no float atomics; a pair's two splits
    combined in split order): the same window twice gives the same tokens,
    rows and scales bit for bit."""
    _, args = _window_case(cuda, tier, batch, 32, 64)
    first = fd.fused_decode_window_cuda(*args)
    second = fd.fused_decode_window_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])
    for key in first[2]:
        assert torch.equal(first[2][key], second[2][key]), key


def test_int4_window_scatter_keeps_the_neighbours(cuda):
    """An int4 window at pos0 2 writes positions 2..9 of a cache of seeded
    codes, whole bytes, and no other position moves; a step at odd
    position 11 then writes the high nibble of byte 5 and keeps position
    10, which the window wrote."""
    from mr_mt3_tpu_torch.ops.int8_matmul import pack_int4, unpack_int4
    cfg, T, batch = SMALL, 8, 3
    dp, cross, cache, tokens = _setup(cfg, batch, 8, 32, cuda,
                                      tier='fused_int4')
    gen = torch.Generator().manual_seed(5)
    for key in ('kq', 'vq'):
        codes = torch.randint(-7, 8, unpack_int4(cache[key]).shape,
                              generator=gen, dtype=torch.int8)
        cache[key].copy_(pack_int4(codes).to(cuda))
    for key in ('ks', 'vs'):
        cache[key].copy_(torch.rand(cache[key].shape, generator=gen) + 0.1)
    finished = torch.zeros(batch, dtype=torch.bool, device=cuda)
    args = (cfg, dp.fused, fd.window_pos_rows(dp, 2, T), tokens, finished, 2,
            cache, cross, T)
    rows = fd.fused_decode_window_cuda(*args)[2]
    before = {k: unpack_int4(cache[k]).clone() for k in ('kq', 'vq')}
    fd.fused_decode_window(cfg, dp.fused, dp, tokens, finished, 2, cache,
                           cross, T)
    L, H = cfg.num_decoder_layers, cfg.num_heads
    for key in ('kq', 'vq'):
        after = unpack_int4(cache[key])
        keep = [p for p in range(after.shape[-1]) if not 2 <= p < 2 + T]
        assert torch.equal(after[..., keep], before[key][..., keep])
        want = rows[key].reshape(T, L, H, batch, -1).permute(1, 2, 3, 4, 0)
        assert torch.equal(after[..., 2:2 + T], want.to(after.dtype))
    window = {k: unpack_int4(cache[k]).clone() for k in ('kq', 'vq')}
    fd.fused_decode_step(cfg, dp.fused, dp, tokens, 11, cache, cross)
    for key in ('kq', 'vq'):
        after = unpack_int4(cache[key])
        keep = [p for p in range(after.shape[-1]) if p != 11]
        assert torch.equal(after[..., keep], window[key][..., keep])


@pytest.mark.parametrize('batch', [1, 3])
@pytest.mark.parametrize('style', ['torch', 'tf'])
def test_logmel_fft_ragged_segments(cuda, style, batch):
    """The FFT kernel at B 1 and 3 on 16000 samples (125 frames, the last
    ones past the audio, and a last block of frames only partly filled):
    within LOGMEL_BOUNDS of compute_logmel and of the float64 DFT."""
    from mr_mt3_tpu_torch.audio import SpectrogramConfig, compute_logmel
    from mr_mt3_tpu_torch.ops import mel_kernel
    cfg = SpectrogramConfig(filterbank_style=style)
    x = torch.from_numpy(chip_smoke.logmel_inputs('tone', batch,
                                                  16000)).to(cuda)
    got = mel_kernel.logmel(x, cfg)
    torch.cuda.synchronize()
    assert got.shape == (batch, 125, 512)
    for ref, want in (('vs_plain', compute_logmel(x, cfg)),
                      ('vs_f64', chip_smoke.logmel_f64(torch, x, cfg))):
        readings = chip_smoke.logmel_readings(torch, got, want)
        assert chip_smoke.logmel_violations(chip_smoke.LOGMEL_BOUNDS[ref],
                                            readings) == [], (ref, readings)
