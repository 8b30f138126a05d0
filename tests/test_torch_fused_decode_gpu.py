"""The CUDA kernels against their plain PyTorch versions on the card:
fused_decode_window in its three modes and fused_attention_fwd. Imports no
JAX, so it runs where the card is:

    python -m pytest tests/test_torch_fused_decode_gpu.py -m gpu -q

Without a card every test here skips (the kernels have no CPU form).
"""

import pytest
import torch

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


@pytest.mark.parametrize('b,lq,lk,h,d,causal,kv_valid', [
    (2, 64, 64, 2, 64, False, None),
    (2, 128, 100, 2, 24, False, None),
    (1, 96, 96, 3, 64, True, None),
    (1, 40, 40, 2, 128, True, None),
    (2, 64, 256, 2, 32, False, 200),
    (2, 64, 80, 2, 32, False, None),
    (1, 48, 48, 2, 16, True, None),
])
def test_attention_kernel_matches_plain_version(cuda, b, lq, lk, h, d,
                                                causal, kv_valid):
    from mr_mt3_tpu_torch.ops import train_attention as ta
    gen = torch.Generator().manual_seed(lq + lk + d)
    q, k, v = [torch.randn((b, n, h, d), generator=gen).to(cuda,
                                                             torch.bfloat16)
               for n in (lq, lk, lk)]
    before = ta.LAUNCHES[ta.KERNEL]
    got = ta.fused_attention(q, k, v, causal=causal, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert ta.LAUNCHES[ta.KERNEL] == before + 1
    kp, vp, real = ta._pad_kv(k, v)
    want = ta.fused_attention_reference(q, kp, vp, causal,
                                        kv_valid or real)
    assert got.shape == want.shape
    assert got.dtype == want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert float((got != want).float().mean()) <= ATTN_MAX_UNEQUAL
    assert err <= ATTN_MAX_REL


def test_attention_wrapper_on_the_card(cuda):
    """A gradient raises; float32 raises (the kernel is bf16 only); an Lk
    past the shared memory raises before any launch; a model at bf16
    routes its long attention to the kernel."""
    from mr_mt3_tpu_torch.ops import train_attention as ta
    q = torch.zeros((1, 16, 2, 16), device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(RuntimeError, match='backward'):
        ta.fused_attention(q, q, q)
    f32 = torch.zeros((1, 16, 2, 16), device=cuda)
    before = ta.LAUNCHES[ta.KERNEL]
    with pytest.raises(ValueError, match='bfloat16 only'):
        ta.fused_attention(f32, f32, f32)
    assert ta.LAUNCHES[ta.KERNEL] == before
    big = torch.zeros((1, 4096, 2, 16), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='shared memory'):
        ta.fused_attention(big[:, :16], big, big)
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
