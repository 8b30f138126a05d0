"""The CUDA fused_decode_window kernel against its plain PyTorch version
on the card. Imports no JAX, so it runs where the card is:

    python -m pytest tests/test_torch_fused_decode_gpu.py -m gpu -q

Without a card every test here skips (the kernel has no CPU form).
"""

import pytest
import torch

from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.ops import fused_decode as fd
from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params
from mr_mt3_tpu_torch.utils.builders import init_params

pytestmark = pytest.mark.gpu

# the kernel and the plain version sum in different orders: bf16 rows
# may round one ulp apart, and such flips pass on from layer to layer
KV_RTOL = 2e-2
LOGIT_RTOL = 2e-2

SMALL = MT3Config(vocab_size=256, d_model=32, d_kv=8, d_ff=48, num_heads=4,
                  num_encoder_layers=1, num_decoder_layers=2, mel_bins=16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU form')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _setup(cfg, batch, lenc, cache_len, dev, seed=0):
    model = init_params(MT3(cfg), seed=seed).to(dev).eval()
    dp = stack_decode_params(model, quantize='fused_bf16')
    gen = torch.Generator().manual_seed(seed + 1)
    enc = torch.randn((batch, lenc, cfg.d_model), generator=gen).to(dev)
    cross = fd.precompute_cross_kv_fused(dp, cfg, enc)
    cache = fd.init_fused_cache(cfg, batch, cache_len, dev)
    tokens = torch.randint(3, cfg.vocab_size, (batch,), generator=gen,
                           dtype=torch.int32).to(dev)
    return dp, cross, cache, tokens


@pytest.mark.parametrize('batch,pos0', [(3, 0), (3, 8), (8, 16), (64, 8)])
def test_kernel_matches_plain_version(cuda, batch, pos0):
    cfg, T = SMALL, 8
    dp, cross, cache, tokens = _setup(cfg, batch, 8, 32, cuda)
    finished = torch.zeros(batch, dtype=torch.bool, device=cuda)
    for p in range(0, pos0, T):        # cache rows < pos0 from the kernel
        toks_w, finished, cache = fd.fused_decode_window(
            cfg, dp.fused, dp, tokens, finished, p, cache, cross, T)
        tokens = toks_w[:, -1].contiguous()
    finished = finished.clone()
    finished[-1] = True
    pos_rows = fd.window_pos_rows(dp, pos0, T)
    args = (cfg, dp.fused, pos_rows, tokens, finished, pos0, cache, cross, T)
    last = torch.empty((batch, cfg.vocab_size), device=cuda)
    before = fd.LAUNCHES
    toks, fin, kw, vw = fd.fused_decode_window_cuda(*args, logits_out=last)
    torch.cuda.synchronize()
    assert fd.LAUNCHES == before + 1
    w_toks, w_fin, w_kw, w_vw, logits = fd.fused_decode_window_reference(
        *args, return_logits=True)
    assert (toks[:, -1] == cfg.pad_token_id).all()
    agree = (toks == w_toks).all(0)
    for b in torch.nonzero(~agree).flatten().tolist():
        d = int(torch.nonzero(toks[:, b] != w_toks[:, b])[0])
        row = logits[d, b]
        gap = float(row[w_toks[d, b]] - row[toks[d, b]])
        assert gap < 2 * LOGIT_RTOL * float(row.abs().max()), (b, d)
    if agree.all():
        assert torch.equal(fin, w_fin)
        scale = float(logits[-1].abs().max())
        assert float((last - logits[-1]).abs().max()) <= LOGIT_RTOL * scale
        for a, r in ((kw, w_kw), (vw, w_vw)):
            err = float((a.float() - r.float()).abs().max())
            assert err <= KV_RTOL * float(r.float().abs().max())


def test_nan_logits_give_the_vocab_token(cuda):
    """A NaN in lm_head column 7: the kernel emits the vocabulary size in
    every unfinished row, as the plain version does, and pad in a finished
    one; the wrapper raises."""
    cfg, T = SMALL, 8
    dp, cross, cache, tokens = _setup(cfg, 3, 8, 16, cuda)
    dp.fused.lm[:, 7] = float('nan')
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
