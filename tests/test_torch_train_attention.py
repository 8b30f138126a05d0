"""The port's fused_attention (mr_mt3_tpu_torch.ops.train_attention) on the
CPU, where it runs its plain versions, against the JAX package's
fused_attention with its Pallas kernels interpreted (interpret=not
on_tpu, as tests/test_train_attention.py runs it), on the same numpy
inputs: the forward, and the backward (autograd through the port's
Function against jax.vjp); the wrapper's argument checks; and the model's
routing of full-sequence attention (models/mt3.py) to the kernels."""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mr_mt3_tpu.ops.train_attention import fused_attention as jax_fused
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.models import mt3 as mt3_mod
from mr_mt3_tpu_torch.ops import train_attention as ta
from tests.torch_threads import two_torch_threads  # noqa: F401

# bf16 outputs: the two sides sum in other orders, so a value near a bf16
# rounding midpoint may round one ulp apart; a probability rounded apart
# moves its outputs by a fraction of an ulp
MAX_UNEQUAL = 1e-3          # share of unequal outputs
MAX_REL_DIFF = 2.0 ** -7    # largest |difference| over the largest |ref|
F32_RTOL = 1e-5


def _inputs(seed, b, lq, lk, h, d):
    """Unit-normal q, k, v (B, L, H, D) as float32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, h, d)).astype(np.float32)
            for n in (lq, lk, lk)]


def _both(arrays, causal, dtype, kv_valid=None):
    """(port output, JAX output) as float32 numpy on the same inputs."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = [jnp.asarray(a, jdt) for a in arrays]
    want = np.asarray(jax_fused(*jx, causal, kv_valid), np.float32)
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)
          for a in jx]
    before = ta.LAUNCHES[ta.KERNEL]
    got = ta.fused_attention(*tx, causal=causal, kv_valid=kv_valid)
    assert ta.LAUNCHES[ta.KERNEL] == before    # the CPU runs no kernel
    assert got.dtype == dtype and got.shape == tx[0].shape
    return got.float().numpy(), want


CASES = [
    pytest.param(512, 512, False, id='512sq'),
    pytest.param(512, 512, True, id='512sq_causal'),
    pytest.param(512, 320, False, id='512x320_padded'),
]


@pytest.mark.parametrize('d', [24, 64])
@pytest.mark.parametrize('lq,lk,causal', CASES)
def test_bf16_matches_jax_kernel(lq, lk, causal, d):
    got, want = _both(_inputs(0, 2, lq, lk, 2, d), causal, torch.bfloat16)
    assert np.mean(got != want) <= MAX_UNEQUAL
    assert np.abs(got - want).max() <= MAX_REL_DIFF * np.abs(want).max()


def test_bf16_memory_encoder_length_matches_jax_kernel():
    """The memory encoder's shape, 1024 x 1024 non-causal (D 64)."""
    got, want = _both(_inputs(1, 2, 1024, 1024, 2, 64), False,
                      torch.bfloat16)
    assert np.mean(got != want) <= MAX_UNEQUAL
    assert np.abs(got - want).max() <= MAX_REL_DIFF * np.abs(want).max()


@pytest.mark.parametrize('lq,lk,causal', CASES)
def test_f32_matches_jax_kernel(lq, lk, causal):
    got, want = _both(_inputs(2, 2, lq, lk, 2, 24), causal, torch.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_RTOL * np.abs(want).max())


def test_explicit_kv_valid_masks_the_tail():
    """kv_valid below Lk masks the later keys: the same as dropping them."""
    q, k, v = [torch.from_numpy(a) for a in _inputs(3, 1, 64, 200, 2, 16)]
    masked = ta.fused_attention(q, k, v, kv_valid=150)
    np.testing.assert_allclose(
        masked.numpy(), ta.fused_attention(q, k[:, :150], v[:, :150]).numpy(),
        rtol=0, atol=1e-6)


def test_padding_matches_the_kernels_padded_call():
    """The wrapper pads Lk to a multiple of 128 with zero rows and masks
    them: the plain version given the padded K/V and kv_valid agrees."""
    q, k, v = [torch.from_numpy(a).bfloat16()
               for a in _inputs(4, 2, 512, 320, 2, 64)]
    kp, vp, real = ta._pad_kv(k, v)
    assert kp.shape[1] == 384 and real == 320
    assert not kp[:, 320:].any() and not vp[:, 320:].any()
    torch.testing.assert_close(
        ta.fused_attention(q, k, v),
        ta.fused_attention_reference(q, kp, vp, kv_valid=320), rtol=0,
        atol=0)


class TestWrapperChecks:
    def _qkv(self, d=16, dtype=torch.float32, lk=32):
        q = torch.zeros((1, 16, 2, d), dtype=dtype)
        k = torch.zeros((1, lk, 2, d), dtype=dtype)
        return q, k, k.clone()

    @pytest.mark.parametrize('d', [20, 136])
    def test_head_width(self, d):
        with pytest.raises(ValueError, match='head width'):
            ta.fused_attention(*self._qkv(d))

    def test_shapes_types_and_kv_valid(self):
        q, k, v = self._qkv()
        with pytest.raises(ValueError, match='do not match'):
            ta.fused_attention(q, k[:, :, :1], v)
        with pytest.raises(ValueError, match='dtype'):
            ta.fused_attention(q, k.bfloat16(), v)
        with pytest.raises(ValueError, match='dtype'):
            ta.fused_attention(*self._qkv(dtype=torch.float16))
        with pytest.raises(ValueError, match='kv_valid'):
            ta.fused_attention(q, k, v, kv_valid=0)
        with pytest.raises(ValueError, match='kv_valid'):
            ta.fused_attention(q, k, v, kv_valid=129)
        with pytest.raises(ValueError, match=r'\(B, L, H, D\)'):
            ta.fused_attention(q[0], k, v)

    def test_shared_memory_limit(self):
        """The kernels keep no score rows: a block's shared memory is its
        64 query (and dO) rows or 64 keys and two stages of 64-row tiles,
        rows of the head width padded to a multiple of 16 plus 8 bf16 (D 24
        pads to 32); it does not take Lk, and every head width fits the
        227 KB a block can use (the old Lk refusal is gone)."""
        assert (ta._ROWS, ta._KT, ta._KB) == (64, 64, 64)
        assert ta.smem_bytes(64) == 2 * 72 * (64 + 4 * 64) == 46080
        assert ta.smem_bytes_bwd(64) == (2 * 72 * (2 * 64 + 4 * 64),
                                         2 * 72 * (2 * 64 + 4 * 64)
                                         + 4 * 3 * 2 * 64)
        assert ta.smem_bytes(24) == ta.smem_bytes(32) == 2 * 40 * 320
        assert ta.smem_bytes_bwd(24) == ta.smem_bytes_bwd(32)
        for fn in (ta.smem_bytes, ta.smem_bytes_bwd):
            assert list(inspect.signature(fn).parameters) == ['d']
        assert max(ta.smem_bytes(128), *ta.smem_bytes_bwd(128)) <= 232448

    def test_kernel_takes_bf16_only(self):
        """float32 runs the plain version on the CPU; the kernel launch
        refuses it before touching the card."""
        q, k, v = self._qkv()
        with pytest.raises(ValueError, match='bfloat16 only'):
            ta.fused_attention_cuda(q, k, v, False, 32)


def _cfg(**kw):
    return MT3Config(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_heads=4,
                     num_encoder_layers=1, num_decoder_layers=2, mel_bins=16,
                     **kw)


class TestRouting:
    def test_auto_takes_the_kernel_for_bf16_on_the_card_only(self):
        cuda, cpu = torch.device('cuda'), torch.device('cpu')
        resolve = mt3_mod.resolve_attention_kernel
        assert resolve(_cfg(dtype='bfloat16'), cuda) == 'fused'
        assert resolve(_cfg(dtype='bfloat16'), cpu) == 'einsum'
        assert resolve(_cfg(), cuda) == 'einsum'
        assert resolve(_cfg(attention_kernel='fused'), cpu) == 'fused'
        assert resolve(_cfg(dtype='bfloat16', attention_kernel='einsum'),
                       cuda) == 'einsum'
        with pytest.raises(ValueError, match='unknown attention_kernel'):
            resolve(_cfg(attention_kernel='fuse'), cpu)

    def test_eligibility_is_the_jax_rule(self):
        attn = MT3(_cfg(attention_kernel='fused')).decoder.block[0].self_attn
        cpu = torch.device('cpu')
        assert attn._fused_eligible(512, 512, None, True, cpu)
        assert attn._fused_eligible(1024, 384, None, False, cpu)
        assert not attn._fused_eligible(504, 504, None, False, cpu)
        assert not attn._fused_eligible(516, 516, None, False, cpu)
        assert not attn._fused_eligible(512, 256, None, True, cpu)
        assert not attn._fused_eligible(512, 512, torch.zeros(1), False,
                                        cpu)

    @pytest.mark.parametrize('variant,calls', [(None, 4),
                                               ('encoder_append', 5),
                                               ('decoder_prepend', 5)])
    def test_teacher_forced_forward_calls(self, variant, calls,
                                          monkeypatch):
        """At L = 512 with attention_kernel='fused', every decoder layer's
        causal self-attention and cross-attention and the memory encoder's
        attention take fused_attention (the 256-frame encoder does not),
        and the logits stay within bf16 noise of the einsum route."""
        seen = []
        real = ta.fused_attention

        def counting(q, k, v, causal=False, kv_valid=None):
            seen.append((q.shape[1], k.shape[1], causal))
            return real(q, k, v, causal, kv_valid)
        monkeypatch.setattr(ta, 'fused_attention', counting)
        extra = {} if variant is None else {'segmem_variant': variant,
                                             'segmem_length': 8}
        torch.manual_seed(0)
        model = MT3(_cfg(attention_kernel='fused', dtype='bfloat16',
                         **extra)).eval()
        twin = MT3(model.cfg.replace(attention_kernel='einsum')).eval()
        twin.load_state_dict(model.state_dict())
        gen = torch.Generator().manual_seed(1)
        mel = torch.rand((2, 256, 16), generator=gen)
        ids = torch.randint(0, 64, (2, 512), generator=gen)
        with torch.no_grad():
            got = model(mel, ids).float()
            want = twin(mel, ids).float()
        assert len(seen) == calls
        assert sum(c for _, _, c in seen) == 2       # the decoder's
        assert float((got - want).abs().max()) <= 0.05 * float(
            want.abs().max())


# The backward against jax.vjp of the JAX fused_attention (its _bwd_kernel
# interpreted), B 2, H 2, unit-normal inputs, numpy seeds 0-2 (each test
# prints its readings under -s). Bounds at about 3x the largest reading:
#   f32: max|diff| over the largest |grad| read 1.55e-6;
#   bf16, share of values unequal: dk 0.18%, dv 0.34%; dq 2.22% (seeds
#   0 / 1 / 2 at most 2.22 / 1.33 / 1.92%, all at D 64). dq = bf16(ds) k
#   sums terms that cancel (each row of ds sums to zero), so the two
#   sides' f32 sum-order noise is large against dq's value and flips more
#   of its bf16 roundings (ROADMAP section C); its largest difference
#   stays small (1.0e-3 of the largest |dq|);
#   bf16, largest |diff| over the largest |grad|: 3.65e-3 (dk).
BWD_F32_RTOL = 5e-6
BWD_MAX_UNEQUAL = {'dq': 7.5e-2, 'dk': 1e-2, 'dv': 1e-2}
BWD_MAX_REL_DIFF = 2.0 ** -7

BWD_CASES = [
    pytest.param(128, 128, False, id='128sq'),
    pytest.param(256, 256, True, id='256sq_causal'),
    pytest.param(128, 40, False, id='128x40_padded'),
]


def _grads_both(arrays, causal, dtype):
    """(port grads, JAX grads) of q, k, v as float32 numpy: autograd
    through the port's fused_attention, jax.vjp through JAX's, with the
    same cotangent."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = [jnp.asarray(a, jdt) for a in arrays]
    _, vjp = jax.vjp(lambda q, k, v: jax_fused(q, k, v, causal, None),
                     *jx[:3])
    want = [np.asarray(g, np.float32) for g in vjp(jx[3])]
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(dtype)
          for a in jx]
    leaves = [t.requires_grad_(True) for t in tx[:3]]
    before = dict(ta.LAUNCHES)
    out = ta.fused_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, tx[3])
    assert ta.LAUNCHES == before              # the CPU runs no kernel
    assert [g.dtype for g in got] == [dtype] * 3
    return [g.float().numpy() for g in got], want


def _bwd_arrays(seed, lq, lk, d):
    """q, k, v and the cotangent of one backward case."""
    return _inputs(seed, 2, lq, lk, 2, d) + [
        np.random.default_rng(10 + seed).normal(size=(2, lq, 2, d)).astype(
            np.float32)]


@pytest.mark.parametrize('d', [24, 64])
@pytest.mark.parametrize('lq,lk,causal', BWD_CASES)
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_bf16_backward_matches_jax_kernel(seed, lq, lk, causal, d):
    got, want = _grads_both(_bwd_arrays(seed, lq, lk, d), causal,
                            torch.bfloat16)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert g.shape == w.shape, name
        unequal = np.mean(g != w)
        rel = np.abs(g - w).max() / np.abs(w).max()
        print(f'bf16 seed {seed} L {lq}x{lk} causal {causal} D {d} {name}: '
              f'unequal {unequal:.4%}, max|diff| {rel:.3g} of max|grad|')
        assert unequal <= BWD_MAX_UNEQUAL[name], name
        assert rel <= BWD_MAX_REL_DIFF, name


@pytest.mark.parametrize('d', [24, 64])
@pytest.mark.parametrize('lq,lk,causal', BWD_CASES)
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_f32_backward_matches_jax_kernel(seed, lq, lk, causal, d):
    got, want = _grads_both(_bwd_arrays(seed, lq, lk, d), causal,
                            torch.float32)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        rel = np.abs(g - w).max() / np.abs(w).max()
        print(f'f32 seed {seed} L {lq}x{lk} causal {causal} D {d} {name}: '
              f'max|diff| {rel:.3g} of max|grad|')
        assert rel <= BWD_F32_RTOL, name


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('causal', [False, True])
def test_autograd_equals_the_plain_backward(dtype, causal):
    """On the CPU the Function's backward is the plain backward itself:
    autograd through fused_attention gives its (dq, dk, dv) bit for bit,
    dk/dv trimmed to the real Lk (100 of the padded 128)."""
    q, k, v = [torch.from_numpy(a).to(dtype)
               for a in _inputs(5, 2, 128, 100, 2, 32)]
    do = torch.from_numpy(_inputs(6, 2, 128, 1, 2, 32)[0]).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(ta.fused_attention(*leaves, causal=causal),
                              leaves, do)
    kp, vp, real = ta._pad_kv(k, v)
    want = ta.fused_attention_backward_reference(q, kp, vp, do, causal, real)
    assert [tuple(g.shape) for g in got] == [tuple(t.shape)
                                             for t in (q, k, v)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w[:, :g.shape[1]], rtol=0, atol=0)


def test_padded_rows_are_trimmed_and_get_zeros():
    """kv_valid below Lk: the gradient reaches only the kv_valid rows; the
    plain backward on the padded K/V gives exact zeros past them, and the
    wrapper hands back dk/dv of the caller's length."""
    q, k, v = [torch.from_numpy(a).bfloat16()
               for a in _inputs(7, 1, 64, 40, 2, 16)]
    do = torch.from_numpy(_inputs(8, 1, 64, 1, 2, 16)[0]).bfloat16()
    kp, vp, real = ta._pad_kv(k, v)
    assert kp.shape[1] == 128 and real == 40
    dq, dk, dv = ta.fused_attention_backward_reference(q, kp, vp, do,
                                                       kv_valid=30)
    assert not dk[:, 30:].any() and not dv[:, 30:].any()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(ta.fused_attention(*leaves, kv_valid=30),
                              leaves, do)
    assert got[1].shape == k.shape and got[2].shape == v.shape
    torch.testing.assert_close(got[1], dk[:, :40], rtol=0, atol=0)
    assert not got[1][:, 30:].any()


def test_backward_reference_is_not_autograd_of_the_forward():
    """Autograd through fused_attention_reference rounds dp to bf16 (the
    backward of its .to(v.dtype)); the plain backward keeps dp in f32, as
    the TPU kernel does: the two give different dq at bf16."""
    q, k, v = [torch.from_numpy(a).bfloat16()
               for a in _inputs(9, 1, 64, 64, 2, 32)]
    do = torch.from_numpy(_inputs(12, 1, 64, 1, 2, 32)[0]).bfloat16()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(ta.fused_attention_reference(*leaves),
                               leaves, do)
    plain = ta.fused_attention_backward_reference(q, k, v, do)
    assert not torch.equal(auto[0], plain[0])
    torch.testing.assert_close(auto[2], plain[2], rtol=0, atol=0)


def test_bf16_fused_train_step_close_to_jax():
    """One bf16 loss and gradient of the TINY model (tests/test_train.py:31,
    dropout 0) with attention_kernel='fused' on both sides at a bucketed
    target length of 512, so the decoder's causal self-attention and its
    cross-attention take the kernels (JAX's interpreted, the port's plain
    versions, forward and backward). Both sides round their bf16 matmul
    outputs after sums in other orders: the loss within 1e-3 relative
    (read 7.3e-6), each gradient within 5% of its leaf's largest |value|
    (read 1.5%)."""
    from mr_mt3_tpu.audio import SpectrogramConfig as JaxSpec
    from mr_mt3_tpu.models import MT3 as JaxMT3
    from mr_mt3_tpu.models import MT3Config as JaxConfig
    from mr_mt3_tpu.train.losses import cross_entropy_loss as jax_ce
    from mr_mt3_tpu.train.trainer import batch_to_mel as jax_mel
    from mr_mt3_tpu_torch.audio import SpectrogramConfig
    from mr_mt3_tpu_torch.train.losses import cross_entropy_loss
    from mr_mt3_tpu_torch.train.trainer import bucket_targets, batch_to_mel
    from mr_mt3_tpu_torch.utils.checkpoint_import import (
        state_dict_from_jax_params)
    kw = dict(vocab_size=1536, d_model=32, d_kv=8, d_ff=48, num_heads=4,
              num_encoder_layers=1, num_decoder_layers=1, mel_bins=512,
              dropout_rate=0.0, dtype='bfloat16', attention_kernel='fused')
    jcfg, cfg = JaxConfig(**kw), MT3Config(**kw)
    jmodel = JaxMT3(jcfg)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.zeros((1, 256, 512)),
                         decoder_input_ids=jnp.zeros((1, 8), jnp.int32)
                         )['params']
    rng = np.random.default_rng(5)
    audio = rng.normal(size=(2, 256 * 128)).astype(np.float32) * 0.1
    valid = np.full((2,), 256, np.int32)
    targets = np.concatenate([rng.integers(3, 1391, (2, 500)),
                              np.ones((2, 1), np.int64),
                              np.full((2, 523), -100, np.int64)], axis=1)
    targets = bucket_targets({'targets': targets})['targets']
    assert targets.shape[1] == 512

    def jloss_fn(params):
        mel = jax_mel(jnp.asarray(audio), jnp.asarray(valid), JaxSpec())
        logits = jmodel.apply({'params': params}, mel,
                              labels=jnp.asarray(targets))
        return jax_ce(logits, jnp.asarray(targets))
    jloss, jgrads = jax.value_and_grad(jloss_fn)(params)
    model = MT3(cfg)
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), cfg), strict=True)
    mel = batch_to_mel(torch.from_numpy(audio), torch.from_numpy(valid),
                       SpectrogramConfig())
    tt = torch.from_numpy(targets)
    seen = []
    real = ta._FusedAttention.apply

    def counting(*args):
        seen.append(args[3])
        return real(*args)
    ta._FusedAttention.apply = counting
    try:
        loss = cross_entropy_loss(model(mel, labels=tt), tt)
    finally:
        ta._FusedAttention.apply = real
    assert seen == [True, False]     # causal self, cross
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(model.parameters()))))
    print('bf16 loss', float(loss.detach()), float(jloss))
    assert loss.item() == pytest.approx(float(jloss), rel=1e-3)
    worst = 0.0
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads), cfg)
    for name, w in want.items():
        err = float((grads[name] - w).abs().max())
        worst = max(worst, err / float(w.abs().max()))
        assert err <= 0.05 * float(w.abs().max()), name
    print('bf16 worst grad err / leaf max', worst)
