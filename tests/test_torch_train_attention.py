"""The port's fused_attention (mr_mt3_tpu_torch.ops.train_attention) on the
CPU, where it runs its plain version, against the JAX package's
fused_attention with its Pallas kernel interpreted (interpret=not on_tpu,
as tests/test_train_attention.py runs it), on the same numpy inputs; the
wrapper's argument checks; and the model's routing of full-sequence
attention (models/mt3.py) to the kernel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mr_mt3_tpu.ops.train_attention import fused_attention as jax_fused
from mr_mt3_tpu_torch.models import MT3, MT3Config
from mr_mt3_tpu_torch.models import mt3 as mt3_mod
from mr_mt3_tpu_torch.ops import train_attention as ta

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

    def test_gradient_raises(self):
        q, k, v = self._qkv()
        q.requires_grad_(True)
        with pytest.raises(RuntimeError, match='backward is not yet ported'):
            ta.fused_attention(q, k, v)
        with torch.no_grad():
            ta.fused_attention(q, k, v)

    def test_shared_memory_limit(self):
        """The kernel keeps 16 f32 score rows of Lk columns per block: an
        Lk past the 227 KB a block can use raises before any launch; the
        head width pads to a multiple of 16."""
        assert ta.smem_bytes(1024, 64) == \
            4 * 16 * 1024 + 2 * 16 * 64 + 2 * 128 * 64 + 4 * 16 * 128
        assert ta.smem_bytes(1024, 24) == \
            4 * 16 * 1024 + 2 * 16 * 32 + 2 * 128 * 32 + 4 * 16 * 128
        q, k, v = self._qkv(lk=4096, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match='shared memory'):
            ta.fused_attention_cuda(q, k, v, False, 4096)

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
