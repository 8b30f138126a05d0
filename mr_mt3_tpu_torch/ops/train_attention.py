"""Fused unscaled-softmax attention, forward and backward (port of
mr_mt3_tpu/ops/train_attention.py::fused_attention).

fused_attention is differentiable through _FusedAttention, a
torch.autograd.Function. On bfloat16 CUDA tensors its forward runs the
hand-written CUDA kernel csrc/fused_attention_fwd.cu (it replaces the TPU
kernel's forward, train_attention.py::_fwd_kernel) and its backward
csrc/fused_attention_bwd.cu (it replaces _bwd_kernel); on CPU tensors
(bfloat16 or float32) they run fused_attention_reference and
fused_attention_backward_reference, the plain PyTorch versions of the same
math in the same order. Nothing falls back: a CUDA tensor launches the
kernels or raises, and the kernels take bfloat16 only (models/mt3.py
routes only bf16 models to them).

The math, per (batch row, head): s = q k^T with f32 sums, NOT scaled (T5);
columns >= kv_valid and, with causal, columns > row set to -1e30; an f32
softmax normalized before the probabilities are rounded to v's dtype; then
o = p v with f32 sums, in q's dtype. The backward recomputes p and takes
dv = bf16(p)^T dO, dp = dO v^T, ds = p (dp - rowsum(dp p)) and dq, dk from
bf16(ds), as the TPU kernel does. K/V are zero-padded to a multiple of 128
rows and masked by kv_valid, as the TPU kernel pads them (_pad_kv); the
padding stays outside the Function, so autograd trims the padded rows' dk
and dv, as the JAX VJP (_fused_bwd) does. The TPU kernel's batch blocking
(_pick_block_b) and its GSPMD partitioning rules have no counterpart: the
CUDA grids cover (row or key tile, head, batch row) and one card runs them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mr_mt3_tpu_torch.ops.cuda_build import count_launch

_LANE = 128       # K/V rows are padded to a multiple of this (TPU lane)
_ROWS = 64        # query rows per block, forward and dq (csrc: ROWS)
_KT = 64          # rows per streamed K/V (or Q/dO) tile (csrc: TILE)
_KB = 64          # keys per block of the dk/dv kernel (csrc bwd: KB)
_MAX_D = 128      # head width limit (csrc: MAX_D)
_PAD = 8          # bf16 of padding per shared row (csrc: PAD)
_DTYPES = (torch.bfloat16, torch.float32)   # the plain version's

KERNEL = 'fused_attention_fwd'
KERNEL_BWD = 'fused_attention_bwd'
# launches of the CUDA kernels; only the kernel paths add to them (one
# backward launch runs the dq kernel and the dk/dv kernel)
LAUNCHES = {KERNEL: 0, KERNEL_BWD: 0}


def _row_bytes(d: int) -> int:
    """Bytes of one shared row: the head width padded to a multiple of 16
    (the product's depth) and 8 more bf16 (the conflict-free stride)."""
    return 2 * (-(-d // 16) * 16 + _PAD)


def smem_bytes(d: int) -> int:
    """Shared memory of one forward block (csrc: smem_bytes): its ROWS
    query rows and two stages of a K and a V tile. No score rows: it does
    not depend on Lk."""
    return _row_bytes(d) * (_ROWS + 4 * _KT)


def smem_bytes_bwd(d: int) -> Tuple[int, int]:
    """Shared memory of one block of each backward kernel (csrc bwd:
    smem_dq, smem_dkdv): the dq kernel's ROWS query and dO rows and two
    stages of a K and a V tile; the dk/dv kernel's KB K and V rows, two
    stages of a Q and a dO tile and of those rows' f32 (m, 1 / l, delta)."""
    dq = _row_bytes(d) * (2 * _ROWS + 4 * _KT)
    dkdv = _row_bytes(d) * (2 * _KB + 4 * _KT) + 4 * 3 * 2 * _KT
    return dq, dkdv


def _pad_kv(k: torch.Tensor, v: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Pad Lk with zero rows up to a multiple of 128; returns (k, v,
    real_lk)."""
    lk = k.shape[1]
    pad = (-lk) % _LANE
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v, lk


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError('q, k and v must be (B, L, H, D)')
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f'k {tuple(k.shape)} and v {tuple(v.shape)} do '
                         f'not match q {tuple(q.shape)}')
    if d > _MAX_D or d % 8:
        raise ValueError(f'head width {d}: the kernel takes D <= {_MAX_D}, '
                         f'a multiple of 8')
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f'q, k and v must share one dtype of bfloat16 or '
                         f'float32 (got {q.dtype}, {k.dtype}, {v.dtype})')
    if q.device != k.device or q.device != v.device:
        raise ValueError('q, k and v must be on one device')


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              kv_valid: Optional[int] = None
                              ) -> torch.Tensor:
    """The plain PyTorch version, in the TPU kernel's order: f32 scores,
    the -1e30 masks, max, exp, normalize, round p to v's dtype, f32 value
    sums, q's dtype. k/v are taken as given (padded or not); kv_valid
    defaults to their length."""
    valid = k.shape[1] if kv_valid is None else kv_valid
    p = _probabilities(q, k, causal, valid).to(v.dtype)
    return torch.einsum('bhqk,bkhd->bqhd', p.float(), v.float()).to(q.dtype)


def _probabilities(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   valid: int) -> torch.Tensor:
    """f32 softmax of the masked f32 scores, (B, H, Lq, Lk)."""
    lq, lk = q.shape[1], k.shape[1]
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
    col = torch.arange(lk, device=q.device)
    keep = (col < valid)[None, :].expand(lq, lk)
    if causal:
        row = torch.arange(lq, device=q.device)
        keep = keep & (col[None, :] <= row[:, None])
    s = torch.where(keep, s, torch.tensor(-1e30, device=q.device))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def fused_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
        causal: bool = False, kv_valid: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward, the TPU kernel's formula written out (not
    autograd through fused_attention_reference, whose .to(v.dtype) would
    round dp to bf16): p recomputed in f32; dv = bf16(p)^T dO; dp = dO v^T;
    ds = p (dp - rowsum(dp p)) in f32; dq = bf16(ds) k, dk = bf16(ds)^T q,
    all with f32 sums. k/v as given (padded or not); returns (dq, dk, dv)
    in the inputs' dtypes, dk/dv with k's length."""
    valid = k.shape[1] if kv_valid is None else kv_valid
    p = _probabilities(q, k, causal, valid)
    pb = p.to(do.dtype).float()
    dof = do.float()
    dv = torch.einsum('bhqk,bqhd->bkhd', pb, dof)
    dp = torch.einsum('bqhd,bkhd->bhqk', dof, v.float())
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dsb = ds.to(q.dtype).float()
    dq = torch.einsum('bhqk,bkhd->bqhd', dsb, k.float())
    dk = torch.einsum('bhqk,bqhd->bkhd', dsb, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _library():
    from mr_mt3_tpu_torch.ops import cuda_build
    lib = cuda_build.load(KERNEL)
    if lib.faf_launch.argtypes is None:
        lib.faf_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        lib.faf_launch.restype = ctypes.c_int
        lib.faf_error_string.argtypes = [ctypes.c_int]
        lib.faf_error_string.restype = ctypes.c_char_p
        for name in ('faf_rows', 'faf_tile', 'faf_max_d'):
            getattr(lib, name).restype = ctypes.c_int
        lib.faf_smem_bytes.argtypes = [ctypes.c_int]
        lib.faf_smem_bytes.restype = ctypes.c_longlong
        if (lib.faf_rows(), lib.faf_tile(), lib.faf_max_d()) != (
                _ROWS, _KT, _MAX_D) or any(
                lib.faf_smem_bytes(d) != smem_bytes(d)
                for d in (24, 64, 128)):
            raise RuntimeError('fused_attention: the wrapper and the CUDA '
                               'source disagree on the tile constants')
    return lib


def fused_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, kv_valid: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; q/k/v bfloat16, k/v
    already padded. Returns (B, Lq, H, D) bfloat16."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if q.dtype != torch.bfloat16:
        raise ValueError(f'the CUDA kernel takes bfloat16 only (got '
                         f'{q.dtype}); float32 runs only on the CPU')
    for name, t in (('q', q), ('k', k), ('v', v)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if t.data_ptr() % 16:   # rows are read 16 bytes at a time
            raise ValueError(f'{name} must be 16-byte aligned')
    if not 1 <= kv_valid <= lk:
        raise ValueError(f'kv_valid {kv_valid} outside 1..{lk}')
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.faf_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), b, lq, lk, h, d, int(kv_valid),
                            int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError('fused_attention_fwd launch failed: '
                           + lib.faf_error_string(rc).decode())
    count_launch(LAUNCHES, KERNEL)
    return out


def _library_bwd():
    from mr_mt3_tpu_torch.ops import cuda_build
    lib = cuda_build.load(KERNEL_BWD)
    if lib.fab_launch.argtypes is None:
        lib.fab_launch.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.fab_launch.restype = ctypes.c_int
        lib.fab_error_string.argtypes = [ctypes.c_int]
        lib.fab_error_string.restype = ctypes.c_char_p
        for name in ('fab_rows', 'fab_tile', 'fab_key_block', 'fab_max_d'):
            getattr(lib, name).restype = ctypes.c_int
        for name in ('fab_smem_dq', 'fab_smem_dkdv'):
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_longlong
        if (lib.fab_rows(), lib.fab_tile(), lib.fab_key_block(),
                lib.fab_max_d()) != (_ROWS, _KT, _KB, _MAX_D) or any(
                (lib.fab_smem_dq(d), lib.fab_smem_dkdv(d))
                != smem_bytes_bwd(d) for d in (24, 64, 128)):
            raise RuntimeError('fused_attention backward: the wrapper and '
                               'the CUDA source disagree on the tile '
                               'constants')
    return lib


def fused_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, do: torch.Tensor,
                                  causal: bool, kv_valid: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Launch the backward kernels on the current stream; q/k/v/do
    bfloat16, contiguous, k/v already padded. Returns (dq, dk, dv)
    bfloat16, dk/dv with the padded length (zero past kv_valid)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    for name, t in (('q', q), ('k', k), ('v', v), ('do', do)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f'the CUDA kernel takes bfloat16 only ({name} '
                             f'is {t.dtype}); float32 runs only on the CPU')
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f'{name} is on {t.device}, not {q.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if t.data_ptr() % 16:   # rows are read 16 bytes at a time
            raise ValueError(f'{name} must be 16-byte aligned')
    if do.shape != q.shape:
        raise ValueError(f'do {tuple(do.shape)} does not match q '
                         f'{tuple(q.shape)}')
    if lk % _KB:
        raise ValueError(f'Lk {lk} is not padded to a multiple of {_KB}')
    if not 1 <= kv_valid <= lk:
        raise ValueError(f'kv_valid {kv_valid} outside 1..{lk}')
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty((3, b, h, lq), dtype=torch.float32, device=q.device)
    lib = _library_bwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fab_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(), stats.data_ptr(), b, lq, lk, h, d,
                            int(kv_valid), int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError('fused_attention_bwd launch failed: '
                           + lib.fab_error_string(rc).decode())
    count_launch(LAUNCHES, KERNEL_BWD)
    return dq, dk, dv


def _operand(t: torch.Tensor) -> torch.Tensor:
    """t as the kernels read it: contiguous and 16-byte aligned."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _FusedAttention(torch.autograd.Function):
    """Attention over already padded K/V: the CUDA kernels on the card, the
    plain versions on the CPU. The backward keeps q, k and v and recomputes
    the probabilities, as the TPU kernel does."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kv_valid: int):
        ctx.causal, ctx.kv_valid = causal, kv_valid
        ctx.save_for_backward(q, k, v)
        if q.is_cuda:
            return fused_attention_cuda(_operand(q), _operand(k),
                                        _operand(v), causal, kv_valid)
        return fused_attention_reference(q, k, v, causal, kv_valid)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if q.is_cuda:
            grads = fused_attention_backward_cuda(
                _operand(q), _operand(k), _operand(v), _operand(do),
                ctx.causal, ctx.kv_valid)
        else:
            grads = fused_attention_backward_reference(
                q, k, v, do.to(q.dtype), ctx.causal, ctx.kv_valid)
        return (*grads, None, None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    kv_valid: Optional[int] = None) -> torch.Tensor:
    """Fused unscaled-softmax attention, differentiable.

    q: (B, Lq, H, D); k/v: (B, Lk, H, D), bfloat16 (float32 on the CPU
    only), D <= 128 a multiple of 8. Lk is padded to a multiple of 128 and
    masked by kv_valid (default: the real Lk); the gradients of the padded
    rows are trimmed. Returns (B, Lq, H, D) in q's dtype."""
    _check_args(q, k, v)
    if q.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {q.device}')
    k, v, real_lk = _pad_kv(k, v)
    valid = real_lk if kv_valid is None else int(kv_valid)
    if not 1 <= valid <= k.shape[1]:
        raise ValueError(f'kv_valid {valid} outside 1..{k.shape[1]}')
    return _FusedAttention.apply(q, k, v, bool(causal), valid)
