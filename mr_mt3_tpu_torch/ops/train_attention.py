"""Fused unscaled-softmax attention, forward (port of
mr_mt3_tpu/ops/train_attention.py::fused_attention).

fused_attention runs the hand-written CUDA kernel csrc/fused_attention_fwd.cu
(it replaces the TPU kernel's forward, train_attention.py::_fwd_kernel) on
bfloat16 CUDA tensors, and fused_attention_reference, the plain PyTorch
version of the same math in the same order, on CPU tensors (bfloat16 or
float32). Nothing falls back: a CUDA tensor launches the kernel or raises,
and the kernel takes bfloat16 only (models/mt3.py routes only bf16 models
to it).

The math, per (batch row, head): s = q k^T with f32 sums, NOT scaled (T5);
columns >= kv_valid and, with causal, columns > row set to -1e30; an f32
softmax normalized before the probabilities are rounded to v's dtype; then
o = p v with f32 sums, in q's dtype. K/V are zero-padded to a multiple of
128 rows and masked by kv_valid, as the TPU kernel pads them (_pad_kv).

Forward only: the backward (the TPU kernel's _bwd_kernel) belongs to
training, which is not ported, so a call that would need a gradient
raises. The TPU kernel's batch blocking (_pick_block_b) and its GSPMD
partitioning rules have no counterpart: the CUDA grid covers (row tile,
head, batch row) and one card runs it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_LANE = 128       # K/V rows are padded to a multiple of this (TPU lane)
_ROWS = 16        # query rows per block (csrc: ROWS)
_KT = 128         # keys per K/V tile (csrc: KT)
_MAX_D = 128      # head width limit (csrc: MAX_D)
# the H100's shared memory a block can opt into (227 KB)
_MAX_SMEM = 232448
_DTYPES = (torch.bfloat16, torch.float32)   # the plain version's

KERNEL = 'fused_attention_fwd'
# launches of the CUDA kernel; only the kernel path adds to it
LAUNCHES = {KERNEL: 0}


def smem_bytes(lk: int, d: int) -> int:
    """Shared memory of one block (csrc: smem_bytes): ROWS f32 score rows
    of lk columns, the ROWS query rows and one K/V tile with the head width
    padded to a multiple of 16, and the value shares."""
    dp = -(-d // 16) * 16
    return 4 * _ROWS * lk + 2 * _ROWS * dp + 2 * _KT * dp + 4 * _ROWS * 128


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
    lq, lk = q.shape[1], k.shape[1]
    valid = lk if kv_valid is None else kv_valid
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
    col = torch.arange(lk, device=q.device)
    keep = (col < valid)[None, :].expand(lq, lk)
    if causal:
        row = torch.arange(lq, device=q.device)
        keep = keep & (col[None, :] <= row[:, None])
    s = torch.where(keep, s, torch.tensor(-1e30, device=q.device))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    return torch.einsum('bhqk,bkhd->bqhd', p.float(), v.float()).to(q.dtype)


def _library():
    from mr_mt3_tpu_torch.ops import cuda_build
    lib = cuda_build.load(KERNEL)
    if lib.faf_launch.argtypes is None:
        lib.faf_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        lib.faf_launch.restype = ctypes.c_int
        lib.faf_error_string.argtypes = [ctypes.c_int]
        lib.faf_error_string.restype = ctypes.c_char_p
        for name in ('faf_rows', 'faf_max_d'):
            getattr(lib, name).restype = ctypes.c_int
        lib.faf_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.faf_smem_bytes.restype = ctypes.c_longlong
        if (lib.faf_rows(), lib.faf_max_d()) != (_ROWS, _MAX_D) or any(
                lib.faf_smem_bytes(lk, d) != smem_bytes(lk, d)
                for lk, d in ((128, 24), (1024, 64), (384, 128))):
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
    need = smem_bytes(lk, d)
    if need > _MAX_SMEM:
        raise ValueError(f'Lk {lk} x {_ROWS} f32 score rows need {need} '
                         f'bytes of shared memory, more than the '
                         f'{_MAX_SMEM} a block can use')
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
    LAUNCHES[KERNEL] += 1
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    kv_valid: Optional[int] = None) -> torch.Tensor:
    """Fused unscaled-softmax attention, forward.

    q: (B, Lq, H, D); k/v: (B, Lk, H, D), bfloat16 (float32 on the CPU
    only), D <= 128 a multiple of 8. Lk is padded to a multiple of 128 and masked by
    kv_valid (default: the real Lk). Returns (B, Lq, H, D) in q's dtype.
    Raises where autograd would need the backward (not ported)."""
    _check_args(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError('fused_attention: the backward is not yet '
                           'ported; call it under torch.no_grad()')
    k, v, real_lk = _pad_kv(k, v)
    valid = real_lk if kv_valid is None else int(kv_valid)
    if not 1 <= valid <= k.shape[1]:
        raise ValueError(f'kv_valid {valid} outside 1..{k.shape[1]}')
    if q.is_cuda:
        q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
        return fused_attention_cuda(q, k, v, causal, valid)
    if q.device.type == 'cpu':
        return fused_attention_reference(q, k, v, causal, valid)
    raise ValueError(f'unsupported device {q.device}')
