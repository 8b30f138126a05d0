"""One-query decode attention over an int8 K/V cache, the 'int8_kv' decode
tier (port of mr_mt3_tpu/ops/int8_attention.py).

int8_decode_attention launches the hand-written CUDA kernel
csrc/int8_decode_attention.cu for CUDA tensors (it replaces the TPU kernel
int8_attention.py::int8_decode_attention) and runs
int8_decode_attention_reference, the plain PyTorch version of the same
math, for CPU tensors. Nothing falls back: a CUDA tensor launches the
kernel or raises.

Per (batch row, head): q quantized to int8 (scale max|q| / 127, floor
1e-12); int8 x int8 scores, rescaled by that scale and each position's K
scale; positions above `position` masked; an f32 softmax; the
probabilities times each position's V scale, requantized to int8 (scale
max / 127, floor 1e-20); the int8 x int8 value sums times that scale. A
masked position contributes exact zeros, so both versions stop at
`position`, and a cache of any length past it gives the same result.

`position` is a host int, or a 0-d int32 tensor on q's device with a host
upper bound n_max (the decode loop's phase bound): the TPU kernel reads its
position from SMEM, and the CUDA kernel then reads it from device memory,
so that one launch captured into a CUDA graph serves every position below
n_max. The launch is sized for n_max positions and attends over position +
1 of them; a device position outside 0..n_max - 1 makes the outputs NaN
(the host cannot see it without a sync), while a host-known one (an int,
or a CPU tensor for the plain version) past n_max raises.

The layout is the JAX package's: q (B, H, dk); codes (B, H, dk, K), the
positions last; scales (B, H, 1, K). The CUDA kernel copies 16 positions
at a time where K and the pointers allow it, else 8 or 4, so K must be a
multiple of POSITION_ALIGN there: the port's caches are allocated so
(ops/fast_decode.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mr_mt3_tpu_torch.ops.cuda_build import check_operand, count_launch

_MAX_DK = 128     # the kernel's head width limit (csrc: MAX_DK)
# the kernel's narrowest copy is 4 positions: cache lengths are multiples
# of this (ops/fast_decode.py allocates and pads its caches so)
POSITION_ALIGN = 4
_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}   # csrc: DType

KERNEL = 'int8_decode_attention'
# launches of the CUDA kernel; only the kernel path adds to them
LAUNCHES = {KERNEL: 0}


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., dk, K) float -> ((..., dk, K) int8 codes, (..., 1, K) f32
    scales), one scale per position shared across dk: max|x| / 127,
    floored at 1e-12 AFTER the division, as the JAX package floors it (the
    window kernel's quantize_rows floors before dividing, which gives an
    all-zero row another scale)."""
    x = x.float()
    scale = torch.clamp(x.abs().amax(-2, keepdim=True) / 127, min=1e-12)
    codes = torch.clamp(torch.round(x / scale), -127, 127)
    return codes.to(torch.int8), scale


def _host_position(position, n_max: Optional[int], k_len: int) -> int:
    """A host-known position checked against the cache and n_max."""
    position = int(position)
    limit = k_len if n_max is None else min(int(n_max), k_len)
    if not 0 <= position < limit:
        raise ValueError(f'position {position} outside 0..{limit - 1}')
    return position


def int8_decode_attention_reference(q: torch.Tensor,
                                    k_q: torch.Tensor, k_scale: torch.Tensor,
                                    v_q: torch.Tensor, v_scale: torch.Tensor,
                                    position, n_max: Optional[int] = None
                                    ) -> torch.Tensor:
    """The plain version of int8_decode_attention. The integer dots run
    in float64, exact for any cache length (f32 holds them exactly only
    while the value sums stay below 2^24, ~1040 positions). position is an
    int or a 0-d tensor (read here: the plain version syncs)."""
    b, h, dk = q.shape
    n = _host_position(position, n_max, k_q.shape[-1]) + 1
    qf = q.float()
    qs = torch.clamp(qf.abs().amax(-1, keepdim=True), min=1e-12) / 127
    qi = torch.clamp(torch.round(qf / qs), -127, 127)
    s = torch.einsum('bhd,bhdk->bhk', qi.double(),
                     k_q[..., :n].double()).float()
    s = s * qs * k_scale[:, :, 0, :n]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    pv = e / e.sum(-1, keepdim=True) * v_scale[:, :, 0, :n]
    ps = torch.clamp(pv.abs().amax(-1, keepdim=True), min=1e-20) / 127
    pi = torch.clamp(torch.round(pv / ps), -127, 127)
    out = torch.einsum('bhk,bhdk->bhd', pi.double(),
                       v_q[..., :n].double()).float() * ps
    return out.reshape(b, h * dk).to(q.dtype)


def _library():
    from mr_mt3_tpu_torch.ops import cuda_build
    lib = cuda_build.load(KERNEL)
    if lib.i8att_launch.argtypes is None:
        lib.i8att_launch.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.i8att_launch.restype = ctypes.c_int
        lib.i8att_launch_dev.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
        lib.i8att_launch_dev.restype = ctypes.c_int
        lib.i8att_error_string.argtypes = [ctypes.c_int]
        lib.i8att_error_string.restype = ctypes.c_char_p
        lib.i8att_max_dk.restype = ctypes.c_int
        if lib.i8att_max_dk() != _MAX_DK:
            raise RuntimeError('int8_decode_attention: the wrapper and the '
                               'CUDA source disagree on the head width limit')
    return lib


def int8_decode_attention_cuda(q: torch.Tensor,
                               k_q: torch.Tensor, k_scale: torch.Tensor,
                               v_q: torch.Tensor, v_scale: torch.Tensor,
                               position, n_max: Optional[int] = None
                               ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: the host-int entry
    for an int position, the device-position entry for a tensor one."""
    dev = q.device
    if q.dim() != 3 or k_q.dim() != 4:
        raise ValueError('int8_decode_attention takes q (B, H, dk) and '
                         'codes (B, H, dk, K)')
    b, h, dk = q.shape
    k_len = k_q.shape[-1]
    check_operand('q', q, tuple(_DTYPE_ID), (b, h, dk), dev)
    for name, t in (('k_q', k_q), ('v_q', v_q)):
        check_operand(name, t, torch.int8, (b, h, dk, k_len), dev, align=4)
    for name, t in (('k_scale', k_scale), ('v_scale', v_scale)):
        check_operand(name, t, torch.float32, (b, h, 1, k_len), dev)
    if dk > _MAX_DK:
        raise ValueError(f'd_kv {dk} is above the kernel limit {_MAX_DK}')
    if k_len % POSITION_ALIGN:
        raise ValueError(f'cache length {k_len} is not a multiple of '
                         f'{POSITION_ALIGN} (the kernel copies at least '
                         f'{POSITION_ALIGN} positions at a time)')
    on_device = isinstance(position, torch.Tensor)
    if on_device:
        check_operand('position', position, torch.int32, (), dev, align=4)
        if n_max is None or not 1 <= int(n_max) <= k_len:
            raise ValueError(f'a device position needs n_max in '
                             f'1..{k_len} (got {n_max})')
    else:
        position = _host_position(position, n_max, k_len)
    out = torch.empty((b, h * dk), dtype=q.dtype, device=dev)
    lib = _library()
    ptrs = (q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(),
            v_q.data_ptr(), v_scale.data_ptr(), out.data_ptr(), b, h, dk,
            k_len)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if on_device:
            rc = lib.i8att_launch_dev(*ptrs, position.data_ptr(),
                                      int(n_max), _DTYPE_ID[q.dtype],
                                      stream)
        else:
            rc = lib.i8att_launch(*ptrs, position, _DTYPE_ID[q.dtype],
                                  stream)
    if rc != 0:
        raise RuntimeError(f'{KERNEL} launch failed: '
                           + lib.i8att_error_string(rc).decode())
    count_launch(LAUNCHES, KERNEL)
    return out


def int8_decode_attention(q: torch.Tensor,
                          k_q: torch.Tensor, k_scale: torch.Tensor,
                          v_q: torch.Tensor, v_scale: torch.Tensor,
                          position, n_max: Optional[int] = None
                          ) -> torch.Tensor:
    """Single-query attention over an int8 K/V cache.

    q (B, H, dk) float32 or bfloat16; k_q, v_q (B, H, dk, K) int8; k_scale,
    v_scale (B, H, 1, K) f32; only positions <= position take part.
    position: an int, or a 0-d int32 tensor on q's device with n_max, the
    bound it stays below. Returns (B, H * dk) in q's dtype."""
    if q.is_cuda:
        return int8_decode_attention_cuda(q, k_q, k_scale, v_q, v_scale,
                                          position, n_max)
    if q.device.type == 'cpu':
        return int8_decode_attention_reference(q, k_q, k_scale, v_q,
                                               v_scale, position, n_max)
    raise ValueError(f'unsupported device {q.device}')
