"""Int8-weight products of the 'int8' decode tier and the symmetric integer
quantizers of every integer tier (port of mr_mt3_tpu/ops/int8_matmul.py
and mr_mt3_tpu/ops/fused_decode.py::quantize_columns_int4).

  * int8_matmul    -- y = (x @ W) * col_scale (the lm_head);
  * int8_gated_ff  -- a decoder layer's gated-GELU feed-forward with int8
                      wi_0, wi_1 and wo in one launch; the intermediate is
                      rounded to bf16 whatever h's type, as the TPU kernel
                      does, and handed between the launch's two phases
                      through a scratch the wrapper allocates.
For CUDA tensors each wrapper launches the hand-written kernel of
csrc/int8_matmul.cu (it replaces the TPU kernels int8_matmul.py::
int8_matmul and ::int8_gated_ff); for CPU tensors it runs the plain
PyTorch version of the same math (int8_matmul_reference,
int8_gated_ff_reference). Nothing falls back: a CUDA tensor launches the
kernel or raises. Every sum is f32 over the codes' exact values, each
column scale is applied after its dot, and the output has the input's
type (float32 or bfloat16).

int4 codes are stored two to a byte along the LAST axis (the one the CUDA
window kernel reads contiguously): byte i holds code 2i in its low nibble
and code 2i+1 in its high nibble, each as a 4-bit two's-complement value.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from mr_mt3_tpu_torch.ops.cuda_build import check_operand, count_launch

from mr_mt3_tpu_torch.models.mt3 import gelu_new

_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}   # csrc: DType

# launches of the CUDA kernels; only the kernel paths add to them
LAUNCHES = {'int8_matmul': 0, 'int8_gated_ff': 0}
# the feed-forward kernel's grid barrier words, by (device index, stream)
_BARRIERS = {}


def quantize_columns(w: torch.Tensor, qmax: int = 127
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K, N) float -> ((..., K, N) int8 codes in [-qmax, qmax],
    (..., N) f32 scales), one scale per output column: scale =
    max(max|w| over K, 1e-12) / qmax, codes = clip(round(w / scale)).
    torch.round rounds half to even, as jnp.round does. An all-zero
    column gets the 1e-12 floor and code 0."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(-2), min=1e-12) / qmax
    codes = torch.clamp(torch.round(w / scale.unsqueeze(-2)), -qmax, qmax)
    return codes.to(torch.int8), scale


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-7, 7], even last axis -> uint8, two per byte."""
    if codes.shape[-1] % 2:
        raise ValueError(f'int4 packing needs an even last axis, got '
                         f'{codes.shape[-1]}')
    nib = codes.to(torch.int32) & 0xF
    return (nib[..., 0::2] | (nib[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8, two codes per byte -> int8 codes (last axis doubled)."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return torch.stack([lo, hi], -1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1]).to(torch.int8)


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """The plain version of int8_matmul."""
    return ((x.float() @ w_q.float()) * scale).to(x.dtype)


def int8_gated_ff_reference(h: torch.Tensor,
                            w0_q: torch.Tensor, s0: torch.Tensor,
                            w1_q: torch.Tensor, s1: torch.Tensor,
                            wo_q: torch.Tensor, so: torch.Tensor
                            ) -> torch.Tensor:
    """The plain version of int8_gated_ff."""
    hf = h.float()
    a = (hf @ w0_q.float()) * s0
    b = (hf @ w1_q.float()) * s1
    g = (gelu_new(a) * b).to(torch.bfloat16).float()
    return ((g @ wo_q.float()) * so).to(h.dtype)


def _check_columns(**dims: int) -> None:
    for name, n in dims.items():
        if n < 4 or n % 4:
            raise ValueError(f'{name} {n} is not a multiple of 4 (the '
                             f'kernel reads 4 weight columns at a time)')


def _library():
    from mr_mt3_tpu_torch.ops import cuda_build
    lib = cuda_build.load('int8_matmul')
    if lib.i8mm_launch.argtypes is None:
        lib.i8mm_launch.argtypes = [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.i8mm_launch.restype = ctypes.c_int
        lib.i8ff_launch.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        lib.i8ff_launch.restype = ctypes.c_int
        lib.i8mm_error_string.argtypes = [ctypes.c_int]
        lib.i8mm_error_string.restype = ctypes.c_char_p
    return lib


def _barrier(dev: torch.device, stream: int) -> torch.Tensor:
    """The feed-forward kernel's grid barrier words for (device, stream):
    zeroed once, left zero by every launch; two streams never share one."""
    key = (dev.index, stream)
    if key not in _BARRIERS:
        _BARRIERS[key] = torch.zeros((2,), dtype=torch.int32, device=dev)
    return _BARRIERS[key]


def _raise_on(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f'{kernel} launch failed: '
                           + lib.i8mm_error_string(rc).decode())


def int8_matmul_cuda(x: torch.Tensor, w_q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """Launch the int8_matmul kernel on the current stream."""
    dev = x.device
    if x.dim() != 2 or w_q.dim() != 2:
        raise ValueError('int8_matmul takes x (B, K) and w_q (K, N)')
    b, k = x.shape
    n = w_q.shape[1]
    check_operand('x', x, tuple(_DTYPE_ID), (b, k), dev)
    check_operand('w_q', w_q, torch.int8, (k, n), dev, align=4)
    check_operand('scale', scale, torch.float32, (1, n), dev)
    _check_columns(N=n)
    out = torch.empty((b, n), dtype=x.dtype, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.i8mm_launch(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                             out.data_ptr(), b, k, n, _DTYPE_ID[x.dtype],
                             stream)
    _raise_on(lib, rc, 'int8_matmul')
    count_launch(LAUNCHES, 'int8_matmul')
    return out


def int8_gated_ff_cuda(h: torch.Tensor,
                       w0_q: torch.Tensor, s0: torch.Tensor,
                       w1_q: torch.Tensor, s1: torch.Tensor,
                       wo_q: torch.Tensor, so: torch.Tensor) -> torch.Tensor:
    """Launch the int8_gated_ff kernel on the current stream."""
    dev = h.device
    if h.dim() != 2 or w0_q.dim() != 2:
        raise ValueError('int8_gated_ff takes h (B, D) and wi_0 (D, F)')
    b, d = h.shape
    f = w0_q.shape[1]
    check_operand('h', h, tuple(_DTYPE_ID), (b, d), dev)
    for name, t, shape in (('wi_0', w0_q, (d, f)), ('wi_1', w1_q, (d, f)),
                           ('wo', wo_q, (f, d))):
        check_operand(name, t, torch.int8, shape, dev, align=4)
    for name, t, n in (('s0', s0, f), ('s1', s1, f), ('so', so, d)):
        check_operand(name, t, torch.float32, (1, n), dev)
    _check_columns(d_model=d, d_ff=f)
    out = torch.empty((b, d), dtype=h.dtype, device=dev)
    # the intermediate g, rows of f rounded up to 8 (16-byte rows)
    g = torch.empty((b, -(-f // 8) * 8), dtype=torch.bfloat16, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.i8ff_launch(h.data_ptr(), w0_q.data_ptr(), w1_q.data_ptr(),
                             wo_q.data_ptr(), s0.data_ptr(), s1.data_ptr(),
                             so.data_ptr(), out.data_ptr(), b, d, f,
                             _DTYPE_ID[h.dtype], stream, g.data_ptr(),
                             _barrier(dev, stream).data_ptr())
    _raise_on(lib, rc, 'int8_gated_ff')
    count_launch(LAUNCHES, 'int8_gated_ff')
    return out


def _route(x: torch.Tensor, cuda, reference, *args) -> torch.Tensor:
    if x.is_cuda:
        return cuda(x, *args)
    if x.device.type == 'cpu':
        return reference(x, *args)
    raise ValueError(f'unsupported device {x.device}')


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (B, K) float32 or bfloat16 @ w_q (K, N) int8 * scale (1, N) f32
    -> (B, N) in x's dtype."""
    return _route(x, int8_matmul_cuda, int8_matmul_reference, w_q, scale)


def int8_gated_ff(h: torch.Tensor,
                  w0_q: torch.Tensor, s0: torch.Tensor,
                  w1_q: torch.Tensor, s1: torch.Tensor,
                  wo_q: torch.Tensor, so: torch.Tensor) -> torch.Tensor:
    """Gated-GELU feed-forward with int8 weights, h (B, D) -> (B, D):
    (bf16(gelu_new(h @ w0 * s0) * (h @ w1 * s1)) @ wo) * so, in h's dtype;
    w0, w1 (D, F) and wo (F, D) int8, s0, s1 (1, F) and so (1, D) f32."""
    return _route(h, int8_gated_ff_cuda, int8_gated_ff_reference,
                  w0_q, s0, w1_q, s1, wo_q, so)
