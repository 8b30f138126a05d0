"""Symmetric integer quantizers of the fused decode tiers (port of
mr_mt3_tpu/ops/int8_matmul.py::quantize_columns and
mr_mt3_tpu/ops/fused_decode.py::quantize_columns_int4).

The int8_matmul kernel of that module is not ported yet; only its
quantizer is, which the window kernel's int8 ('fused') and int4
('fused_int4') modes share.

int4 codes are stored two to a byte along the LAST axis (the one the CUDA
kernel reads contiguously): byte i holds code 2i in its low nibble and
code 2i+1 in its high nibble, each as a 4-bit two's-complement value.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
