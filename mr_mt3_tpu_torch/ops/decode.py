"""Greedy autoregressive decoding (port of mr_mt3_tpu/ops/decode.py).

Outputs match the reference token-stream format: position 0 is the decoder
start token, finished rows pad with pad_token_id, EOS is included.
"""

from __future__ import annotations

from typing import Optional

import torch

from mr_mt3_tpu_torch.models.mt3 import MT3
from mr_mt3_tpu_torch.ops.fast_decode import (
    DecodeParams,
    greedy_loop_fast,
    stack_decode_params,
)

PORTED_TIERS = ('none', 'fused_bf16', 'fused', 'fused_int4')
_JAX_TIERS = ('none', 'int8', 'int8_kv', 'fused', 'fused_bf16', 'fused_int4')


def check_quantize(quantize: str) -> None:
    """Raise for a tier this port does not run (yet)."""
    if quantize not in _JAX_TIERS:
        raise ValueError(f'unknown quantize mode: {quantize!r}')
    if quantize not in PORTED_TIERS:
        raise NotImplementedError(f'quantize={quantize!r} not yet ported')


@torch.no_grad()
def greedy_decode(model: MT3, mel: torch.Tensor, max_length: int = 1024,
                  quantize: str = 'none',
                  valid_mask: Optional[torch.Tensor] = None,
                  dp: Optional[DecodeParams] = None) -> torch.Tensor:
    """Vanilla MT3 transcription decode.

    mel (B, frames, mel_bins) -> tokens (B, max_length + 1) with a leading
    start token. quantize:
      'none'       — the exact KV-cache loop at the model's dtype;
      'fused_bf16' — the whole-decoder CUDA window kernel: bf16 weights
                     and K/V with f32 sums (its plain PyTorch version for
                     CPU tensors);
      'fused'      — the same kernel in int8 mode: int8 weights and K/V
                     with f32 scales, int32 attention dots;
      'fused_int4' — int4 weights and K/V (codes in [-7, 7]); the
                     serving default on the card.
    'int8' and 'int8_kv' are not yet ported.
    dp: DecodeParams already stacked for this quantize tier (callers that
    decode repeatedly keep them)."""
    check_quantize(quantize)
    encoder_out = model.encode_audio(mel)
    if dp is None:
        dp = stack_decode_params(model, quantize=quantize)
    return greedy_loop_fast(model.cfg, dp, encoder_out, max_length,
                            quantize=quantize, valid_mask=valid_mask)
