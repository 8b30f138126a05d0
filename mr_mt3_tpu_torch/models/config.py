"""Model configuration (port of mr_mt3_tpu/models/config.py).

Field values mirror the reference's T5Config YAML surface
(reference: config/model/MT3Net.yaml) plus the segmem knobs
(reference: config/model/MT3NetSegMem*.yaml).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MT3Config:
    vocab_size: int = 1536
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 1024
    num_heads: int = 6
    num_encoder_layers: int = 8
    num_decoder_layers: int = 8
    layer_norm_epsilon: float = 1e-6
    mel_bins: int = 512
    max_positions: int = 5000  # sinusoidal table length

    decoder_start_token_id: int = 0
    pad_token_id: int = 0
    eos_token_id: int = 1

    # segment memory family (MR-MT3): None = vanilla MT3, the only family
    # the port serves so far; a segmem config is rejected, not misread
    segmem_variant: Optional[str] = None

    # compute dtype for activations ('float32' or 'bfloat16'); params fp32
    dtype: str = 'float32'

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == 'bfloat16' else torch.float32

    @property
    def has_segmem(self) -> bool:
        return self.segmem_variant is not None


def config_from_dict(d: dict) -> MT3Config:
    """Build from a reference-style T5Config dict (hydra model YAML)."""
    return MT3Config(
        vocab_size=d.get('vocab_size', 1536),
        d_model=d.get('d_model', 512),
        d_kv=d.get('d_kv', 64),
        d_ff=d.get('d_ff', 1024),
        num_heads=d.get('num_heads', 6),
        num_encoder_layers=d.get('num_layers', 8),
        num_decoder_layers=d.get('num_decoder_layers',
                                 d.get('num_layers', 8)),
        layer_norm_epsilon=float(d.get('layer_norm_epsilon', 1e-6)),
        decoder_start_token_id=d.get('decoder_start_token_id', 0),
        pad_token_id=d.get('pad_token_id', 0),
        eos_token_id=d.get('eos_token_id', 1),
        segmem_variant=d.get('segmem_variant'),
        dtype=d.get('dtype', 'float32'),
    )
