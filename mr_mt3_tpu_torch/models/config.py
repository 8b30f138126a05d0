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

    # segment memory family (MR-MT3)
    # None = vanilla MT3; 'decoder_prepend' = v1; 'encoder_append' = v2 /
    # v2-with-prev (the paper's model)
    segmem_variant: Optional[str] = None
    segmem_length: int = 64
    segmem_num_layers: int = 1
    # first-segment decode memory seed: 'tie_eos' (v2-with-prev) or 'eos'
    # (v1 / v2)
    segmem_seed: str = 'tie_eos'

    # compute dtype for activations ('float32' or 'bfloat16'); params fp32
    dtype: str = 'float32'
    # full-sequence attention (models/mt3.py Attention.attend):
    #   'auto'   -- the CUDA fused_attention kernel for a bfloat16 model on
    #               the card, einsum otherwise (CPU, fp32 parity runs);
    #   'einsum' -- always the plain matmul + softmax;
    #   'fused'  -- always the fused path (its plain version on the CPU).
    attention_kernel: str = 'auto'

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == 'bfloat16' else torch.float32

    @property
    def has_segmem(self) -> bool:
        return self.segmem_variant is not None

    def replace(self, **kwargs) -> 'MT3Config':
        return dataclasses.replace(self, **kwargs)


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
        segmem_length=d.get('segmem_length', 64),
        segmem_num_layers=d.get('segmem_num_layers', 1),
        segmem_seed=d.get('segmem_seed', 'tie_eos'),
        dtype=d.get('dtype', 'float32'),
        attention_kernel=d.get('attention_kernel', 'auto'),
    )
