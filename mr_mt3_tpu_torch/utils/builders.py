"""Builders wiring configs to the port's model and weights (port of
mr_mt3_tpu/utils/builders.py:21-51, 143-175)."""

from __future__ import annotations

import math
import os

import torch

from mr_mt3_tpu_torch.models import MT3
from mr_mt3_tpu_torch.models.config import config_from_dict
from mr_mt3_tpu_torch.utils.config import ConfigNode


def build_model(cfg: ConfigNode) -> MT3:
    """cfg.model -> MT3 module on the CPU (vanilla or segment memory; the
    segmem fields live in the model YAML)."""
    model_dict = cfg.model.config.to_dict()
    model_dict['segmem_variant'] = cfg.model.get('segmem_variant')
    model_dict['segmem_length'] = cfg.model.get('segmem_length', 64)
    model_dict['segmem_num_layers'] = cfg.model.get('segmem_num_layers', 1)
    # v2 seeds its decode memory with [EOS] only; with-prev adds the tie
    # token (reference: models/t5_segmem_v2.py:189-195 vs
    # t5_segmem_v2_with_prev.py:246-259)
    task = cfg.model.get('task') or {}
    if task.get('segmem') == 'v2':
        model_dict['segmem_seed'] = 'eos'
    precision = str((cfg.get('trainer') or {}).get('precision', '32'))
    if precision in ('bf16', 'bf16-mixed', 'bfloat16'):
        model_dict['dtype'] = 'bfloat16'
    return MT3(config_from_dict(model_dict))


@torch.no_grad()
def init_params(model: MT3, seed: int = 0) -> MT3:
    """Seeded random init from a CPU torch.Generator, so one seed gives the
    same weights on every device: Linear and Embedding weights are
    N(0, 1/fan_in) (fan_in = d_model for the embedding), norms are ones."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith('layer_norm.weight'):
            val = torch.ones(p.shape)
        else:
            fan_in = p.shape[1]
            val = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
        p.copy_(val)
    return model


def load_weights(path: str, model: MT3, strict: bool = False) -> MT3:
    """Load a reference torch checkpoint (.pth/.pt/.ckpt) into `model`.

    strict=True raises when the checkpoint misses a parameter (torch
    strict-load semantics); keys the model does not have are reported."""
    if path.endswith(('.pth', '.pt', '.ckpt')) and os.path.isfile(path):
        from mr_mt3_tpu_torch.utils.checkpoint_import import (
            load_torch_checkpoint)
        missing, unexpected = model.load_state_dict(
            load_torch_checkpoint(path), strict=False)
        if unexpected:
            print(f'load_weights: {len(unexpected)} checkpoint keys not '
                  f'mapped (e.g. {unexpected[:3]})')
        if strict and missing:
            raise ValueError('strict weight load failed\n  missing: '
                             + ', '.join(missing))
        return model
    if os.path.isdir(path):
        raise NotImplementedError('Orbax checkpoints not yet ported')
    raise FileNotFoundError(path)
