"""Weights bridge: JAX parameter trees and reference torch checkpoints.

The port's MT3 uses the reference HF-T5 state-dict names natively, so a
reference .pth/.pt/.ckpt loads with load_state_dict once the Lightning
'model.' prefix and the keys that carry no information are dropped.
state_dict_from_jax_params is the port's own copy of the JAX package's
export_to_torch_state_dict (mr_mt3_tpu/utils/checkpoint_import.py:138): it
turns a JAX parameter tree, given as numpy arrays, into the port's
state_dict, transposing Dense kernels (flax (in, out) -> torch (out, in)).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from mr_mt3_tpu_torch.models.config import MT3Config

_ATTN = ('q', 'k', 'v', 'o')
_FF = ('wi_0', 'wi_1', 'wo')

# keys that exist in reference state dicts but carry no information here
_IGNORED_PATTERNS = (
    re.compile(r'\.pos_emb\.inv_freq$'),
    re.compile(r'^(encoder|decoder|segmem_encoder)\.embed_tokens\.weight$'),
    re.compile(r'^shared\.weight$'),
    re.compile(r'relative_attention_bias'),
    re.compile(r'^segmem_'),
)


def state_dict_from_jax_params(params: Mapping[str, Any],
                               cfg: MT3Config) -> Dict[str, torch.Tensor]:
    """JAX (flax) parameter tree of numpy arrays -> the port's state_dict."""
    out: Dict[str, np.ndarray] = {}

    def get(*path):
        node = params
        for k in path:
            node = node[k]
        return np.asarray(node, np.float32)

    out['proj.weight'] = get('proj', 'kernel').T
    out['decoder_embed_tokens.weight'] = get('token_embed', 'embedding')
    out['lm_head.weight'] = get('lm_head', 'kernel').T
    for stack, n_layers, is_decoder in (
            ('encoder', cfg.num_encoder_layers, False),
            ('decoder', cfg.num_decoder_layers, True)):
        for i in range(n_layers):
            block = f'block_{i}'
            prefix = f'{stack}.block.{i}.layer'
            for name in _ATTN:
                out[f'{prefix}.0.SelfAttention.{name}.weight'] = get(
                    stack, block, 'self_attn', name, 'kernel').T
            out[f'{prefix}.0.layer_norm.weight'] = get(
                stack, block, 'self_norm', 'weight')
            ff_layer = 1
            if is_decoder:
                for name in _ATTN:
                    out[f'{prefix}.1.EncDecAttention.{name}.weight'] = get(
                        stack, block, 'cross_attn', name, 'kernel').T
                out[f'{prefix}.1.layer_norm.weight'] = get(
                    stack, block, 'cross_norm', 'weight')
                ff_layer = 2
            for name in _FF:
                out[f'{prefix}.{ff_layer}.DenseReluDense.{name}.weight'] = \
                    get(stack, block, 'ff', name, 'kernel').T
            out[f'{prefix}.{ff_layer}.layer_norm.weight'] = get(
                stack, block, 'ff_norm', 'weight')
        out[f'{stack}.final_layer_norm.weight'] = get(
            stack, 'final_norm', 'weight')
    return {k: torch.tensor(v) for k, v in out.items()}


def load_torch_checkpoint(path) -> Dict[str, torch.Tensor]:
    """Reference .pth/.pt/.ckpt file -> state_dict in the port's names.

    Lightning .ckpt files store weights under 'state_dict' with a 'model.'
    prefix (reference: train.py:105-116 strips it the same way)."""
    blob = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(blob, dict) and 'state_dict' in blob:
        blob = blob['state_dict']
    state_dict = {}
    for key, value in blob.items():
        key = key.removeprefix('model.')
        if any(p.search(key) for p in _IGNORED_PATTERNS):
            continue
        state_dict[key] = torch.as_tensor(value).float()
    return state_dict
