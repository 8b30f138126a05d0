"""Weights bridge: JAX parameter trees and reference torch checkpoints.

The port's MT3 uses the reference HF-T5 state-dict names natively, so a
reference .pth/.pt/.ckpt loads with load_state_dict once the Lightning
'model.' prefix and the keys that carry no information are dropped.
state_dict_from_jax_params is the port's own copy of the JAX package's
export_to_torch_state_dict (mr_mt3_tpu/utils/checkpoint_import.py:138): it
turns a JAX parameter tree, given as numpy arrays, into the port's
state_dict, transposing Dense kernels (flax (in, out) -> torch (out, in));
state_dict_shard_from_jax_params cuts it into one rank's shard of a model
axis.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

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
    # vestigial in the reference (built, then bypassed through
    # inputs_embeds: reference models/t5_segmem.py:57,134-135)
    re.compile(r'^segmem_proj\.weight$'),
)


def jax_param_map(params: Mapping[str, Any], cfg: MT3Config
                  ) -> List[Tuple[str, Tuple[str, ...], bool]]:
    """(state_dict key, JAX tree path, transpose) of every parameter `cfg`
    has; the memory encoder's only where the tree holds one."""
    out = [('proj.weight', ('proj', 'kernel'), True),
           ('decoder_embed_tokens.weight', ('token_embed', 'embedding'),
            False),
           ('lm_head.weight', ('lm_head', 'kernel'), True)]
    stacks = [('encoder', cfg.num_encoder_layers, False),
              ('decoder', cfg.num_decoder_layers, True)]
    if cfg.has_segmem and 'segmem_encoder' in params:
        stacks.append(('segmem_encoder', cfg.segmem_num_layers, False))
    for stack, n_layers, is_decoder in stacks:
        for i in range(n_layers):
            block = f'block_{i}'
            prefix = f'{stack}.block.{i}.layer'
            for name in _ATTN:
                out.append((f'{prefix}.0.SelfAttention.{name}.weight',
                            (stack, block, 'self_attn', name, 'kernel'),
                            True))
            out.append((f'{prefix}.0.layer_norm.weight',
                        (stack, block, 'self_norm', 'weight'), False))
            ff_layer = 1
            if is_decoder:
                for name in _ATTN:
                    out.append((f'{prefix}.1.EncDecAttention.{name}.weight',
                                (stack, block, 'cross_attn', name, 'kernel'),
                                True))
                out.append((f'{prefix}.1.layer_norm.weight',
                            (stack, block, 'cross_norm', 'weight'), False))
                ff_layer = 2
            for name in _FF:
                out.append(
                    (f'{prefix}.{ff_layer}.DenseReluDense.{name}.weight',
                     (stack, block, 'ff', name, 'kernel'), True))
            out.append((f'{prefix}.{ff_layer}.layer_norm.weight',
                        (stack, block, 'ff_norm', 'weight'), False))
        out.append((f'{stack}.final_layer_norm.weight',
                    (stack, 'final_norm', 'weight'), False))
    return out


def state_dict_from_jax_params(params: Mapping[str, Any], cfg: MT3Config,
                               partial: bool = False
                               ) -> Dict[str, torch.Tensor]:
    """JAX (flax) parameter tree of numpy arrays -> the port's state_dict.

    A leaf the tree lacks raises KeyError; with partial=True its parameter
    is left out (it then shows as a missing key of load_state_dict)."""
    out: Dict[str, torch.Tensor] = {}
    for key, path, transpose in jax_param_map(params, cfg):
        node = params
        try:
            for k in path:
                node = node[k]
        except KeyError:
            if not partial:
                raise
            continue
        value = np.asarray(node, np.float32)
        out[key] = torch.tensor(value.T if transpose else value)
    return out


def state_dict_shard_from_jax_params(params: Mapping[str, Any],
                                     cfg: MT3Config, model: int, index: int,
                                     partial: bool = False
                                     ) -> Dict[str, torch.Tensor]:
    """Rank `index`'s shard, on a model axis of `model` ranks, of the
    state_dict state_dict_from_jax_params gives: each parameter that
    parallel.param_shardings shards cut into `model` equal parts on its
    dimension, the others whole (what a model sharded by
    parallel/tensor.py::shard_model holds)."""
    from mr_mt3_tpu_torch.parallel.mesh import param_shardings
    plan = param_shardings(cfg, model)
    out = {}
    for key, value in state_dict_from_jax_params(params, cfg,
                                                 partial).items():
        dim = plan.get(key)
        out[key] = (value if dim is None
                    else value.chunk(model, dim=dim)[index].clone())
    return out


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
