"""Convert the official MT3 T5X checkpoint to the port's weights file.

Port of tools/convert_weight.py. The T5X tree maps onto the JAX model's
parameter layout untransposed (T5X kernels are (in, out), like Flax);
that tree then goes through utils/checkpoint_import.py::
state_dict_from_jax_params into the reference HF-T5 key layout the port's
model uses natively, and is written with torch.save. Where the JAX
converter writes an Orbax directory, this one writes a .pth file, which
utils/builders.py::load_weights and InferenceHandler(weight_path=...)
load with no missing and no unexpected key.

Usage:
  python -m mr_mt3_tpu_torch.scripts.convert_weight <t5x_state_dict.pk> \\
      <out.pth>

The input is the pickled T5X state dict captured the way the reference
documents (reference: tools/convert_weight.py:110-125). Unpickling runs
code the file names: convert only a file of a source you trust.
"""

from __future__ import annotations

import pickle
import re
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

from mr_mt3_tpu_torch.models import MT3Config
from mr_mt3_tpu_torch.utils.checkpoint_import import (
    state_dict_from_jax_params,
)


def flatten_state_dict(tree: Dict[str, Any], prefix: str = ''
                       ) -> Dict[str, Any]:
    """Nested dict -> {'a/b/c': leaf}."""
    out = {}
    for key, value in tree.items():
        path = f'{prefix}/{key}' if prefix else key
        if isinstance(value, dict):
            out.update(flatten_state_dict(value, path))
        else:
            out[path] = value
    return out


def _count_layers(flat: Dict[str, np.ndarray], stack: str) -> int:
    pat = re.compile(rf'^target/{stack}/layers_(\d+)/')
    found = {int(m.group(1)) for k in flat for m in [pat.match(k)] if m}
    return max(found) + 1 if found else 0


def t5x_to_flax_params(flat: Dict[str, np.ndarray],
                       num_layers: Optional[int] = None) -> Dict[str, Any]:
    """Map target/* T5X keys onto the JAX MT3 parameter tree (numpy).

    num_layers (a symmetric shorthand: the same count for both stacks)
    defaults to the per-stack counts present in the checkpoint (8+8 for the
    official MT3 checkpoint); asymmetric checkpoints convert from their
    counted depths without it."""
    num_encoder_layers = (num_layers if num_layers is not None
                          else _count_layers(flat, 'encoder'))
    num_decoder_layers = (num_layers if num_layers is not None
                          else _count_layers(flat, 'decoder'))
    params: Dict[str, Any] = {}

    def put(path, value):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.asarray(value, dtype=np.float32)

    def attn(stack, block, mine, theirs):
        for sub_m, sub_t in (('q', 'query'), ('k', 'key'), ('v', 'value'),
                             ('o', 'out')):
            put((stack, block, mine, sub_m, 'kernel'),
                flat[f'target/{theirs}/{sub_t}/kernel'])

    for i in range(num_encoder_layers):
        blk, lyr = f'block_{i}', f'layers_{i}'
        attn('encoder', blk, 'self_attn', f'encoder/{lyr}/attention')
        put(('encoder', blk, 'self_norm', 'weight'),
            flat[f'target/encoder/{lyr}/pre_attention_layer_norm/scale'])
        for w in ('wi_0', 'wi_1', 'wo'):
            put(('encoder', blk, 'ff', w, 'kernel'),
                flat[f'target/encoder/{lyr}/mlp/{w}/kernel'])
        put(('encoder', blk, 'ff_norm', 'weight'),
            flat[f'target/encoder/{lyr}/pre_mlp_layer_norm/scale'])

    for i in range(num_decoder_layers):
        blk, lyr = f'block_{i}', f'layers_{i}'
        attn('decoder', blk, 'self_attn', f'decoder/{lyr}/self_attention')
        put(('decoder', blk, 'self_norm', 'weight'),
            flat[f'target/decoder/{lyr}/pre_self_attention_layer_norm/scale'])
        attn('decoder', blk, 'cross_attn',
             f'decoder/{lyr}/encoder_decoder_attention')
        put(('decoder', blk, 'cross_norm', 'weight'),
            flat[f'target/decoder/{lyr}/pre_cross_attention_layer_norm/scale'])
        for w in ('wi_0', 'wi_1', 'wo'):
            put(('decoder', blk, 'ff', w, 'kernel'),
                flat[f'target/decoder/{lyr}/mlp/{w}/kernel'])
        put(('decoder', blk, 'ff_norm', 'weight'),
            flat[f'target/decoder/{lyr}/pre_mlp_layer_norm/scale'])

    put(('encoder', 'final_norm', 'weight'),
        flat['target/encoder/encoder_norm/scale'])
    put(('decoder', 'final_norm', 'weight'),
        flat['target/decoder/decoder_norm/scale'])
    put(('proj', 'kernel'),
        flat['target/encoder/continuous_inputs_projection/kernel'])
    put(('token_embed', 'embedding'),
        flat['target/decoder/token_embedder/embedding'])
    put(('lm_head', 'kernel'), flat['target/decoder/logits_dense/kernel'])
    return params


def state_dict_from_t5x(flat: Dict[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """Flat target/* T5X dict -> the port's state_dict, at the depths the
    checkpoint holds."""
    cfg = MT3Config(num_encoder_layers=_count_layers(flat, 'encoder'),
                    num_decoder_layers=_count_layers(flat, 'decoder'))
    return state_dict_from_jax_params(t5x_to_flax_params(flat), cfg)


def main(in_path: str, out_path: str) -> None:
    with open(in_path, 'rb') as f:
        state = pickle.load(f)
    flat = {k: v for k, v in flatten_state_dict(state).items()
            if not k.startswith('state')}
    torch.save(state_dict_from_t5x(flat), out_path)
    print(f'wrote {out_path}')


if __name__ == '__main__':
    main(sys.argv[1], sys.argv[2])
