"""Read the JAX trainer's Orbax checkpoints without JAX or Orbax.

The JAX package saves `{'params': ..., 'step': ..., 'opt_state': ...}`
through Orbax (mr_mt3_tpu/train/trainer.py:319); tools/convert_weight.py
writes `{'params': ..., 'step': 0}` the same way. Orbax 0.11 lays such a
directory out as OCDBT: `_METADATA` (JSON) names every leaf by its tree
path and says `use_ocdbt` / `use_zarr3`; each array is a zarr array inside
the OCDBT key-value store at the directory, under the key
`<path joined by '.'>/`. tensorstore reads them directly:

    {'driver': 'zarr', 'kvstore': {'driver': 'ocdbt',
     'base': 'file://<dir>', 'path': 'params.encoder.block_0.ff.wo.kernel/'}}

Only `params` and `step` are read. The optimizer state written beside
them is ignored, as the JAX package's load_weights ignores it
(mr_mt3_tpu/utils/builders.py:143-174): a port run resumes its optimizer
only from its own checkpoints (train/trainer.py).

tensorstore is imported here, inside read_orbax, and nowhere else in the
port: without it an Orbax directory cannot be read, and read_orbax raises
RuntimeError rather than fall back.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

METADATA = '_METADATA'


def _leaf_paths(meta: Dict[str, Any]):
    """_METADATA's tree_metadata -> the tuple path of every leaf."""
    for entry in meta['tree_metadata'].values():
        yield tuple(str(k['key']) for k in entry['key_metadata'])


def read_orbax(path: str) -> Tuple[Dict[str, Any], int]:
    """An Orbax checkpoint directory -> (params, step): params the nested
    dict of float32 numpy arrays the JAX model's tree has, step its
    integer (0 where the checkpoint holds none)."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise RuntimeError(
            'reading an Orbax checkpoint needs the tensorstore package, '
            'which is not installed') from e
    directory = os.path.abspath(path)
    meta_path = os.path.join(directory, METADATA)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f'{path} is not an Orbax checkpoint: no '
                                f'{METADATA}')
    with open(meta_path) as f:
        meta = json.load(f)
    if not meta.get('use_ocdbt') or meta.get('use_zarr3'):
        raise ValueError(
            f'{path}: use_ocdbt {meta.get("use_ocdbt")}, use_zarr3 '
            f'{meta.get("use_zarr3")}; only the OCDBT layout with zarr v2 '
            f'arrays (Orbax 0.11\'s default) is read')
    base = f'file://{directory}'
    params: Dict[str, Any] = {}
    step = 0
    for leaf in _leaf_paths(meta):
        if leaf[0] not in ('params', 'step'):
            continue
        name = '.'.join(leaf)
        spec = {'driver': 'zarr', 'kvstore': {'driver': 'ocdbt',
                                              'base': base,
                                              'path': f'{name}/'}}
        value = ts.open(spec).result().read().result()
        if leaf == ('step',):
            step = int(np.asarray(value))
            continue
        node = params
        for key in leaf[1:-1]:
            node = node.setdefault(key, {})
        node[leaf[-1]] = np.asarray(value, np.float32)
    if not params:
        raise ValueError(f'{path}: the checkpoint holds no params')
    return params, step
