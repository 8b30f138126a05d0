"""Minimal Hydra-compatible config system (copy of
mr_mt3_tpu/utils/config.py; instantiate maps the dataset targets onto the
port).

The reference composes YAML via Hydra (reference: config/config.yaml:55-57,
train.py:21-23): a root config with a `defaults` list of config groups
(model/, dataset/), `${...}` interpolation, `${hydra:runtime.choices.X}`
for the selected group option, and `key=value` CLI overrides (including
group swaps like `model=MT3NetSegMemV2WithPrev`). This reimplements that
surface on plain PyYAML so the reference's config files and launch commands
port over nearly verbatim.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import yaml


class ConfigNode(dict):
    """Dict with attribute access, recursively."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    def __setattr__(self, key, value):
        self[key] = value

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return ConfigNode({k: ConfigNode.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigNode.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o
        return unwrap(self)


def _get_path(tree: dict, dotted: str):
    node = tree
    for part in dotted.split('.'):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(dotted)
        node = node[part]
    return node


def _set_path(tree: dict, dotted: str, value):
    parts = dotted.split('.')
    node = tree
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def _parse_value(text: str):
    if text in ('null', 'None', ''):
        return None
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        return text
    if isinstance(value, str):
        # YAML 1.1 misses floats like '1e-3' (no dot); recover them
        try:
            return int(value)
        except ValueError:
            pass
        try:
            return float(value)
        except ValueError:
            pass
    return value


_INTERP_RE = re.compile(r'^\$\{([^}]+)\}$')
_INTERP_INNER_RE = re.compile(r'\$\{([^}]+)\}')


def _resolve_ref(ref: str, root: dict, choices: Dict[str, str]):
    ref = ref.strip()
    if ref.startswith('hydra:runtime.choices.'):
        return choices.get(ref.rsplit('.', 1)[-1])
    if ref.startswith('choices:'):
        return choices.get(ref.split(':', 1)[1])
    return _get_path(root, ref)


def _resolve_interpolations(node, root: dict, choices: Dict[str, str],
                            depth: int = 0):
    if depth > 10:
        raise ValueError('interpolation recursion too deep')
    if isinstance(node, dict):
        return {k: _resolve_interpolations(v, root, choices, depth)
                for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_interpolations(v, root, choices, depth)
                for v in node]
    if isinstance(node, str):
        full = _INTERP_RE.match(node)
        if full:
            value = _resolve_ref(full.group(1), root, choices)
            return _resolve_interpolations(value, root, choices, depth + 1)
        def sub(m):
            value = _resolve_ref(m.group(1), root, choices)
            value = _resolve_interpolations(value, root, choices, depth + 1)
            return str(value)
        if _INTERP_INNER_RE.search(node):
            return _INTERP_INNER_RE.sub(sub, node)
    return node


def _deep_update(base: dict, extra: dict):
    for key, value in extra.items():
        if (key in base and isinstance(base[key], dict)
                and isinstance(value, dict)):
            _deep_update(base[key], value)
        else:
            base[key] = value


def load_config(config_dir: str,
                config_name: str = 'config',
                overrides: Optional[List[str]] = None) -> ConfigNode:
    """Compose a config like Hydra would.

    overrides: list of 'a.b=value' strings; bare group names ('model=X')
    swap the group option before composition.
    """
    overrides = list(overrides or [])

    with open(os.path.join(config_dir, config_name + '.yaml')) as f:
        root = yaml.safe_load(f) or {}

    defaults = root.pop('defaults', [])
    choices: Dict[str, str] = {}
    for entry in defaults:
        if isinstance(entry, dict):
            (group, option), = entry.items()
            choices[group] = option

    # group swaps from overrides
    remaining = []
    deletions = []
    for ov in overrides:
        # hydra '~key' (and the '~key=value' delete-with-value form)
        # deletes a config entry; check before the '=' split so the
        # valued form does not create a literal '~key' entry
        if ov.startswith('~'):
            deletions.append(ov[1:].split('=', 1)[0])
            continue
        if '=' not in ov:
            raise ValueError(f'override must be key=value: {ov}')
        key, value = ov.split('=', 1)
        # hydra prefixes: '+key' adds a new entry, '++key' force-adds;
        # composition here treats all three identically
        key = key.lstrip('+')
        if key in choices and '.' not in key:
            choices[key] = _parse_value(value)
        else:
            remaining.append((key, value))

    for group, option in choices.items():
        path = os.path.join(config_dir, group, f'{option}.yaml')
        with open(path) as f:
            group_cfg = yaml.safe_load(f) or {}
        _deep_update(root.setdefault(group, {}), group_cfg)

    for key, value in remaining:
        _set_path(root, key, _parse_value(value))

    for dotted in deletions:
        parts = dotted.split('.')
        try:
            node = _get_path(root, '.'.join(parts[:-1])) if parts[:-1] \
                else root
            node.pop(parts[-1], None)
        except KeyError:
            pass

    resolved = _resolve_interpolations(root, root, choices)
    # late overrides that referenced interpolated values resolve against the
    # resolved tree as well
    resolved = _resolve_interpolations(resolved, resolved, choices)
    cfg = ConfigNode.wrap(resolved)
    cfg['_choices_'] = ConfigNode.wrap(choices)
    return cfg


def parse_cli(argv: List[str]):
    """Split argv into (config_name, config_dir, overrides) hydra-style."""
    config_name = 'config'
    config_dir = None
    overrides = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith('--config-name'):
            if '=' in arg:
                config_name = arg.split('=', 1)[1]
            else:
                i += 1
                config_name = argv[i]
        elif arg.startswith('--config-path') or arg.startswith('--config-dir'):
            if '=' in arg:
                config_dir = arg.split('=', 1)[1]
            else:
                i += 1
                config_dir = argv[i]
        elif '=' in arg or arg.startswith('~'):
            overrides.append(arg)
        else:
            raise ValueError(f'unrecognized argument: {arg}')
        i += 1
    return config_name, config_dir, overrides


# configs/dataset/*.yaml name the JAX package's dataset classes
# (mr_mt3_tpu.data.*); the port builds its own copies of them and nothing
# else, so that a config never imports the JAX package
_TARGET_PACKAGES = {'mr_mt3_tpu.data.': 'mr_mt3_tpu_torch.data.',
                    'mr_mt3_tpu_torch.data.': 'mr_mt3_tpu_torch.data.'}


def resolve_target(target: str) -> str:
    """mr_mt3_tpu.data.X -> mr_mt3_tpu_torch.data.X (and the port's own
    names as they are); any other _target_ raises."""
    for prefix, port in _TARGET_PACKAGES.items():
        if target.startswith(prefix):
            return port + target[len(prefix):]
    raise ValueError(f'_target_ {target!r}: the port builds only the '
                     f'datasets of mr_mt3_tpu.data (mapped onto '
                     f'mr_mt3_tpu_torch.data)')


def instantiate(node: ConfigNode, **extra):
    """Build the object named by node['_target_'] (mapped by
    resolve_target) with the node's fields (hydra.utils.instantiate
    equivalent for plain classes)."""
    import importlib
    node = dict(node)
    target = resolve_target(node.pop('_target_'))
    module_name, cls_name = target.rsplit('.', 1)
    cls = getattr(importlib.import_module(module_name), cls_name)
    node.update(extra)
    return cls(**node)
