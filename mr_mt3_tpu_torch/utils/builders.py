"""Builders wiring configs to the port's model, weights, optimizer and
datasets (port of mr_mt3_tpu/utils/builders.py:21-93, 143-175)."""

from __future__ import annotations

import math
import os

import torch

from mr_mt3_tpu_torch.models import MT3
from mr_mt3_tpu_torch.models.config import config_from_dict
from mr_mt3_tpu_torch.utils.config import ConfigNode, instantiate


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


def build_optimizer(cfg: ConfigNode):
    """cfg.model.task + cfg.optim (+ cfg.grad_accum) -> (optimizer,
    schedule or None): AdamW with the cosine-warmup schedule (or a constant
    LR), the optional optim.clip_norm, and MultiSteps for grad_accum > 1
    (reference: accumulate_grad_batches, config/config.yaml:20,42)."""
    from mr_mt3_tpu_torch.train.optim import (
        MultiSteps,
        cosine_schedule_with_warmup,
        make_optimizer,
    )
    task = cfg.model.task
    optim = cfg.optim
    use_schedule = bool(task.get('use_scheduler', True))
    total_steps = int(optim.num_steps_per_epoch) * int(optim.num_epochs)
    clip_norm = optim.get('clip_norm')
    clip_norm = None if clip_norm is None else float(clip_norm)
    schedule = None
    if use_schedule:
        # built once and passed into the optimizer: the same callable is
        # what the trainer logs (warmup_steps: null means 0, like min_lr)
        schedule = cosine_schedule_with_warmup(
            float(optim.lr), int(optim.warmup_steps or 0), total_steps,
            min_lr_multiplier=float(optim.min_lr or 0.0))
        optimizer = make_optimizer(lr=float(optim.lr), schedule=schedule,
                                   clip_norm=clip_norm)
    else:
        optimizer = make_optimizer(lr=float(optim.lr), use_schedule=False,
                                   clip_norm=clip_norm)
    grad_accum = int(cfg.get('grad_accum') or 1)
    if grad_accum > 1:
        optimizer = MultiSteps(optimizer, grad_accum)
    return optimizer, schedule


def build_datasets(cfg: ConfigNode):
    """cfg.dataset.train / .val -> the port's datasets (their _target_s,
    which name mr_mt3_tpu.data classes, mapped onto mr_mt3_tpu_torch.data
    by utils/config.py::instantiate)."""
    train_ds = instantiate(cfg.dataset.train, seed=int(cfg.seed))
    val_ds = instantiate(cfg.dataset.val, seed=int(cfg.seed) + 1,
                         shuffle=False)
    return train_ds, val_ds


def _load_state_dict(model: MT3, state_dict, strict: bool,
                     unexpected=()) -> None:
    """load_state_dict(strict=False), then torch strict-load semantics:
    with strict a missing parameter raises; keys the model does not have
    (`unexpected` adds the source's own) are reported."""
    missing, not_mapped = model.load_state_dict(state_dict, strict=False)
    not_mapped = list(not_mapped) + list(unexpected)
    if not_mapped:
        print(f'load_weights: {len(not_mapped)} checkpoint keys not '
              f'mapped (e.g. {not_mapped[:3]})')
    if strict and missing:
        raise ValueError('strict weight load failed\n  missing: '
                         + ', '.join(missing))


def load_weights_and_step(path: str, model: MT3, strict: bool = False):
    """Load weights into `model` and return (model, step): a checkpoint
    file of the port's trainer (its params and step;
    train/trainer.py::Trainer.save_checkpoint), a reference torch
    checkpoint (.pth/.pt/.ckpt, also the port's T5X converter's output;
    step 0), or an Orbax directory of the JAX trainer or converter (its
    params and step, read through tensorstore: utils/orbax_read.py; the
    optimizer state is ignored).

    strict=True raises when the checkpoint misses a parameter (torch
    strict-load semantics); keys the model does not have are reported."""
    if os.path.isfile(path) and not path.endswith(('.pth', '.pt', '.ckpt')):
        from mr_mt3_tpu_torch.train.trainer import load_checkpoint
        blob = load_checkpoint(path)
        model.load_state_dict(blob['params'], strict=True)
        return model, int(blob.get('step', 0))
    if path.endswith(('.pth', '.pt', '.ckpt')) and os.path.isfile(path):
        from mr_mt3_tpu_torch.utils.checkpoint_import import (
            load_torch_checkpoint)
        _load_state_dict(model, load_torch_checkpoint(path), strict)
        return model, 0
    if os.path.isdir(path):
        from mr_mt3_tpu_torch.utils.checkpoint_import import (
            jax_param_map, state_dict_from_jax_params)
        from mr_mt3_tpu_torch.utils.orbax_read import read_orbax
        params, step = read_orbax(path)
        state_dict = state_dict_from_jax_params(params, model.cfg,
                                                partial=True)
        mapped = {p for _, p, _ in jax_param_map(params, model.cfg)}
        unexpected = sorted('/'.join(p) for p in _tree_paths(params)
                            if p not in mapped)
        _load_state_dict(model, state_dict, strict, unexpected)
        return model, step
    raise FileNotFoundError(path)


def _tree_paths(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _tree_paths(value, prefix + (key,))
        else:
            yield prefix + (key,)


def load_weights(path: str, model: MT3, strict: bool = False) -> MT3:
    """load_weights_and_step without the step: returns `model`."""
    return load_weights_and_step(path, model, strict)[0]
