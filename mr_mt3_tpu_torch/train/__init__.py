"""Training (port of mr_mt3_tpu/train and of the repo's train.py):
losses, optimizer and schedules, train step and loop, and the CLI.

    python -m mr_mt3_tpu_torch.train --config-name=config_slakh_segmem \\
        model=MT3NetSegMemV2WithPrev dataset=SlakhPrev \\
        model_segmem_length=64 trainer.precision=bf16 eval.audio_dir=null \\
        dataset.train.root_dir=... dataset.val.root_dir=... [device=cpu]

It trains on the card unless device=cpu is given (and raises without a
card). Checkpoints go to <out_dir>/checkpoints ('last', the top-k
'epoch={e}-val_loss={v}', 'final'); path=<checkpoint> resumes one with its
optimizer state and step, and path=<reference .pth/.pt/.ckpt> warm-starts
from its weights. Not ported, and raising rather than skipped:
the eval hook (eval.audio_dir, ROADMAP A7), multihost and more than one
device (A9). trainer.fast_rng, the JAX package's TPU hardware-RNG switch,
is accepted and has no effect.
"""

from __future__ import annotations

import os
import sys

from mr_mt3_tpu_torch.train.losses import (
    cross_entropy_loss,
    weighted_instrument_loss,
)
from mr_mt3_tpu_torch.train.optim import (
    AdamW,
    MultiSteps,
    cosine_schedule_with_warmup,
    make_optimizer,
)
from mr_mt3_tpu_torch.train.trainer import (
    CheckpointPolicy,
    Trainer,
    TrainState,
    create_train_state,
    make_train_step,
)

REPO_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), 'configs')


def _device_count(devices) -> int:
    """How many devices `devices=` asks for: null -> 1 (the port's one
    card), an int, or a list of ids."""
    if devices is None:
        return 1
    if isinstance(devices, (list, tuple)):
        return len(devices)
    return int(devices)


def main(argv=None) -> TrainState:
    """Run the CLI on `argv` (default sys.argv[1:]); returns the final
    state."""
    import numpy as np
    import torch

    from mr_mt3_tpu_torch.data import DataLoader
    from mr_mt3_tpu_torch.utils import builders
    from mr_mt3_tpu_torch.utils.config import load_config, parse_cli
    from mr_mt3_tpu_torch.utils.device import resolve_device

    config_name, config_dir, overrides = parse_cli(
        sys.argv[1:] if argv is None else argv)
    default_dir = os.environ.get('MR_MT3_CONFIGS') or REPO_CONFIGS
    cfg = load_config(config_dir or default_dir, config_name, overrides)
    if bool(cfg.get('multihost')):
        raise NotImplementedError('multihost training is not yet ported '
                                  '(ROADMAP A9): the port trains on one '
                                  'card')
    if _device_count(cfg.get('devices')) > 1 or \
            int(cfg.get('model_devices') or 1) > 1:
        raise NotImplementedError(
            f'devices={cfg.get("devices")} model_devices='
            f'{cfg.get("model_devices")}: training on more than one device '
            f'is not yet ported (ROADMAP A9)')
    if cfg.eval.get('audio_dir'):
        raise NotImplementedError(
            'the training eval hook (get_scores over eval.audio_dir) is not '
            'yet ported (ROADMAP A7); pass eval.audio_dir=null')
    device = resolve_device(cfg.get('device'))
    if 'fast_rng' in (cfg.get('trainer') or {}):
        print('note: trainer.fast_rng (the TPU hardware RNG) has no effect '
              'in the port')

    seed = int(cfg.seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    model = builders.build_model(cfg)
    builders.init_params(model, seed)
    optimizer, schedule = builders.build_optimizer(cfg)
    train_ds, val_ds = builders.build_datasets(cfg)
    train_loader = DataLoader(
        train_ds, batch_size=int(cfg.dataloader.train.batch_size),
        num_workers=int(cfg.dataloader.train.num_workers) or 1,
        shuffle=True, seed=seed)
    val_loader = DataLoader(
        val_ds, batch_size=int(cfg.dataloader.val.batch_size),
        num_workers=max(1, int(cfg.dataloader.val.num_workers)),
        shuffle=False, seed=seed)
    out_dir = cfg.get('out_dir') or 'runs/default'
    print(f'train: {type(train_ds).__name__}, {len(train_ds)} songs, '
          f'{len(train_loader)} batches an epoch; device {device}; '
          f'dtype {model.cfg.dtype}; out_dir {out_dir}')

    mc = cfg.get('modelcheckpoint') or {}
    trainer = Trainer(
        model, optimizer,
        loss_type=cfg.model.task.loss,
        out_dir=out_dir,
        checkpoint_policy=CheckpointPolicy(
            monitor=mc.get('monitor', 'val_loss'),
            mode=mc.get('mode', 'min'),
            save_last=bool(mc.get('save_last', True)),
            save_top_k=int(mc.get('save_top_k', 5)),
            every_n_epochs=int(mc.get('every_n_epochs', 1) or 1)),
        log_every_n_steps=int(cfg.trainer.get('log_every_n_steps', 100)),
        check_val_every_n_epoch=int(
            cfg.trainer.get('check_val_every_n_epoch', 1) or 1),
        lr_schedule=schedule,
        seed=seed,
        bucket_targets=bool(cfg.trainer.get('bucket_targets', True)),
        # the in-step mel must use the dataset's filterbank choice
        spectrogram_config=getattr(train_ds, 'spectrogram_config', None))

    model.to(device)
    state = create_train_state(model, optimizer)
    start_epoch = 0
    path = cfg.get('path')
    if path:
        path = str(path)
        if os.path.isfile(path) and not path.endswith(
                ('.pth', '.pt', '.ckpt')):
            # a port checkpoint: full resume of params, optimizer state and
            # step (reference .ckpt semantics: train.py:62-76)
            state = trainer.restore_state(os.path.abspath(path), state)
            start_epoch = state.step // max(1, len(train_loader))
            print(f'resumed full state from {path} (step {state.step}, '
                  f'epoch {start_epoch})')
        else:
            # warm start from a reference file's weights (.pth/.pt/.ckpt)
            builders.load_weights(path, model)
            print(f'loaded weights from {path}')

    num_epochs = int(cfg.trainer.max_epochs)
    state = trainer.fit(state, train_loader, val_loader,
                        num_epochs=num_epochs, start_epoch=start_epoch)
    trainer.save_checkpoint(state, 'final')
    print(f'saved final checkpoint under {trainer._ckpt_dir}/final')
    return state
