"""Training (port of mr_mt3_tpu/train and of the repo's train.py):
losses, optimizer and schedules, train step and loop, and the CLI.

    python -m mr_mt3_tpu_torch.train --config-name=config_slakh_segmem \\
        model=MT3NetSegMemV2WithPrev dataset=SlakhPrev \\
        model_segmem_length=64 trainer.precision=bf16 \\
        dataset.train.root_dir=... dataset.val.root_dir=... \\
        [eval.audio_dir='.../*/mix_16k.wav' eval.midi_dir=...] [device=cpu]

It trains on the card unless device=cpu is given (and raises without a
card). Checkpoints go to <out_dir>/checkpoints ('last', the top-k
'epoch={e}-val_loss={v}', 'final'); path=<checkpoint> resumes one with its
optimizer state and step, and path=<reference .pth/.pt/.ckpt> warm-starts
from its weights. With eval.audio_dir set, the eval hook transcribes and
scores that set (infer/scores.py::get_scores, exact decode) after
validation from epoch eval.eval_after_num_epoch on, every
eval.eval_per_epoch epochs, and logs val_f1_flat, val_f1_midi_class and
val_f1_full, which modelcheckpoint.monitor may rank by.
trainer.fast_rng, the JAX package's TPU hardware-RNG switch,
is accepted and has no effect.

More than one card (train.py spans its chips with a data-axis mesh; the
reference trains under Lightning DDP): `devices` (null: every visible
card; an int or a list of ids: how many) starts one rank a card on this
node (torch.multiprocessing, a file store for the rendezvous), each
training on its slice of every loader batch under DistributedDataParallel,
so dataloader.train.batch_size stays one node's global batch, as in the
JAX trainer; the ranks' final state is in the checkpoints, and main then
returns None. Under a launcher (`torchrun --nproc_per_node=G -m
mr_mt3_tpu_torch.train ...`, its environment's WORLD_SIZE and RANK) the
process joins its group; multihost=true asks for one (several nodes:
`torchrun --nnodes=N`), and the loader then strides its batches by node
(shard_rank = node rank, shard_count = nodes). Rank 0 alone logs and
writes. device=cpu trains the ranks on the CPU over gloo.

model_devices=<m> (train.py's tensor-parallel axis) makes the ranks a grid
of data x m (parallel.Mesh): data is the `devices` count, or the visible
cards divided by m (JAX's make_mesh rules and errors; one on the CPU), and
each row of m ranks holds the shards of one model (parallel/tensor.py),
the rows splitting the batch as the data axis does. The mesh is printed
as train.py prints it (`train mesh: {'data': d, 'model': m}`). The eval
hook decodes with the full weights gathered on every rank.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

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


def main(argv=None) -> TrainState:
    """Run the CLI on `argv` (default sys.argv[1:]); returns the final
    state (None where it started ranks of its own)."""
    import numpy as np
    import torch

    from mr_mt3_tpu_torch import parallel
    from mr_mt3_tpu_torch.data import DataLoader
    from mr_mt3_tpu_torch.parallel import tensor as tp_ops
    from mr_mt3_tpu_torch.utils import builders
    from mr_mt3_tpu_torch.utils.config import load_config, parse_cli
    from mr_mt3_tpu_torch.utils.device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    config_name, config_dir, overrides = parse_cli(argv)
    default_dir = os.environ.get('MR_MT3_CONFIGS') or REPO_CONFIGS
    cfg = load_config(config_dir or default_dir, config_name, overrides)
    model_axis = int(cfg.get('model_devices') or 1)
    device = resolve_device(cfg.get('device'))
    if not torch.distributed.is_initialized():
        if bool(cfg.get('multihost')) or 'WORLD_SIZE' in os.environ:
            parallel.init_multihost(backend=parallel.backend_for(device))
        else:
            data = parallel.grid_data(cfg.get('devices'), model_axis, device)
            if data * model_axis > 1:
                return _spawn(argv, data * model_axis, device)
    mesh = None
    if torch.distributed.is_initialized():
        device = parallel.rank_device(device.type)
        if model_axis > 1:
            mesh = parallel.Mesh(parallel.rank_devices(device.type),
                                 model=model_axis)
    lead = parallel.rank() == 0
    if lead:
        print('train mesh: ' + str(mesh.shape if mesh is not None else
                                   {'data': parallel.world(),
                                    'model': model_axis}))
    if 'fast_rng' in (cfg.get('trainer') or {}) and lead:
        print('note: trainer.fast_rng (the TPU hardware RNG) has no effect '
              'in the port')

    seed = int(cfg.seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    model = builders.build_model(cfg)
    builders.init_params(model, seed)
    optimizer, schedule = builders.build_optimizer(cfg)
    train_ds, val_ds = builders.build_datasets(cfg)
    # each node loads a disjoint stride of the (identically shuffled)
    # batch list, the DDP-equivalent per-node sampler; the node's ranks
    # split each batch's rows (Trainer)
    shard = dict(shard_rank=parallel.node_rank(),
                 shard_count=parallel.node_count())
    train_loader = DataLoader(
        train_ds, batch_size=int(cfg.dataloader.train.batch_size),
        num_workers=int(cfg.dataloader.train.num_workers) or 1,
        shuffle=True, seed=seed, **shard)
    val_loader = DataLoader(
        val_ds, batch_size=int(cfg.dataloader.val.batch_size),
        num_workers=max(1, int(cfg.dataloader.val.num_workers)),
        shuffle=False, seed=seed, **shard)
    out_dir = cfg.get('out_dir') or 'runs/default'
    if lead:
        print(f'train: {type(train_ds).__name__}, {len(train_ds)} songs, '
              f'{len(train_loader)} batches an epoch; device {device}; '
              f'ranks {parallel.world()}; dtype {model.cfg.dtype}; '
              f'out_dir {out_dir}')

    eval_hook = None
    if cfg.eval.get('audio_dir'):
        import glob as globlib

        from mr_mt3_tpu_torch.infer.scores import get_scores

        def eval_hook(model, epoch):
            # a sharded model's full weights, on every rank
            model = tp_ops.unsharded_copy(model)
            files = sorted(globlib.glob(cfg.eval.audio_dir))
            if cfg.eval.eval_dataset == 'NSynth':
                # same filter the eval CLI applies (no vocals/mallets in
                # the training vocab) so train-time and test-time F1 score
                # the identical file set
                files = [f for f in files
                         if 'vocal' not in f and 'mallet' not in f]
            if cfg.eval.get('eval_first_n_examples'):
                files = files[:int(cfg.eval.eval_first_n_examples)]
            scores = get_scores(
                model=model,
                eval_audio_dir=files,
                eval_dataset=cfg.eval.eval_dataset,
                exp_tag_name=os.path.join(out_dir, cfg.eval.exp_tag_name),
                ground_truth_midi_dir=cfg.eval.midi_dir,
                contiguous_inference=bool(
                    cfg.eval.get('contiguous_inference')),
                use_tf_spectral_ops=bool(
                    cfg.eval.get('use_tf_spectral_ops')),
                batch_size=int(cfg.eval.get('batch_size') or 8),
                max_length=int(cfg.eval.get('max_length') or 1024),
                verbose=False, device=device)
            return {
                'f1_flat': scores.get('Onset F1', 0.0),
                'f1_midi_class': scores.get(
                    'Onset + program F1 (midi_class)', 0.0),
                'f1_full': scores.get('Onset + program F1 (full)', 0.0),
            }

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
        eval_hook=eval_hook,
        eval_after_num_epoch=int(cfg.eval.get('eval_after_num_epoch') or 0),
        eval_per_epoch=int(cfg.eval.get('eval_per_epoch') or 1),
        lr_schedule=schedule,
        seed=seed,
        bucket_targets=bool(cfg.trainer.get('bucket_targets', True)),
        # the in-step mel must use the dataset's filterbank choice
        spectrogram_config=getattr(train_ds, 'spectrogram_config', None))

    start_epoch = 0
    path = str(cfg.get('path') or '')
    # a port checkpoint: full resume of params, optimizer state and step
    # (reference .ckpt semantics: train.py:62-76); anything else warm-starts
    # from its weights only (.pth/.pt/.ckpt, or an Orbax directory's
    # params), loaded whole before the model is sharded
    resume = bool(path) and os.path.isfile(path) and not path.endswith(
        ('.pth', '.pt', '.ckpt'))
    if path and not resume:
        builders.load_weights(path, model)
        if lead:
            print(f'loaded weights from {path}')
    if mesh is not None:
        tp_ops.shard_model(model, mesh)
    model.to(device)
    state = create_train_state(model, optimizer)
    if resume:
        state = trainer.restore_state(os.path.abspath(path), state)
        start_epoch = state.step // max(1, len(train_loader))
        if lead:
            print(f'resumed full state from {path} (step {state.step}, '
                  f'epoch {start_epoch})')

    num_epochs = int(cfg.trainer.max_epochs)
    state = trainer.fit(state, train_loader, val_loader,
                        num_epochs=num_epochs, start_epoch=start_epoch)
    trainer.save_checkpoint(state, 'final')
    if lead:
        print(f'saved final checkpoint under {trainer._ckpt_dir}/final')
    return state


def _spawn(argv, ranks: int, device) -> None:
    """Train on `ranks` ranks of this node, one process each (the card
    LOCAL_RANK, or the CPU), meeting through a file store in a temporary
    directory; a rank's failure ends the others and raises here."""
    import torch
    import torch.multiprocessing as mp
    if device.type == 'cuda' and ranks > torch.cuda.device_count():
        raise ValueError(f'devices={ranks} exceeds the '
                         f'{torch.cuda.device_count()} visible cards')
    from mr_mt3_tpu_torch.parallel import backend_for
    store = tempfile.mkdtemp(prefix='mr_mt3_train_ranks_')
    try:
        mp.start_processes(_rank_main, nprocs=ranks, start_method='spawn',
                           args=(argv, ranks, f'file://{store}/store',
                                 backend_for(device)))
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _rank_main(index: int, argv, ranks: int, init_method: str,
               backend: str) -> None:
    """One spawned rank: the launcher's environment, the group, main()."""
    from mr_mt3_tpu_torch import parallel
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index),
                      WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks))
    parallel.init_multihost(backend=backend, init_method=init_method)
    try:
        main(argv)
    finally:
        parallel.shutdown()
