"""Train state, train/eval steps and the training loop (port of
mr_mt3_tpu/train/trainer.py).

Covers the reference's Lightning task + Trainer surface (reference:
tasks/mt3_net*.py, tasks/mt3_base.py, train.py): CE / weighted-CE losses,
AdamW + cosine-warmup stepped per optimizer step, val-loss monitoring with
top-k + last checkpointing, LR logging, warm start and resume.

On one card, as the JAX package runs on one TPU mesh:
  * the log-mel frontend runs on the device inside the train step (the
    batch carries raw audio segments + valid frame counts);
  * the state is the model (f32 parameters), the optimizer (f32 moments)
    and the step; a bf16 model computes its activations in bf16 (no
    autocast, no loss scaling: the JAX package's mixed precision);
  * each step's dropout masks come from a torch.Generator on the device
    seeded with (seed, step), as the JAX package folds the step into its
    key, so a resumed run draws the masks an uninterrupted one would (the
    two packages' streams differ, which has no parity bearing: the
    reference draws from torch's RNG);
  * checkpoints are torch.save files under the JAX names ('last',
    'epoch={e}-{monitor}={v:.4f}', 'final') holding params, optimizer state
    and step (the JAX package writes Orbax directories, which the port
    reads as weights only: utils/orbax_read.py);
  * metrics are JSONL (the JAX writer adds TensorBoard when TensorFlow is
    installed; the port does not use it).

On more than one card, where the JAX package runs one SPMD program over
its mesh, the port runs one process a card under a torch.distributed
process group (parallel.init_multihost) and wraps the model in
DistributedDataParallel:
  * every rank of a node reads the node's loader batch, buckets it, and
    takes its contiguous slice of the rows (parallel.shard_batch, padded
    as the JAX shard_batch pads);
  * the loss is the global batch's sum over its global count of real
    tokens, as in JAX's one program: the counts are all-reduced first,
    each rank's term is its local sum / the global count x world, and
    DDP's mean of the gradients is then the global loss's gradient;
    grad_norm is read from the reduced gradients; the logged loss and the
    validation sums are all-reduced;
  * each rank's dropout masks come from (seed, step, rank) (rank 0's are
    the single-process run's);
  * rank 0 writes the metrics and the checkpoints (a barrier after each
    write); every rank restores.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from mr_mt3_tpu_torch import parallel
from mr_mt3_tpu_torch.audio.frontend import (
    SpectrogramConfig,
    compute_logmel,
    normalize_logmel,
)
from mr_mt3_tpu_torch.models import MT3
from mr_mt3_tpu_torch.train.losses import (
    IGNORE_INDEX,
    INSTRUMENT_TOKEN_HI,
    INSTRUMENT_TOKEN_LO,
    cross_entropy_loss,
    loss_from_terms,
    loss_terms,
    weighted_instrument_loss,
)
from mr_mt3_tpu_torch.train.optim import global_norm


@dataclasses.dataclass
class TrainState:
    """The model (its f32 parameters), the optimizer bound to them, and the
    number of train steps taken (micro-steps under gradient
    accumulation, as the JAX state counts them). Under a process group,
    ddp is the model wrapped in DistributedDataParallel, which the train
    step's forward goes through."""
    model: MT3
    optimizer: Any
    step: int = 0
    ddp: Any = None


def create_train_state(model: MT3, optimizer) -> TrainState:
    """Bind `optimizer` to the model's parameters (on their device) with
    zeroed moments; under a process group wrap the model in
    DistributedDataParallel (rank 0's parameters broadcast to every rank).
    Every parameter of every model variant receives a gradient
    (tests/test_torch_ddp.py), so DDP looks for no unused ones."""
    ddp = None
    if torch.distributed.is_initialized():
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, find_unused_parameters=False, broadcast_buffers=False)
    optimizer.init(list(model.parameters()))
    return TrainState(model=model, optimizer=optimizer, step=0, ddp=ddp)


def bucket_targets(batch: Dict[str, Any], multiple: int = 128,
                   keys=('targets',)) -> Dict[str, Any]:
    """Trim all-padding target tails to the next multiple-of-`multiple`.

    The datasets pad every target row to event_length=1024 with -100
    (reference: dataset_2_random.py:292-306), but decoder self-attention is
    causal and trailing pads sit AFTER every real token, so no real
    position ever attends to them: the loss and gradients over the trimmed
    batch are identical while the decoder runs up to ~4x fewer positions.
    `targets_prev` is NOT trimmed: the segmem memory encoder is
    bidirectional, so its pads do influence the memory embedding (matching
    the reference's unmasked segmem encoder — models/t5_segmem.py:57-65).

    NOT safe for batch-internal segmem batches (a segmem model trained
    WITHOUT explicit targets_prev): there the memory ids derive from the
    decoder inputs themselves (models/mt3.py batch_internal_segmem_ids), so
    trimming would change the bidirectional memory encoding. Trainer gates
    on that (_can_bucket)."""
    out = dict(batch)
    for key in keys:
        t = batch.get(key)
        if t is None:
            continue
        valid = np.asarray(t != IGNORE_INDEX).any(axis=0)
        if valid.any():
            last = int(np.nonzero(valid)[0][-1]) + 1
        else:
            last = 1
        length = min(((last + multiple - 1) // multiple) * multiple,
                     t.shape[1])
        out[key] = t[:, :length]
    return out


def batch_to_mel(audio: torch.Tensor, valid_frames: torch.Tensor,
                 spectrogram_config: SpectrogramConfig) -> torch.Tensor:
    """Raw segment audio (B, frames*hop) -> normalized mel (B, frames, bins)
    with padded frames zeroed (reference pads the mel with zeros:
    dataset_2_random.py:296-298)."""
    mel = normalize_logmel(compute_logmel(audio, spectrogram_config))
    frame_idx = torch.arange(mel.shape[1], device=mel.device)[None, :, None]
    return torch.where(frame_idx < valid_frames[:, None, None], mel,
                       mel.new_zeros(()))


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _loss(logits, targets, loss_type):
    if loss_type == 'weighted':
        return weighted_instrument_loss(logits, targets)
    return cross_entropy_loss(logits, targets), {}


def step_generator(seed: int, step: int, device: torch.device,
                   rank: int = 0) -> torch.Generator:
    """The dropout masks' generator of train step `step` on data-parallel
    rank `rank`: seeded with (seed, step[, rank]) mixed, the counterpart of
    jax.random.fold_in(rng, step); rank 0's is the single-process one."""
    entropy = [seed, step] + ([rank] if rank else [])
    mixed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]))


def make_train_step(loss_type: str = 'ce',
                    spectrogram_config: SpectrogramConfig =
                    SpectrogramConfig()) -> Callable:
    """Returns (state, batch, seed) -> metrics: one forward in train mode
    (dropout from step_generator(seed, state.step, rank); none when seed is
    None), the gradients of the loss, one optimizer call, state.step + 1.
    Under a process group `batch` is this rank's slice and the forward
    goes through state.ddp: the loss's counts are all-reduced first, this
    rank's term is its sum over the global counts x world, and DDP's
    gradient mean is the global loss's gradient. The metrics are device
    tensors, the same on every rank: loss, grad_norm (pre-clip, of the
    reduced gradients) and the weighted loss's logs."""

    def train_step(state: TrainState, batch: Dict[str, np.ndarray],
                   seed: Optional[int]) -> Dict:
        params = state.optimizer.params
        dev = params[0].device
        b = batch_to_device(batch, dev)
        state.model.train()
        world = parallel.world() if state.ddp is not None else 1
        generator = (None if seed is None
                     else step_generator(seed, state.step, dev,
                                         parallel.rank()))
        mel = batch_to_mel(b['audio'], b['valid_frames'], spectrogram_config)
        targets = b['targets']
        logits = (state.ddp or state.model)(
            mel, labels=targets, targets_prev=b.get('targets_prev'),
            generator=generator)
        terms = loss_terms(logits, targets, loss_type)
        counts = terms
        if state.ddp is not None:
            counts = {k: parallel.all_reduce_sum(v) for k, v in terms.items()
                      if k.startswith(('n_', 'count'))}
        loss, logs = loss_from_terms(terms, counts, float(world))
        for p in params:
            p.grad = None
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        for p in params:
            p.grad = None
        metrics = {'loss': loss.detach(), 'grad_norm': global_norm(grads),
                   **{k: v.detach() for k, v in logs.items()}}
        if world > 1:
            metrics = {k: v if k == 'grad_norm'
                       else parallel.all_reduce_sum(v) / world
                       for k, v in metrics.items()}
        state.optimizer.step(grads)
        state.step += 1
        return metrics

    return train_step


def make_eval_step(loss_type: str = 'ce',
                   spectrogram_config: SpectrogramConfig =
                   SpectrogramConfig()) -> Callable:
    """Returns (model, batch) -> {'loss', 'num_tokens', ...} in eval mode
    (no dropout, no gradients). num_tokens is the loss's denominator."""

    @torch.no_grad()
    def eval_step(model: MT3, batch: Dict[str, np.ndarray]) -> Dict:
        dev = model.proj.weight.device
        b = batch_to_device(batch, dev)
        model.eval()
        mel = batch_to_mel(b['audio'], b['valid_frames'], spectrogram_config)
        targets = b['targets']
        logits = model(mel, labels=targets,
                       targets_prev=b.get('targets_prev'))
        loss, logs = _loss(logits, targets, loss_type)
        num_tokens = (targets != IGNORE_INDEX).sum()
        if loss_type == 'weighted':
            # weighted CE divides by n_other + n_inst (losses.py)
            num_tokens = num_tokens + ((targets >= INSTRUMENT_TOKEN_LO) &
                                       (targets <= INSTRUMENT_TOKEN_HI)).sum()
        return {'loss': loss, 'num_tokens': num_tokens, **logs}
    return eval_step


class MetricsWriter:
    """Scalar logging to <log_dir>/metrics.jsonl, one JSON object a line."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, 'metrics.jsonl'), 'a')

    def log(self, step: int, scalars: Dict[str, float]):
        record = {'step': int(step),
                  **{k: float(v) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(record) + '\n')
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()


@dataclasses.dataclass
class CheckpointPolicy:
    """ModelCheckpoint-equivalent knobs (reference: config/config.yaml:30-36).

    monitor ranks top-k by a metric logged at validation time: 'val_loss'
    or one of the eval hook's, logged as 'val_<key>' (val_f1_flat, ...) —
    on epochs where the monitored metric was not produced, top-k selection
    is skipped with a warning and only 'last' is written."""
    monitor: str = 'val_loss'
    mode: str = 'min'
    save_last: bool = True
    save_top_k: int = 5
    every_n_epochs: int = 1


def load_checkpoint(path: str) -> Dict:
    """A checkpoint file Trainer.save_checkpoint wrote: {'params':
    state_dict, 'step': int[, 'opt_state': optimizer state]}, on the CPU,
    memory-mapped (a tensor is read when it is used)."""
    blob = torch.load(path, map_location='cpu', weights_only=True,
                      mmap=True)
    if not isinstance(blob, dict) or 'params' not in blob:
        raise ValueError(f'{path} is not a checkpoint of the port\'s '
                         f'trainer (no params)')
    return blob


class Trainer:
    """Minimal but complete training loop.

    eval_hook(model, epoch) -> {name: score}, when given, runs at the end
    of each epoch >= eval_after_num_epoch with epoch % eval_per_epoch ==
    0, after that epoch's validation; its scores are logged as
    'val_<name>' before the checkpoints are ranked, so a policy can
    monitor them. Under a process group it runs on every rank (get_scores
    strides the songs over the ranks), and only rank 0 writes metrics and
    checkpoints."""

    def __init__(
        self,
        model: MT3,
        optimizer,
        loss_type: str = 'ce',
        out_dir: str = 'runs/default',
        checkpoint_policy: CheckpointPolicy = CheckpointPolicy(),
        log_every_n_steps: int = 100,
        check_val_every_n_epoch: int = 1,
        eval_hook: Optional[Callable[[MT3, int], Dict[str, float]]] = None,
        eval_after_num_epoch: int = 0,
        eval_per_epoch: int = 1,
        lr_schedule: Optional[Callable] = None,
        seed: int = 365,
        bucket_targets: bool = True,
        spectrogram_config: Optional[SpectrogramConfig] = None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.out_dir = out_dir
        self.policy = checkpoint_policy
        self.log_every_n_steps = log_every_n_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.eval_hook = eval_hook
        self.eval_after_num_epoch = eval_after_num_epoch
        self.eval_per_epoch = eval_per_epoch
        self.lr_schedule = lr_schedule
        self.seed = seed
        self.bucket_targets = bucket_targets
        # the dataset's filterbank choice (use_tf_spectral_ops) must reach
        # the in-step mel, or the trained features silently disagree with
        # the dataset's configuration
        sc = spectrogram_config or SpectrogramConfig()
        self.train_step = make_train_step(loss_type=loss_type,
                                          spectrogram_config=sc)
        self.eval_step = make_eval_step(loss_type=loss_type,
                                        spectrogram_config=sc)
        self.writes = parallel.rank() == 0
        os.makedirs(out_dir, exist_ok=True)
        self.writer = (MetricsWriter(os.path.join(out_dir, 'logs'))
                       if self.writes else None)
        self._ckpt_dir = os.path.join(os.path.abspath(out_dir), 'checkpoints')
        self._ckpt_scores = []  # (score, name)
        self._topk_created: set = set()  # top-k files THIS run wrote

    def _can_bucket(self, batch) -> bool:
        """Trimming is loss-identical only when the memory ids do not
        derive from the trimmed targets (see bucket_targets docstring).
        Several nodes never bucket: each would trim its own batch to
        another length (mr_mt3_tpu/train/trainer.py:300-310)."""
        if parallel.node_count() > 1:
            return False
        return self.bucket_targets and (
            not self.model.cfg.has_segmem or 'targets_prev' in batch)

    def _slice(self, batch):
        """This rank's rows of its node's batch (the whole batch without a
        process group)."""
        if not torch.distributed.is_initialized():
            return batch
        return parallel.shard_batch(batch, parallel.local_world(),
                                    parallel.local_rank())

    def _log(self, step: int, scalars: Dict[str, float]):
        if self.writer is not None:
            self.writer.log(step, scalars)

    # ---- checkpointing (torch.save files) ----

    def _path(self, name_or_path: str) -> str:
        if os.path.isabs(name_or_path):
            return name_or_path
        return os.path.join(self._ckpt_dir, name_or_path)

    def save_checkpoint(self, state: TrainState, name: str):
        """Save params, optimizer state and step (an exact resume, as the
        reference's .ckpt files give); written to a temporary file and
        renamed into place, by rank 0 alone, every rank waiting for it."""
        if self.writes:
            os.makedirs(self._ckpt_dir, exist_ok=True)
            payload = {'params': state.model.state_dict(),
                       'step': int(state.step),
                       'opt_state': state.optimizer.state_dict()}
            path = self._path(name)
            tmp = f'{path}.{os.getpid()}.tmp'
            torch.save(payload, tmp)
            os.replace(tmp, path)
        parallel.barrier()

    def restore_state(self, name_or_path: str,
                      state: TrainState) -> TrainState:
        """Full resume into `state` (its model and bound optimizer): params
        + optimizer state + step."""
        blob = load_checkpoint(self._path(name_or_path))
        state.model.load_state_dict(blob['params'], strict=True)
        state.optimizer.load_state_dict(blob['opt_state'])
        state.step = int(blob['step'])
        return state

    def _maybe_save_topk(self, state: TrainState, epoch: int,
                         metrics: Dict[str, float]):
        """metrics: the epoch's logged values ({'val_loss': ..}) — top-k
        ranks by policy.monitor among them, like Lightning's
        ModelCheckpoint over logged metrics."""
        if self.policy.save_last:
            self.save_checkpoint(state, 'last')
        # Lightning gates on completed-epoch count: save when
        # (epoch + 1) % every_n_epochs == 0 — NOT on epoch 0
        if (epoch + 1) % max(1, self.policy.every_n_epochs):
            return
        if self.policy.save_top_k == 0:
            return
        monitor = self.policy.monitor
        if monitor not in metrics:
            print(f'WARNING: modelcheckpoint.monitor={monitor!r} not '
                  f'among this epoch\'s metrics {sorted(metrics)} — '
                  'skipping top-k selection')
            return
        value = float(metrics[monitor])
        name = f'epoch={epoch}-{monitor}={value:.4f}'
        self._ckpt_scores.append((value, name))
        reverse = self.policy.mode == 'max'
        self._ckpt_scores.sort(key=lambda x: x[0], reverse=reverse)
        keep = (self._ckpt_scores if self.policy.save_top_k < 0
                else self._ckpt_scores[:self.policy.save_top_k])
        if (value, name) in keep:
            self.save_checkpoint(state, name)
            self._topk_created.add(name)
        # prune dropped checkpoints — but ONLY ones this run created as
        # top-k entries: a resumed run starts with empty _ckpt_scores, and
        # deleting every unknown file would destroy the previous run's best
        # checkpoints (and 'final') on the first post-resume validation
        keep_names = {n for _, n in keep} | {'last'}
        for entry in self._topk_created - keep_names:
            if self.writes:
                try:
                    os.remove(os.path.join(self._ckpt_dir, entry))
                except FileNotFoundError:
                    pass
        parallel.barrier()
        self._topk_created &= keep_names
        self._ckpt_scores = keep

    # ---- loop ----

    def fit(self, state: TrainState, train_loader, val_loader=None,
            num_epochs: int = 1, start_epoch: int = 0) -> TrainState:
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            for batch in train_loader:
                if self._can_bucket(batch):
                    batch = bucket_targets(batch)
                metrics = self.train_step(state, self._slice(batch),
                                          self.seed)
                step = state.step
                if step % self.log_every_n_steps == 0 and self.writes:
                    scalars = {f'train_{k}': float(v)
                               for k, v in metrics.items()}
                    if self.lr_schedule is not None:
                        # the update that produced `step` read the
                        # schedule at count step-1 — log the LR applied
                        scalars['lr'] = float(self.lr_schedule(step - 1))
                    self._log(step, scalars)
            epoch_time = time.time() - t0

            run_val = (val_loader is not None and
                       (epoch + 1) % self.check_val_every_n_epoch == 0)
            if run_val:
                val_loss = self.validate(state, val_loader)
                self._log(state.step,
                                {'val_loss': val_loss,
                                 'epoch': epoch,
                                 'epoch_time_s': epoch_time})

            # the eval hook runs BEFORE checkpoint ranking so a policy
            # monitoring an eval metric (val_f1_flat, ...) sees it — as
            # Lightning, where the reference logs F1 in
            # on_validation_epoch_end and ModelCheckpoint reads the logged
            # metrics (tasks/mt3_base.py:27-46)
            eval_scores = {}
            if (self.eval_hook is not None and
                    epoch >= self.eval_after_num_epoch and
                    epoch % max(1, self.eval_per_epoch) == 0):
                # guarded: a hook crash (bad eval glob, decode OOM) must
                # not cost the epoch's 'last'/top-k checkpoints — rank on
                # val_loss alone instead
                try:
                    scores = self.eval_hook(state.model, epoch)
                except Exception:
                    import traceback
                    traceback.print_exc()
                    scores = None
                if scores:
                    eval_scores = {f'val_{k}': v for k, v in scores.items()}
                    self._log(state.step, eval_scores)

            if run_val:
                self._maybe_save_topk(
                    state, epoch, {'val_loss': val_loss, **eval_scores})
            elif self.policy.save_last:
                self.save_checkpoint(state, 'last')
        return state

    def validate(self, state: TrainState, val_loader) -> float:
        """Token-weighted mean val loss: each batch's loss is a mean over
        its real target tokens, so weighting by that count gives the exact
        corpus-level mean, unbiased by partial batches. Under a process
        group each rank takes its slice of each batch, and the two sums
        are all-reduced."""
        loss_sum, token_sum = self.validation_sums(state, val_loader)
        return loss_sum / token_sum if token_sum else float('nan')

    def validation_sums(self, state: TrainState, val_loader):
        """(sum of loss x num_tokens, sum of num_tokens) over the loader,
        over every rank."""
        loss_sum, token_sum = 0.0, 0.0
        for batch in val_loader:
            if self._can_bucket(batch):
                batch = bucket_targets(batch)
            metrics = self.eval_step(state.model, self._slice(batch))
            n = float(metrics['num_tokens'])
            loss_sum += float(metrics['loss']) * n
            token_sum += n
        if torch.distributed.is_initialized():
            dev = state.optimizer.params[0].device
            sums = parallel.all_reduce_sum(torch.tensor(
                [loss_sum, token_sum], dtype=torch.float64, device=dev))
            loss_sum, token_sum = (float(x) for x in sums.cpu())
        return loss_sum, token_sum
