"""Optimizer and LR schedules (port of mr_mt3_tpu/train/optim.py).

Replicates the reference's AdamW + cosine-with-warmup setup including its
min_lr quirk: the floor applies to the *multiplier*, not the learning rate,
so the effective floor is min_lr * base_lr (reference: utils.py:53-60 —
replicated deliberately for training-curve parity, see SURVEY §7).

The optimizer is written out rather than taken from torch.optim so that it
computes what the JAX package's optax chain computes, step for step:

  * AdamW is optax.adamw: Adam moments in f32 with bias correction, then
    decoupled weight decay added to the update (every parameter, one
    group), then scaled by -lr, the schedule read at the count BEFORE the
    step (optax increments its count after scaling);
  * clip_norm is optax.clip_by_global_norm, applied before Adam: the
    gradients are kept when their global norm is below clip_norm, else
    divided by the norm and multiplied by clip_norm (no epsilon, unlike
    torch.nn.utils.clip_grad_norm_);
  * MultiSteps is optax.MultiSteps: a running mean of k gradients, and one
    optimizer step (and one schedule count) per k; between them the
    parameters do not move.

Parameters and moments stay f32 and are updated in place, on the device
the parameters live on (foreach ops, no host round trip but the clip test).
On a model axis each rank holds its shards of the parameters: the global
norm sums the sharded tensors' squares over the model group and counts the
replicated ones once (global_norm's model_axis), so the clip equals the
one-rank clip.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def cosine_schedule_with_warmup(
    base_lr: float,
    warmup_steps: int,
    total_steps: int,
    min_lr_multiplier: float = 2e-5,
    num_cycles: float = 0.5,
) -> Schedule:
    """Linear warmup then cosine decay, floored at min_lr_multiplier.

    Note the floor is a dimensionless multiplier on base_lr, matching the
    reference exactly. Computed in float32, as the JAX schedule is."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        warm = step / f32(max(1.0, float(warmup_steps)))
        progress = (step - f32(warmup_steps)) / f32(
            max(1.0, total_steps - warmup_steps))
        cosine = f32(0.5) * (f32(1.0) + np.cos(
            f32(math.pi * num_cycles * 2.0) * progress))
        decay = max(f32(min_lr_multiplier), cosine)
        return float(f32(base_lr) * (warm if step < warmup_steps else decay))
    return schedule


def noam_schedule(base_factor: float = 0.002, warmup_steps: int = 1000,
                  model_dim: int = 512) -> Schedule:
    """Noam LR (reference: utils.py:7-19; unused by the tasks but part of
    the utils surface). base_factor is honored, with the reference's
    hardcoded 0.002 as the default."""
    def schedule(step: int) -> float:
        cur = float(step) + 2.0
        return (base_factor * model_dim ** 0.5 *
                min(cur ** -0.5, cur * warmup_steps ** -1.5))
    return schedule


def linear_warmup_to_constant(warmup_steps: int, base_lr: float) -> Schedule:
    """MT3's original fixed-LR-after-warmup (reference: utils.py:65-73)."""
    def schedule(step: int) -> float:
        return base_lr * min(1.0, float(step) / warmup_steps)
    return schedule


def global_norm(tensors: Sequence[torch.Tensor],
                model_axis=None) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm), f32,
    on the tensors' device. model_axis (group, sharded): the tensors are a
    rank's shards, sharded[i] True where tensor i is a slice of its whole
    (its squares summed over the model group) and False where every model
    rank holds it whole (counted once)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    squares = torch.stack(norms).square()
    if model_axis is None:
        return squares.sum().sqrt()
    import torch.distributed as dist
    group, sharded = model_axis
    mask = torch.tensor(sharded, device=squares.device)
    total = squares[mask].sum().reshape(1)
    dist.all_reduce(total, group=group)
    return (total[0] + squares[~mask].sum()).sqrt()


class AdamW:
    """optax.adamw, with optax.clip_by_global_norm before it when clip_norm
    is set, over a list of f32 parameters updated in place.

    init(params) binds the parameters and zeroes the moments; step(grads)
    applies one update; count is the number of updates so far (the
    schedule's argument for the next one)."""

    def __init__(self, learning_rate: Union[float, Schedule],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01,
                 clip_norm: Optional[float] = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.params: List[torch.Tensor] = []
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []
        self.count = 0
        self.model_axis = None

    def init(self, params: Sequence[torch.Tensor], model_axis=None) -> None:
        """Bind the parameters, zero the moments; model_axis as in
        global_norm where they are a rank's shards."""
        self.params = list(params)
        self.model_axis = model_axis
        for p in self.params:
            if p.dtype != torch.float32:
                raise ValueError(f'parameters must be float32 (got '
                                 f'{p.dtype}): the optimizer state is f32')
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def lr(self, count: int) -> float:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return float(self.learning_rate)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = [g.float() for g in grads]
        if self.clip_norm is not None:
            norm = global_norm(grads, self.model_axis)
            if not float(norm) < self.clip_norm:
                grads = torch._foreach_div(grads, norm)
                torch._foreach_mul_(grads, self.clip_norm)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        squares = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, squares, alpha=1.0 - b2)
        t = self.count + 1
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1 ** t)
        nu_hat = torch._foreach_div(self.nu, 1.0 - b2 ** t)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, self.eps)
        torch._foreach_div_(mu_hat, nu_hat)           # the Adam update
        if self.weight_decay:
            torch._foreach_add_(mu_hat, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, mu_hat, alpha=-self.lr(self.count))
        self.count = t

    def state_dict(self) -> Dict:
        """The count and the moments (the live tensors, as
        torch.optim's state_dict gives them)."""
        return {'count': self.count, 'mu': list(self.mu),
                'nu': list(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        if len(state['mu']) != len(self.params):
            raise ValueError(f'optimizer state for {len(state["mu"])} '
                             f'parameters, {len(self.params)} bound')
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, state['mu'] + state['nu']):
                dst.copy_(src)
        self.count = int(state['count'])


class MultiSteps:
    """optax.MultiSteps(inner, every_k_schedule=k): gradients averaged over
    k calls (a running mean), one inner step on the k-th; the parameters
    stay put in between. count is the inner optimizer's."""

    def __init__(self, inner: AdamW, every_k: int):
        if every_k < 1:
            raise ValueError(f'every_k must be >= 1 (got {every_k})')
        self.inner, self.every_k = inner, every_k
        self.acc: List[torch.Tensor] = []
        self.mini_step = 0

    @property
    def count(self) -> int:
        return self.inner.count

    @property
    def params(self) -> List[torch.Tensor]:
        return self.inner.params

    @property
    def model_axis(self):
        return self.inner.model_axis

    def init(self, params: Sequence[torch.Tensor], model_axis=None) -> None:
        self.inner.init(params, model_axis)
        self.acc = [torch.zeros_like(p) for p in self.inner.params]
        self.mini_step = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        diff = torch._foreach_sub([g.float() for g in grads], self.acc)
        torch._foreach_div_(diff, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, diff)
        if self.mini_step == self.every_k - 1:
            self.inner.step(self.acc)
            torch._foreach_zero_(self.acc)
            self.mini_step = 0
        else:
            self.mini_step += 1

    def state_dict(self) -> Dict:
        return {'inner': self.inner.state_dict(), 'acc': list(self.acc),
                'mini_step': self.mini_step}

    def load_state_dict(self, state: Dict) -> None:
        self.inner.load_state_dict(state['inner'])
        with torch.no_grad():
            for dst, src in zip(self.acc, state['acc']):
                dst.copy_(src)
        self.mini_step = int(state['mini_step'])


def make_optimizer(
    lr: float,
    warmup_steps: Optional[int] = None,
    total_steps: Optional[int] = None,
    min_lr: float = 2e-5,
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    use_schedule: bool = True,
    schedule: Optional[Schedule] = None,
    clip_norm: Optional[float] = None,
) -> AdamW:
    """AdamW matching torch defaults (wd applied to every parameter, as
    torch AdamW does with a single param group — reference tasks use
    AdamW(params, lr) with default weight_decay=0.01).

    schedule: a prebuilt LR schedule used verbatim (callers that also log
    the schedule build it once). clip_norm: optional global-gradient-norm
    clip applied BEFORE Adam; off by default as in the reference (Lightning
    does not clip)."""
    if schedule is None:
        if use_schedule:
            if warmup_steps is None or total_steps is None:
                raise ValueError('schedule needs warmup_steps and '
                                 'total_steps')
            schedule = cosine_schedule_with_warmup(
                lr, warmup_steps, total_steps, min_lr_multiplier=min_lr)
        else:
            # the FineTune task: plain AdamW, constant LR
            # (reference: tasks/mt3_net_segmem_v2_with_prev_finetune.py:14-19)
            schedule = lr
    return AdamW(schedule, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 clip_norm=clip_norm)
