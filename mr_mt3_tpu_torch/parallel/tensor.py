"""The model axis: Megatron-style tensor parallelism over a Mesh's model
groups (the port of JAX's _PARAM_RULES placement, which GSPMD partitions
with the all-reduces XLA inserts; here the collectives are explicit).

shard_model(model, mesh) slices a full MT3 in place into this rank's shard
by parallel.param_shardings: the attention's q / k / v and the gated
feed-forward's wi_0 / wi_1 become column-parallel linears (this rank's
heads or d_ff columns), o and wo row-parallel ones (the partial products
summed over the model group, one all-reduce a pair), the decoder embedding
a vocab-parallel embedding (rows outside the rank's range embed as zeros,
then an all-reduce: exact, it adds zeros), and the lm_head a gathered one
(the logits all-gathered over the model group before the loss and before
argmax, so the argmax and its ties equal one rank's). The collectives are
autograd functions:

  copy_to_model      identity forward, all-reduce of the gradient backward
  reduce_from_model  all-reduce forward, identity backward
  gather_from_model  all-gather on the last dim forward, the rank's slice
                     of the gradient backward

A sharded model's full tensors come back with full_state_dict (an
all-gather over the model group) and go in with shard_state_dict (a
slice); unsharded_copy builds a one-rank model from them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from mr_mt3_tpu_torch.parallel.mesh import Mesh, param_shardings


class ModelAxis:
    """One rank's place on a mesh's model axis: the mesh, its model group,
    the rank's index in it and the axis's size; `plan` holds every
    parameter's sharded dimension (param_shardings)."""

    def __init__(self, mesh: Mesh, cfg):
        self.mesh = mesh
        self.size = mesh.model
        self.index = mesh.model_index()
        self.group = mesh.model_group()
        self.plan = param_shardings(cfg, mesh.model)
        # which parts shard: every attention, every feed-forward, the
        # vocabulary (the embedding and the lm_head)
        self.attention = self.plan[
            'decoder.block.0.layer.0.SelfAttention.q.weight'] is not None
        self.feed_forward = self.plan[
            'decoder.block.0.layer.2.DenseReluDense.wi_0.weight'] is not None
        self.vocab = self.plan['lm_head.weight'] is not None
        # the eager step loops' decision, printed once (use_graphs)
        self.said_eager = False

    def backend(self) -> str:
        return dist.get_backend(self.group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-1)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index):
        ctx.width, ctx.index = x.shape[-1], index
        return _all_gather_last(x, group)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.index * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _CopyToModel.apply(x, axis.group)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _ReduceFromModel.apply(x, axis.group)


def gather_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _GatherFromModel.apply(x, axis.group, axis.index)


class ColumnParallelLinear(nn.Module):
    """This rank's output features of a bias-free linear (weight (out / m,
    in)), computing in the input's dtype as models/mt3.py's _Linear; the
    input's gradient is summed over the model group."""

    def __init__(self, weight: torch.Tensor, axis: ModelAxis):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model(x, self.axis)
        return nn.functional.linear(x, self.weight.to(x.dtype))


class RowParallelLinear(nn.Module):
    """This rank's input features of a bias-free linear (weight (out,
    in / m)) on this rank's part of the input; the partial products are
    summed over the model group."""

    def __init__(self, weight: torch.Tensor, axis: ModelAxis):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from_model(
            nn.functional.linear(x, self.weight.to(x.dtype)), self.axis)


class GatheredLinear(ColumnParallelLinear):
    """The lm_head: this rank's vocabulary columns, the logits all-gathered
    over the model group (every rank holds the full logits)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gather_from_model(super().forward(x), self.axis)


def vocab_parallel_lookup(weight: torch.Tensor, ids: torch.Tensor,
                          start: int, axis: ModelAxis) -> torch.Tensor:
    """Rows `ids` of an embedding whose rows [start, start + len(weight))
    this rank holds: the others embed as zeros, then the sum over the
    model group (exact: each id's row comes from one rank, the others add
    zeros)."""
    local = ids - start
    inside = (local >= 0) & (local < weight.shape[0])
    rows = weight[local.clamp(0, weight.shape[0] - 1)]
    rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    return reduce_from_model(rows, axis)


class VocabParallelEmbedding(nn.Module):
    """The decoder embedding's rows [index * V / m, (index + 1) * V / m)."""

    def __init__(self, weight: torch.Tensor, axis: ModelAxis):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.axis = axis
        self.start = axis.index * weight.shape[0]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return vocab_parallel_lookup(self.weight, ids, self.start, self.axis)


def _part(t: torch.Tensor, dim: Optional[int], axis: ModelAxis
          ) -> torch.Tensor:
    """This rank's slice of a full tensor on `dim` (t where None)."""
    if dim is None:
        return t
    return t.detach().chunk(axis.size, dim=dim)[axis.index].clone()


def shard_model(model, mesh: Mesh):
    """Slice a full MT3 (its full weights loaded) in place into this
    rank's shard for `mesh` (model > 1): the modules of the plan above,
    each attention's n_heads and each feed-forward's shard set, model.tp
    the rank's ModelAxis. Returns the model."""
    from mr_mt3_tpu_torch.models.mt3 import Attention, DenseReluDense
    if mesh.model == 1:
        raise ValueError('a mesh with a model axis of 1 shards nothing')
    if model.tp is not None:
        raise ValueError('the model is already sharded')
    axis = ModelAxis(mesh, model.cfg)
    for module in list(model.modules()):
        if isinstance(module, Attention):
            if not axis.attention:
                continue
            for name in ('q', 'k', 'v'):
                setattr(module, name, ColumnParallelLinear(
                    _part(getattr(module, name).weight, 0, axis), axis))
            module.o = RowParallelLinear(_part(module.o.weight, 1, axis),
                                         axis)
            module.n_heads = model.cfg.num_heads // axis.size
        elif isinstance(module, DenseReluDense):
            if not axis.feed_forward:
                continue
            for name in ('wi_0', 'wi_1'):
                setattr(module, name, ColumnParallelLinear(
                    _part(getattr(module, name).weight, 0, axis), axis))
            module.wo = RowParallelLinear(_part(module.wo.weight, 1, axis),
                                          axis)
            module.shard = (axis.index, axis.size)
    if axis.vocab:
        model.lm_head = GatheredLinear(_part(model.lm_head.weight, 0, axis),
                                       axis)
        model.decoder_embed_tokens = VocabParallelEmbedding(
            _part(model.decoder_embed_tokens.weight, 0, axis), axis)
    model.tp = axis
    return model


def full_tensor(t: torch.Tensor, name: str, axis: Optional[ModelAxis]
                ) -> torch.Tensor:
    """The full tensor of parameter `name` (or of its gradient or moment)
    from every model rank's shard: an all-gather over the model group on
    its sharded dim; t itself where it is replicated or without an axis.
    Every rank of the model group must call it."""
    dim = None if axis is None else axis.plan.get(name)
    if dim is None:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return torch.cat(parts, dim=dim)


def local_tensor(t: torch.Tensor, name: str, axis: Optional[ModelAxis]
                 ) -> torch.Tensor:
    """This rank's shard of the full tensor of parameter `name`."""
    if axis is None:
        return t
    return _part(t, axis.plan.get(name), axis)


def full_state_dict(model) -> Dict[str, torch.Tensor]:
    """The state_dict a one-rank model of the same weights has (a
    collective over the model group where the model is sharded)."""
    return {k: full_tensor(v, k, model.tp)
            for k, v in model.state_dict().items()}


def shard_state_dict(state_dict: Dict[str, torch.Tensor], model
                     ) -> Dict[str, torch.Tensor]:
    """A full state_dict sliced for `model`'s shard (as it is without a
    model axis)."""
    return {k: local_tensor(v, k, model.tp) for k, v in state_dict.items()}


def map_param_lists(state: Any, names, fn) -> Any:
    """An optimizer state_dict with every list of one tensor per parameter
    (AdamW's moments, MultiSteps' running mean) mapped by fn(tensor,
    name); counts and other entries kept."""
    if isinstance(state, dict):
        return {k: map_param_lists(v, names, fn) for k, v in state.items()}
    if isinstance(state, list) and len(state) == len(names) and all(
            isinstance(t, torch.Tensor) for t in state):
        return [fn(t, n) for t, n in zip(state, names)]
    return state


def unsharded_copy(model):
    """A one-rank MT3 with the full weights of a sharded one, on its
    device (a collective over the model group); the model itself where it
    is not sharded."""
    if model.tp is None:
        return model
    from mr_mt3_tpu_torch.models import MT3
    full = full_state_dict(model)
    device = next(model.parameters()).device
    out = MT3(model.cfg)
    out.load_state_dict(full)
    return out.to(device).train(model.training)
