"""The device mesh: the data axis and the model axis (port of
mr_mt3_tpu/parallel/mesh.py).

The JAX package spans its chips with a ('data', 'model') mesh: decode
shards its batch over 'data' inside one program (shard_map), and training
runs one SPMD program whose gradient all-reduce XLA inserts. The reference
it rebuilds trains under Lightning DDP over NCCL. The port takes
PyTorch's idiom for the same axis:

  JAX package              port
  one process              one node
  one chip                 one rank with its card
  jax.process_index()      the node rank (node_rank())
  jax.process_count()      the number of nodes (node_count())

  * training and multi-node evaluation run one process per card under
    torch.distributed (init_multihost; DistributedDataParallel in
    train/trainer.py), each rank on its slice of the batch (shard_batch);
  * serving and single-node evaluation keep one process, and shard_map
    over 'data' becomes one model replica per card of a Mesh inside it
    (infer/handler.py), each decoding its part of a call's rows on a host
    thread of its own.

A Mesh may name a device more than once: the CPU has one torch device, and
a machine with one card has one card, so the CPU tests run meshes of
('cpu',) * n and the one-card smoke a mesh of cuda:0 twice, the replicas
then sharing the device.

The model axis (tensor parallelism, JAX's _PARAM_RULES) is Megatron-style
in the port: a Mesh with model > 1 is a grid of data x model ranks of one
process group, one device each, in JAX's make_mesh order
(devices.reshape(data, model): rank r has data index r // model and model
index r % model). Each grid row is a model group, whose ranks hold the
shards of one model (parallel/tensor.py) and meet in its collectives; each
column is a data group, over which the batch splits and the gradients are
averaged. param_shardings gives each parameter's sharded dimension.

The collectives here are all_reduce, all_gather, broadcast and barrier,
which both NCCL and gloo serve, on the card and on the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mr_mt3_tpu_torch.utils.device import resolve_device

# every process group's collectives time out: a rank that never arrives
# fails the others instead of hanging them
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh's devices (torch.device, repeats allowed) and the model
    axis's size. model 1: the data axis's devices, one replica each in
    this process. model > 1: a grid of len(devices) ranks of the process
    group, data x model in JAX's order, rank r on devices[r]."""
    devices: Tuple[torch.device, ...]
    model: int = 1

    def __post_init__(self):
        model = int(self.model)
        if model < 1:
            raise ValueError(f'model axis {model} < 1')
        if not self.devices:
            raise ValueError('a mesh needs at least one device')
        if len(self.devices) % model:
            raise ValueError(f'{len(self.devices)} devices not divisible '
                             f'by model={model}')
        devices = tuple(resolve_device(d) for d in self.devices)
        for d in devices:
            if d.type == 'cuda' and (d.index or 0) >= \
                    torch.cuda.device_count():
                raise ValueError(f'{d} is not a visible card '
                                 f'({torch.cuda.device_count()} visible)')
        object.__setattr__(self, 'devices', devices)
        object.__setattr__(self, 'model', model)

    @property
    def n_data(self) -> int:
        return len(self.devices) // self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {'data': self.n_data, 'model': self.model}

    # ---- the rank grid (model > 1) ----

    def _grid(self) -> '_Grid':
        if not dist.is_initialized():
            raise RuntimeError('a mesh with a model axis > 1 is a grid of '
                               'ranks: join a process group first '
                               '(init_multihost)')
        if dist.get_world_size() != len(self.devices):
            raise ValueError(f'the mesh has {len(self.devices)} ranks, the '
                             f'process group {dist.get_world_size()}')
        return _grid(self.n_data, self.model)

    def model_index(self) -> int:
        """This rank's place in its model group (0 without a grid)."""
        return rank() % self.model if self.model > 1 else 0

    def data_index(self) -> int:
        """This rank's place in its data group: the grid's row (the rank
        itself at model 1)."""
        return rank() // self.model

    def model_group(self):
        """The process group of this rank's grid row (None at model 1)."""
        if self.model == 1:
            return None
        return self._grid().model_groups[self.data_index()]

    def data_group(self):
        """The process group of this rank's grid column (the default group
        at model 1)."""
        if self.model == 1:
            return dist.group.WORLD if dist.is_initialized() else None
        return self._grid().data_groups[self.model_index()]

    def rank_device(self) -> torch.device:
        """This rank's device: devices[rank] on a grid, else the first."""
        return self.devices[rank()] if self.model > 1 else self.devices[0]


@dataclasses.dataclass
class _Grid:
    model_groups: List[Any]      # by data index: the ranks of a row
    data_groups: List[Any]       # by model index: the ranks of a column


# the process groups of each grid shape, made once a process group
# (shutdown forgets them)
_GRIDS: Dict[Tuple[int, int], _Grid] = {}


def _grid(data: int, model: int) -> _Grid:
    """Every row's and every column's process group, created the first
    time on every rank in the same order (dist.new_group is collective
    over the default group)."""
    key = (data, model)
    if key not in _GRIDS:
        rows = [dist.new_group([d * model + m for m in range(model)])
                for d in range(data)]
        cols = [dist.new_group([d * model + m for d in range(data)])
                for m in range(model)]
        _GRIDS[key] = _Grid(rows, cols)
    return _GRIDS[key]


# The model axis's placement (JAX's _PARAM_RULES on the port's HF names;
# a JAX kernel is (in, out), a torch weight (out, in)): attention q/k/v,
# the gated feed-forward's wi_0 / wi_1 and the lm_head shard their output
# features (torch dim 0), o and wo their input features (dim 1), so each
# pair needs one all-reduce; the decoder embedding shards its rows (the
# vocabulary). Everything else (proj, every norm) is replicated. The
# segment-memory encoder's attention and feed-forward follow the rules,
# as JAX's patterns match them. Each rule's unit is what must divide by
# the model axis: the head count for attention (the port shards whole
# heads; JAX shards q/k/v wherever num_heads * d_kv divides), d_ff, the
# vocabulary.
_PARAM_RULES = (
    (re.compile(r'(SelfAttention|EncDecAttention)\.(q|k|v)\.weight$'), 0,
     'num_heads'),
    (re.compile(r'(SelfAttention|EncDecAttention)\.o\.weight$'), 1,
     'num_heads'),
    (re.compile(r'DenseReluDense\.(wi_0|wi_1)\.weight$'), 0, 'd_ff'),
    (re.compile(r'DenseReluDense\.wo\.weight$'), 1, 'd_ff'),
    (re.compile(r'^lm_head\.weight$'), 0, 'vocab_size'),
    (re.compile(r'^decoder_embed_tokens\.weight$'), 0, 'vocab_size'),
)


def param_shardings(cfg, model: int) -> Dict[str, Optional[int]]:
    """The placement of every parameter of MT3(cfg) on a model axis of
    `model` ranks: state-dict key -> its sharded dimension, or None where
    it is replicated (the first matching rule whose unit divides by
    model; everything at model 1). The counterpart of JAX's
    param_shardings(params, mesh)."""
    from mr_mt3_tpu_torch.models import MT3
    with torch.device('meta'):
        names = [n for n, _ in MT3(cfg).named_parameters()]
    plan = dict.fromkeys(names)
    for name in names if model > 1 else ():
        for pattern, dim, unit in _PARAM_RULES:
            if pattern.search(name):
                if getattr(cfg, unit) % model == 0:
                    plan[name] = dim
                break
    return plan


def visible_devices(kind: str = 'cuda') -> list:
    """Every visible card (kind 'cuda'), or the one CPU device."""
    if torch.device(kind).type == 'cpu':
        return [torch.device('cpu')]
    resolve_device('cuda')
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A Mesh of the first data * model devices; data fills the devices
    (default: every visible card). The errors are the JAX function's. With
    model > 1 the mesh is a grid of data * model ranks (Mesh)."""
    if devices is None:
        devices = visible_devices('cuda')
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f'{n} devices not divisible by model={model}')
        data = n // model
    if data * model > n:
        raise ValueError(f'mesh {data}x{model} exceeds {n} devices')
    return Mesh(tuple(devices[:data * model]), model=model)


def device_cap(devices_cfg: Any) -> Optional[int]:
    """Normalize the config's `devices` override to a data-axis size.

    Reference command lines pass Lightning forms (reference train.sh:6
    `devices=[0,1]`, config/config.yaml:2 `devices: 1`): an int is a
    device COUNT, a list of device indices counts its length (only how
    many, not which), and null/absent/non-positive means every visible
    device."""
    if devices_cfg is None:
        return None
    if isinstance(devices_cfg, (list, tuple)):
        return len(devices_cfg) or None
    n = int(devices_cfg)
    return n if n > 0 else None


def data_devices(devices_cfg: Any, device: torch.device) -> int:
    """How many devices of `device`'s kind a `devices:` value asks for:
    device_cap's count, or every visible one (one on the CPU)."""
    return device_cap(devices_cfg) or len(visible_devices(device.type))


def grid_data(devices_cfg: Any, model: int, device: torch.device) -> int:
    """The data axis of a data x model grid of ranks (train.py's
    make_mesh(data=device_cap(devices), model=model_devices)): the
    `devices` count, else the visible cards over model, with make_mesh's
    error where they do not divide; on the CPU, whose ranks share its one
    device, the count or 1."""
    cap = device_cap(devices_cfg)
    if cap or device.type == 'cpu' or model == 1:
        return cap or data_devices(devices_cfg, device)
    n = len(visible_devices('cuda'))
    if n % model:
        raise ValueError(f'{n} devices not divisible by model={model}')
    return n // model


def rank_devices(kind: str = 'cuda') -> Tuple[torch.device, ...]:
    """Every rank's device (rank_device's rule), by rank: the devices of a
    grid of the process group's ranks."""
    if torch.device(kind).type == 'cpu':
        return (torch.device('cpu'),) * world()
    resolve_device('cuda')
    count = torch.cuda.device_count()
    return tuple(torch.device('cuda', (r % local_world()) % count)
                 for r in range(world()))


# ---- process groups: one process per card ----

def backend_for(device: torch.device) -> str:
    """NCCL for ranks on cards, gloo for ranks on the CPU."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise ValueError(
            f'{name} is not set: init_multihost joins a process group from '
            'the launcher\'s environment (torchrun sets MASTER_ADDR, '
            'MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK)')
    return int(value)


def init_multihost(backend: Optional[str] = None,
                   timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                   init_method: Optional[str] = None) -> None:
    """torch.distributed.init_process_group from the launcher's standard
    environment (WORLD_SIZE, RANK, LOCAL_RANK; MASTER_ADDR and MASTER_PORT
    for the default env:// rendezvous, or another init_method such as a
    file:// store). The counterpart of jax.distributed.initialize.

    backend: 'nccl' on the card (the default where one is visible), 'gloo'
    on the CPU; 'gloo' on the card also serves, for ranks that share a card
    (NCCL refuses two ranks on one device). On the card the process's
    current device becomes rank_device('cuda'). The timeout is finite."""
    if dist.is_initialized():
        raise RuntimeError('a process group is already initialized')
    world, rank = _env_int('WORLD_SIZE'), _env_int('RANK')
    _env_int('LOCAL_RANK')
    if init_method is None:
        for name in ('MASTER_ADDR', 'MASTER_PORT'):
            if not os.environ.get(name):
                raise ValueError(f'{name} is not set: the env:// '
                                 'rendezvous needs it')
        init_method = 'env://'
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if backend == 'nccl' or (backend == 'gloo' and torch.cuda.is_available()
                             and torch.cuda.device_count()):
        torch.cuda.set_device(rank_device('cuda'))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout)


def shutdown() -> None:
    """Leave the process group, if there is one."""
    _GRIDS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This rank's index on its node (LOCAL_RANK, else the rank)."""
    return int(os.environ.get('LOCAL_RANK', rank())) \
        if dist.is_initialized() else 0


def local_world() -> int:
    """Ranks per node (LOCAL_WORLD_SIZE, else every rank on one node)."""
    return int(os.environ.get('LOCAL_WORLD_SIZE', world())) \
        if dist.is_initialized() else 1


def node_rank() -> int:
    """This node's index: jax.process_index()'s counterpart."""
    return rank() // local_world()


def node_count() -> int:
    """The number of nodes: jax.process_count()'s counterpart."""
    return world() // local_world()


def rank_device(kind: str = 'cuda') -> torch.device:
    """This rank's device: card LOCAL_RANK (ranks past the visible cards
    share them in turn), or the CPU."""
    if torch.device(kind).type == 'cpu':
        return torch.device('cpu')
    resolve_device('cuda')
    return torch.device('cuda', local_rank() % torch.cuda.device_count())


def local_mesh(kind: str = 'cuda') -> Optional[Mesh]:
    """A Mesh of this process's own devices, or None where it has one (a
    rank of a process group owns one card; without a group the process
    owns every visible card)."""
    devices = ([rank_device(kind)] if dist.is_initialized()
               else visible_devices(kind))
    return make_mesh(devices=devices) if len(devices) > 1 else None


def _comm_device() -> torch.device:
    """Where a collective's own tensors live: the card for NCCL, else the
    CPU."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of t over every rank of `group` (default: every rank; t
    itself without a process group). gloo takes card tensors too; NCCL
    takes only card tensors, so a CPU tensor goes through the card
    there."""
    if not dist.is_initialized():
        return t
    dev = _comm_device()
    if dev.type == 'cuda' and not t.is_cuda:
        out = t.to(dev)
        dist.all_reduce(out, group=group)
        return out.to(t.device)
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0
                   ) -> torch.Tensor:
    """The ranks' t (equal shapes) concatenated along dim in rank order of
    `group` (default: every rank; t itself without a process group)."""
    if not dist.is_initialized():
        return t
    dev = _comm_device()
    src = t.to(dev).contiguous() if dev.type == 'cuda' else t.contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast_object(obj: Any) -> Any:
    """Rank 0's JSON-serializable object, on every rank (the JAX package's
    _broadcast_scores: JSON bytes, their length first, by broadcast)."""
    if not dist.is_initialized():
        return obj
    dev = _comm_device()
    payload = json.dumps(obj).encode() if rank() == 0 else b''
    length = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    dist.broadcast(length, 0)
    buf = torch.zeros(int(length.item()), dtype=torch.uint8, device=dev)
    if rank() == 0:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    dist.broadcast(buf, 0)
    return json.loads(bytes(buf.cpu().numpy()).decode())


def shard_batch(batch: Dict[str, np.ndarray], n: int,
                index: int) -> Dict[str, np.ndarray]:
    """Rows of slice `index` of n of a host batch: the leading axis padded
    to a multiple of n, then cut into n contiguous slices in row order, as
    P('data') places them on the JAX mesh. Keys starting with 'targets'
    pad with -100 (the CE ignore index), all others with 0, so padding rows
    add nothing to the masked losses (mr_mt3_tpu/parallel/mesh.py:130-170).
    """
    if not 0 <= index < n:
        raise ValueError(f'slice {index} of {n}')
    out = {}
    for key, value in batch.items():
        value = np.asarray(value)
        b = value.shape[0]
        if b % n:
            pad = n - b % n
            fill = -100 if key.startswith('targets') else 0
            value = np.concatenate([value, np.full(
                (pad,) + value.shape[1:], fill, dtype=value.dtype)])
        rows = value.shape[0] // n
        out[key] = value[index * rows:(index + 1) * rows]
    return out
