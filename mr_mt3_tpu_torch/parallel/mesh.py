"""The data-parallel axis (port of mr_mt3_tpu/parallel/mesh.py).

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
then sharing the device. The model axis (tensor parallelism:
_PARAM_RULES, mr_mt3_tpu/parallel/mesh.py:96-127) is not ported and
raises.

The collectives here are all_reduce, broadcast and barrier only, which
both NCCL and gloo serve, on the card and on the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mr_mt3_tpu_torch.utils.device import resolve_device

# every process group's collectives time out: a rank that never arrives
# fails the others instead of hanging them
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

TENSOR_PARALLEL = ('a model axis > 1 (tensor parallelism) is not ported: '
                   'ROADMAP A9, second part')


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis's devices (torch.device, repeats allowed) and the
    model axis's size, which must be 1."""
    devices: Tuple[torch.device, ...]
    model: int = 1

    def __post_init__(self):
        if int(self.model) != 1:
            raise NotImplementedError(TENSOR_PARALLEL)
        if not self.devices:
            raise ValueError('a mesh needs at least one device')
        devices = tuple(resolve_device(d) for d in self.devices)
        for d in devices:
            if d.type == 'cuda' and (d.index or 0) >= \
                    torch.cuda.device_count():
                raise ValueError(f'{d} is not a visible card '
                                 f'({torch.cuda.device_count()} visible)')
        object.__setattr__(self, 'devices', devices)

    @property
    def n_data(self) -> int:
        return len(self.devices)


def visible_devices(kind: str = 'cuda') -> list:
    """Every visible card (kind 'cuda'), or the one CPU device."""
    if torch.device(kind).type == 'cpu':
        return [torch.device('cpu')]
    resolve_device('cuda')
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A Mesh of the first data * model devices; data fills the devices
    (default: every visible card). The errors are the JAX function's."""
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


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of t over every rank (t itself without a group). gloo takes
    card tensors too; NCCL takes only card tensors, so a CPU tensor goes
    through the card there."""
    if not dist.is_initialized():
        return t
    dev = _comm_device()
    if dev.type == 'cuda' and not t.is_cuda:
        out = t.to(dev)
        dist.all_reduce(out)
        return out.to(t.device)
    out = t.clone()
    dist.all_reduce(out)
    return out


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
