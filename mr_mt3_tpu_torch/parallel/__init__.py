"""The device mesh: the data axis (per-card replicas, process groups of
one rank per card) and the model axis (grids of ranks holding shards of
one model, parallel/tensor.py)."""

from mr_mt3_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    all_reduce_sum,
    backend_for,
    barrier,
    broadcast_object,
    data_devices,
    device_cap,
    grid_data,
    init_multihost,
    local_mesh,
    local_rank,
    local_world,
    make_mesh,
    node_count,
    node_rank,
    param_shardings,
    rank,
    rank_device,
    rank_devices,
    shard_batch,
    shutdown,
    visible_devices,
    world,
)
