"""The data-parallel axis: meshes of per-card replicas and process groups
of one rank per card."""

from mr_mt3_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    backend_for,
    barrier,
    broadcast_object,
    data_devices,
    device_cap,
    init_multihost,
    local_mesh,
    local_rank,
    local_world,
    make_mesh,
    node_count,
    node_rank,
    rank,
    rank_device,
    shard_batch,
    shutdown,
    visible_devices,
    world,
)
