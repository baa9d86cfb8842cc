from ionflux_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_reduce,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_along,
    sharded_map,
)
from ionflux_torch.parallel.multihost import (
    gather_global,
    global_mesh,
    init_multihost,
    run_processes,
    scatter_global,
)

__all__ = [
    "Mesh",
    "all_gather",
    "all_reduce",
    "make_mesh",
    "shard_along",
    "replicate",
    "pad_to_multiple",
    "sharded_map",
    "init_multihost",
    "global_mesh",
    "scatter_global",
    "gather_global",
    "run_processes",
]
