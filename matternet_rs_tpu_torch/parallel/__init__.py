"""The device-mesh layer (twin of the reference's ``parallel/``): items
sharded over the slots of a mesh, a body run per slot on its device, and
explicit collectives (all-gather, psum, the ring step). Building is
data-parallel over the item axis (λ needs no communication with the graph
replicated); a search takes each slot's top-k and merges the k·D
candidates; stage-1 clustering reduces only centroid sums and counts.
"""

from matternet_rs_tpu_torch.parallel.clustering import distributed_lloyd
from matternet_rs_tpu_torch.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_items,
    shard_items_from_blocks,
)
from matternet_rs_tpu_torch.parallel.search import (
    make_sharded_energy_search,
    sharded_search_lambda_aware,
    sharded_taumode_lambdas,
)
from matternet_rs_tpu_torch.parallel.sketch import ShardedSketch

__all__ = [
    "ShardedSketch",
    "distributed_lloyd",
    "make_mesh",
    "make_mesh_2d",
    "make_sharded_energy_search",
    "replicate",
    "shard_items",
    "shard_items_from_blocks",
    "sharded_search_lambda_aware",
    "sharded_taumode_lambdas",
]
