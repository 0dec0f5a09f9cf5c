"""The index-sharded paths on ``torch.distributed`` (counterpart of
``parallel/``): the process mesh (``mesh.py``), the autograd-aware
collectives (``collectives.py``) and the sharded train, eval, forward and
rollout functions (``sharded.py``, imported from its module: it imports the
training package, which imports ``collectives``); and the halo
decomposition's host half (``halo.py``, numpy: the geometry, the partition
and one shard's candidate set)."""

from cosmology_gnn_simulation_tpu_torch.parallel.mesh import (
    Mesh,
    device_count,
    initialize_distributed,
    make_mesh,
)

__all__ = ["Mesh", "device_count", "initialize_distributed", "make_mesh"]
