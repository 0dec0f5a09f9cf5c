"""The index-sharded paths on ``torch.distributed`` (counterpart of
``parallel/``): the process mesh (``mesh.py``), the autograd-aware
collectives (``collectives.py``) and the sharded train, eval, forward and
rollout functions (``sharded.py``, imported from its module: it imports the
training package, which imports ``collectives``); and the halo-exchange
spatial sharding (``halo.py``: the geometry and the partition on the host,
the exchange, ``featurize_halo`` and the halo train, eval and migrating
rollout steps)."""

from cosmology_gnn_simulation_tpu_torch.parallel.mesh import (
    Mesh,
    device_count,
    initialize_distributed,
    make_mesh,
)

__all__ = ["Mesh", "device_count", "initialize_distributed", "make_mesh"]
