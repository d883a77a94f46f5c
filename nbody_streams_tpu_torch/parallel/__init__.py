"""Multi-device parallelism: the ring of shards and sharded direct summation."""
from .sharded import ShardedDirect, make_particle_mesh, slab_sort_for_sharding

__all__ = ["ShardedDirect", "make_particle_mesh", "slab_sort_for_sharding"]
