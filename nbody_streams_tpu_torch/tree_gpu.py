"""Import-path alias for reference call sites.

Counterpart of ``nbody_streams_tpu/tree_gpu.py``: the reference packages
its Barnes-Hut tier as ``nbody_streams.tree_gpu``; here the compat shims
live in :mod:`nbody_streams_tpu_torch.tree` (the exact direct sum under
the tree API).  This module re-exports the reference-public names so the
package rename is the only change a tree_gpu caller needs.
"""
from .tree import TreeGPU, tree_gravity_gpu, run_nbody_gpu_tree  # noqa: F401
from .utils.devices import device_alive as cuda_alive  # noqa: F401

__all__ = ["TreeGPU", "tree_gravity_gpu", "run_nbody_gpu_tree",
           "cuda_alive"]
