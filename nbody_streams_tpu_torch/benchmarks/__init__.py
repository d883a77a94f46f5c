"""Kernel studies of the port on one CUDA GPU (``tile_sweep``)."""
