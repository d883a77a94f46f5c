"""Import-path alias for reference call sites.

The reference keeps its SPH splatting in ``nbody_streams.viz.
sph_kernels`` (reference: viz/sph_kernels.py); here the renderer lives
in :mod:`nbody_streams_tpu_torch.viz.sph` as one splat.  ``render_cpu``
and ``render_gpu`` (reference sph_kernels.py:381,532) run it on the CPU
and on the card (raising without one), with the reference's
positional-``h`` signature.  The reference's CUDA tiling knobs
(``chunk_size``/``sort_by_morton``/``verbose``) are accepted and
ignored.
"""
from .sph import get_smoothing_lengths, render_surface_density

__all__ = ["get_smoothing_lengths", "render_surface_density",
           "render_cpu", "render_gpu"]


def render_cpu(x, y, mass, h, resolution: int = 512,
               gridsize: float = 200.0, sort_by_morton: bool = False,
               verbose: bool = False):
    """Drop-in for the reference ``render_cpu`` (sph_kernels.py:381):
    returns the (resolution, resolution) ``[ix, iy]`` grid over
    [-gridsize/2, gridsize/2]^2, splatted on the CPU."""
    del sort_by_morton, verbose
    return render_surface_density(x, y, mass, h=h, resolution=resolution,
                                  gridsize=gridsize, arch="cpu")[0]


def render_gpu(x, y, mass, h, resolution: int = 512,
               gridsize: float = 200.0, chunk_size: int = 5_000_000,
               sort_by_morton: bool = False, verbose: bool = False):
    """Drop-in for the reference ``render_gpu`` (sph_kernels.py:532):
    the same splat as :func:`render_cpu`, on the card."""
    del chunk_size, sort_by_morton, verbose
    return render_surface_density(x, y, mass, h=h, resolution=resolution,
                                  gridsize=gridsize, arch="gpu")[0]
