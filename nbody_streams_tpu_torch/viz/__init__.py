"""Visualization: SPH surface density on the card + matplotlib wrappers
(matplotlib is imported only inside the plotting functions)."""
from .sph import (
    get_smoothing_lengths,
    render_surface_density,
    sph_kernel_2d,
)
from .plots import (
    plot_density,
    plot_mollweide,
    plot_stream_sky,
    plot_stream_evolution,
)

__all__ = [
    "get_smoothing_lengths",
    "render_surface_density",
    "sph_kernel_2d",
    "plot_density",
    "plot_mollweide",
    "plot_stream_sky",
    "plot_stream_evolution",
]
