"""Analysis utilities and numerical helpers.

Counterpart of ``nbody_streams_tpu/utils``: the analysis toolkit
(profiles, fits, shape, centering, unbinding) is re-exported at this
level, as the reference's ``nbody_streams.utils`` surface is.  ``JaxPPoly``
is the JAX package's name for the piecewise polynomial, kept for its call
sites.
"""
from .devices import device_alive, get_device_info
from .interp import PPoly, hermite_coeffs, pchip_coeffs, spline_coeffs
from . import main
from .main import *  # noqa: F401,F403 (re-export the analysis toolkit)
from .main import __all__ as _main_all

JaxPPoly = PPoly

__all__ = ["PPoly", "JaxPPoly", "spline_coeffs", "hermite_coeffs",
           "pchip_coeffs",
           "get_device_info", "device_alive", "main", *_main_all]
