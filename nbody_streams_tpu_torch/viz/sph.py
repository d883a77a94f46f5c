"""SPH surface-density rendering on the card, scatter-add formulation.

The port of ``nbody_streams_tpu.viz.sph`` (reference: viz/sph_kernels.py
:118-775, Numba-CUDA atomic scatter / Numba-prange gather).  Each particle
deposits a 2-D cubic-spline kernel footprint onto a fixed (2K+1)^2 pixel
stencil.  The JAX package loops over the stencil's offsets inside one
jitted function; eager, that loop would be ~20 launches an offset, so
here a chunk of particles takes all offsets at once as a (chunk,
(2K+1)^2) broadcast and deposits them with one flattened ``index_add_``.
On the card that add is atomic, so the order of the sums (and the last
bits of a pixel) may differ from the JAX package's and between runs.

Smoothing lengths come from kNN distances: the native C++ host library
(``nbody_streams_tpu_torch.native``: Morton pre-sort + grid-hash kNN) at
N >= 500,000 under ``method='auto'``, else SciPy's cKDTree.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device

__all__ = [
    "get_smoothing_lengths",
    "render_surface_density",
    "sph_kernel_2d",
]

# particles a deposit chunk: (chunk, 81) temporaries of ~85 MB each in
# float32 at the default stencil, so a few hundred MB at any N
SPLAT_CHUNK = 262_144
NATIVE_MIN_N = 500_000


def get_smoothing_lengths(pos, n_neighbors: int = 32,
                          method: str = "auto", *, k_neighbors=None,
                          safety_factor=None, gpu_vram_threshold_gb=None,
                          verbose: bool = False):
    """Per-particle smoothing length = distance to the n-th neighbour.

    method: 'auto' (the native library at N >= 500,000, cKDTree below) |
    'native' (C++ grid-hash kNN; raises if the library cannot be built) |
    'ckdtree'.

    Reference compatibility (viz/sph_kernels.py:118): ``k_neighbors``
    counts the particle itself (h = distance to the (k-1)-th *other*
    particle) and maps to ``n_neighbors = k_neighbors - 1``;
    ``safety_factor`` / ``gpu_vram_threshold_gb`` / ``verbose`` are
    VRAM-budget knobs of the reference's CUDA kNN — accepted and ignored.
    """
    if k_neighbors is not None:
        n_neighbors = int(k_neighbors) - 1
    del safety_factor, gpu_vram_threshold_gb, verbose
    pos = np.asarray(pos, float)
    if method not in ("auto", "native", "ckdtree"):
        raise ValueError(f"unknown kNN method {method!r}")
    if method == "native" or (method == "auto"
                              and len(pos) >= NATIVE_MIN_N):
        from .. import native

        if pos.shape[1] == 2:
            # the C kernels read (N, 3) buffers; a zero z column keeps
            # the 2-D distances exact
            pos = np.column_stack([pos, np.zeros(len(pos))])
        order = native.morton_argsort(pos)   # locality for the grid hash
        h = np.empty(len(pos))
        h[order] = native.knn_radius(pos[order], k=n_neighbors)
        return h
    if len(pos) <= 1:
        # a lone particle has no neighbours: cKDTree.query(k=1) returns
        # a 1-D array and d[:, -1] would IndexError
        return np.zeros(len(pos))
    from scipy.spatial import cKDTree

    d, _ = cKDTree(pos).query(pos, k=min(n_neighbors + 1, len(pos)))
    return d[:, -1]


def sph_kernel_2d(q):
    """2-D cubic-spline kernel W(q), normalised: integral over the plane
    of W(r/h)/h^2 d^2r = 1 (sigma_2D = 10/(7 pi))."""
    sigma = 10.0 / (7.0 * math.pi)
    q = torch.as_tensor(q)
    q2 = q * q
    w = torch.where(
        q < 1.0,
        1.0 - 1.5 * q2 + 0.75 * (q2 * q),
        torch.where(q < 2.0, 0.25 * (2.0 - q) ** 3, 0.0),
    )
    return sigma * w


def _splat(x, y, m, h, x0, y0, dx_pix, dy_pix, nx, ny, stencil,
           acc_dtype=torch.float64):
    """Scatter-add cubic-spline footprints onto an (nx, ny) grid of mass
    per pixel (pixels may be rectangular: dx_pix and dy_pix are
    independent).  x, y, m, h: (N,) float32 tensors on one device; x0, y0,
    dx_pix, dy_pix: 0-d float32 tensors there.

    The grid accumulates in ``acc_dtype`` (float64) and is cast to the
    points' dtype at the end: where many particles share a pixel, a
    float32 sum drops the low bits of each deposit (the JAX package's
    splat, which accumulates in the points' dtype, lost 3.5e-5 of 349,525
    stars' mass in a 384^2 frame; a port deviation, ROADMAP Queue 3)."""
    dev, dt = x.device, x.dtype
    grid = torch.zeros(nx * ny, dtype=acc_dtype, device=dev)
    half = stencil // 2
    span = torch.arange(-half, half + 1, dtype=torch.int32, device=dev)
    # the offsets in the JAX package's loop order (a outer, b inner)
    off_a = span.repeat_interleave(stencil)
    off_b = span.repeat(stencil)
    # clamp h: support must reach past the nearest pixel centre (up to
    # half the pixel diagonal away, else wsum == 0 and the particle
    # vanishes) and fit inside the stencil on the finer axis
    p_min = torch.minimum(dx_pix, dy_pix)
    h_lo = torch.sqrt(dx_pix**2 + dy_pix**2)
    h_hi = torch.maximum((stencil / 2.0) * p_min, h_lo)
    for s in range(0, x.shape[0], SPLAT_CHUNK):
        sl = slice(s, s + SPLAT_CHUNK)
        # particle cell coordinates (fractional)
        fx = ((x[sl] - x0) / dx_pix)[:, None]
        fy = ((y[sl] - y0) / dy_pix)[:, None]
        px = torch.floor(fx).to(torch.int32) + off_a
        py = torch.floor(fy).to(torch.int32) + off_b
        h_w = torch.clamp(h[sl], h_lo, h_hi)[:, None]
        r = torch.sqrt(((px + 0.5 - fx) * dx_pix) ** 2
                       + ((py + 0.5 - fy) * dy_pix) ** 2)
        w = sph_kernel_2d(r / (0.5 * h_w))
        # per-particle normalisation, so each particle deposits exactly
        # its mass (discrete kernel sums != 1 for small h)
        wsum = w.sum(1, keepdim=True)
        wnorm = torch.where(wsum > 0, 1.0 / wsum, 0.0)
        valid = (px >= 0) & (px < nx) & (py >= 0) & (py < ny)
        contrib = torch.where(valid, m[sl, None] * w * wnorm, 0.0)
        flat = (px.clamp(0, nx - 1).long() * ny
                + py.clamp(0, ny - 1).long())
        grid.index_add_(0, flat.reshape(-1),
                        contrib.reshape(-1).to(acc_dtype))
    return grid.to(dt).view(nx, ny)


_REF_RENDER_KWARGS = frozenset((
    "h", "resolution", "gridsize", "chunk_size", "k_neighbors",
    "sort_by_morton", "verbose"))


def _arch_device(arch: str) -> torch.device:
    """'auto' and 'gpu' are the card (raising without one), 'cpu' the
    CPU: the rule of ``run_simulation(architecture=)``."""
    if arch not in ("auto", "gpu", "cpu"):
        raise ValueError(f"arch must be 'auto', 'gpu' or 'cpu', got "
                         f"{arch!r}")
    return resolve_device("cpu" if arch == "cpu" else "cuda")


def render_surface_density(pos, mass, extent=None, npix: int = 256,
                           axes=(0, 1), smoothing=None,
                           n_neighbors: int = 32, stencil: int = 9,
                           arch: str = "auto", **compat):
    """Projected surface density map [Msun/kpc^2].

    Native form: ``render_surface_density(pos (N,3), mass, extent=,
    npix=, ...)`` -> (image (npix, npix) with rows along y for
    ``imshow(origin='lower')``, extent 4-tuple).

    The reference call form (viz/sph_kernels.py:638) is also accepted:
    ``render_surface_density(x, y, mass, h=None, resolution=512,
    gridsize=200.0, ...)`` — detected by a 1-D first argument — and
    returns the reference contract: grid shape (resolution, resolution)
    with rows along **x** (the reference's ``grid[i, j]`` layout,
    sph_kernels.py:378) over ``[-gridsize/2, gridsize/2]`` bounds.
    ``chunk_size``/``sort_by_morton``/``verbose`` are the reference's
    CUDA tiling knobs — accepted and ignored.  ``k_neighbors`` counts the
    particle itself (maps to ``n_neighbors - 1``).

    ``arch``: 'auto' and 'gpu' splat on the card (each raises without
    one), 'cpu' on the CPU.
    """
    unknown = set(compat) - _REF_RENDER_KWARGS
    if unknown:
        raise TypeError(f"unexpected kwargs: {sorted(unknown)}")
    pos = np.asarray(pos, float)
    if pos.ndim == 1:
        # reference positional form: (x, y, mass, ...)
        x, y = pos, np.asarray(mass, float)
        if extent is None:
            raise TypeError(
                "reference call form render_surface_density(x, y, mass, "
                "...) requires the mass array as the third argument")
        m = np.asarray(extent, float)
        if not (x.shape == y.shape == m.shape):
            raise ValueError(
                f"x, y, mass must have the same length; got {x.shape}, "
                f"{y.shape}, {m.shape}")
        gridsize = float(compat.get("gridsize", 200.0))
        half = gridsize / 2.0
        img, bounds = _render_native(
            np.column_stack([x, y]), m,
            extent=(-half, half, -half, half),
            npix=int(compat.get("resolution", 512)), axes=(0, 1),
            smoothing=compat.get("h"),
            n_neighbors=int(compat.get("k_neighbors", 32)) - 1,
            stencil=stencil, arch=arch)
        return img.T, bounds          # back to the reference [ix, iy]
    if compat:
        if "resolution" in compat:
            npix = int(compat["resolution"])
        if "gridsize" in compat:
            half = float(compat["gridsize"]) / 2.0
            extent = (-half, half, -half, half)
        if compat.get("h") is not None:
            smoothing = compat["h"]
        if "k_neighbors" in compat:
            n_neighbors = int(compat["k_neighbors"]) - 1
    return _render_native(pos, mass, extent, npix, axes, smoothing,
                          n_neighbors, stencil, arch)


def _render_native(pos, mass, extent=None, npix: int = 256,
                   axes=(0, 1), smoothing=None,
                   n_neighbors: int = 32, stencil: int = 9,
                   arch: str = "auto"):
    dev = _arch_device(arch)
    pos = np.asarray(pos, float)
    n = pos.shape[0]
    mass = np.broadcast_to(np.asarray(mass, float), (n,))
    i, j = axes
    x = pos[:, i]
    y = pos[:, j]
    if extent is None:
        lim = np.percentile(np.abs(np.concatenate([x, y])), 99.0) * 1.2
        if not np.isfinite(lim) or lim <= 0:
            raise ValueError(
                "cannot auto-size the map: the 99th percentile of the "
                f"projected coordinates is {lim!r} (degenerate or "
                "non-finite positions); pass extent= explicitly")
        extent = (-lim, lim, -lim, lim)
    x0, x1, y0, y1 = extent
    dx_pix = (x1 - x0) / npix
    dy_pix = (y1 - y0) / npix
    if dx_pix <= 0 or dy_pix <= 0:
        raise ValueError(f"empty extent {extent}: x1 > x0 and y1 > y0 "
                         "required")
    if smoothing is None:
        smoothing = get_smoothing_lengths(pos[:, [i, j]],
                                          n_neighbors=n_neighbors)
    smoothing = np.broadcast_to(np.asarray(smoothing, float), (n,))

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    img = _splat(f32(x), f32(y), f32(mass), f32(smoothing), f32(x0),
                 f32(y0), f32(dx_pix), f32(dy_pix), npix, npix, stencil)
    # mass per pixel -> surface density
    return img.cpu().numpy().T / (dx_pix * dy_pix), extent
