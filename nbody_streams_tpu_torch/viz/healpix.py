"""Native HEALPix ring-scheme pixelisation (no healpy dependency).

The reference's ``plot_mollweide`` requires healpy for its HEALPix sky
maps (reference: viz/plots.py:433-520).  healpy is not a dependency of
this package; this module implements the two primitives the renderer
needs — ``ang2pix_ring`` and ``pix2ang_ring`` — as vectorised NumPy,
following the standard HEALPix equations (Gorski et al. 2005, ApJ 622, 759).

Conventions match healpy: theta = colatitude in [0, pi], phi = longitude
in [0, 2 pi), npix = 12 nside^2, equal-area pixels.
"""
from __future__ import annotations

import numpy as np

__all__ = ["nside2npix", "ang2pix_ring", "pix2ang_ring", "vec2pix_ring",
           "healpix_map"]


def nside2npix(nside: int) -> int:
    return 12 * int(nside) ** 2


def ang2pix_ring(nside: int, theta, phi):
    """Ring-scheme pixel index of (theta, phi); vectorised."""
    nside = int(nside)
    theta = np.asarray(theta, float)
    phi = np.asarray(phi, float)
    z = np.cos(theta)
    tt = np.mod(phi, 2.0 * np.pi) / (0.5 * np.pi)        # in [0, 4)
    # healpy broadcasts mixed scalar/array theta, phi — match that
    z, tt = np.broadcast_arrays(z, tt)
    za = np.abs(z)

    ipix = np.empty(z.shape, dtype=np.int64)
    eq = za <= 2.0 / 3.0

    # --- equatorial belt
    temp1 = nside * (0.5 + tt[eq])
    temp2 = nside * 0.75 * z[eq]
    jp = np.floor(temp1 - temp2).astype(np.int64)   # ascending-edge line
    jm = np.floor(temp1 + temp2).astype(np.int64)   # descending-edge line
    ir = nside + 1 + jp - jm                        # ring counted from z=2/3
    kshift = 1 - (ir & 1)
    ip = ((jp + jm - nside + kshift + 1) // 2) % (4 * nside)
    ncap = 2 * nside * (nside - 1)
    ipix[eq] = ncap + (ir - 1) * 4 * nside + ip

    # --- polar caps
    po = ~eq
    tp = tt[po] - np.floor(tt[po])
    tmp = nside * np.sqrt(3.0 * (1.0 - za[po]))
    jp = np.floor(tp * tmp).astype(np.int64)
    jm = np.floor((1.0 - tp) * tmp).astype(np.int64)
    ir = jp + jm + 1                                # ring from the pole
    ip = np.floor(tt[po] * ir).astype(np.int64) % (4 * ir)
    north = z[po] > 0
    vals = np.where(north, 2 * ir * (ir - 1) + ip,
                    nside2npix(nside) - 2 * ir * (ir + 1) + ip)
    ipix[po] = vals
    return ipix


def vec2pix_ring(nside: int, pos):
    """Pixel index of cartesian direction vectors (N, 3).

    Zero-length vectors have no direction: raise like healpy does —
    silently mapping them to (theta=pi/2, phi=0) would deposit their
    full weight as a spurious hot spot in the lon=0/lat=0 pixel (e.g. a
    progenitor at the origin of progenitor-centred coordinates)."""
    pos = np.asarray(pos, float)
    r = np.linalg.norm(pos, axis=-1)
    if not np.all(r > 0):
        raise ValueError(
            f"{int((~(r > 0)).sum())} zero-length (or NaN) vector(s) "
            "have no sky direction; filter them out before mapping")
    theta = np.arccos(np.clip(pos[..., 2] / r, -1.0, 1.0))
    phi = np.arctan2(pos[..., 1], pos[..., 0])
    return ang2pix_ring(nside, theta, phi)


def pix2ang_ring(nside: int, ipix):
    """(theta, phi) of ring-scheme pixel centres; vectorised."""
    nside = int(nside)
    ipix = np.asarray(ipix, dtype=np.int64)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)
    theta = np.empty(ipix.shape, float)
    phi = np.empty(ipix.shape, float)

    # --- north polar cap
    north = ipix < ncap
    ip = ipix[north] + 1
    hip = ip * 0.5
    iring = np.floor(np.sqrt(hip - np.sqrt(np.floor(hip)))).astype(
        np.int64) + 1
    iphi = ip - 2 * iring * (iring - 1)
    theta[north] = np.arccos(1.0 - iring**2 / (3.0 * nside**2))
    phi[north] = (iphi - 0.5) * np.pi / (2.0 * iring)

    # --- equatorial belt
    eq = (ipix >= ncap) & (ipix < npix - ncap)
    ip = ipix[eq] - ncap
    iring = ip // (4 * nside) + nside
    iphi = ip % (4 * nside) + 1
    fodd = 0.5 * (1 + ((iring + nside) & 1))
    theta[eq] = np.arccos((2.0 * nside - iring) * 2.0 / (3.0 * nside))
    phi[eq] = (iphi - fodd) * np.pi / (2.0 * nside)

    # --- south polar cap
    south = ipix >= npix - ncap
    ip = npix - ipix[south]
    hip = ip * 0.5
    iring = np.floor(np.sqrt(hip - np.sqrt(np.floor(hip)))).astype(
        np.int64) + 1
    iphi = 4 * iring + 1 - (ip - 2 * iring * (iring - 1))
    theta[south] = np.arccos(-1.0 + iring**2 / (3.0 * nside**2))
    phi[south] = (iphi - 0.5) * np.pi / (2.0 * iring)
    return theta, np.mod(phi, 2.0 * np.pi)


def healpix_map(nside: int, pos, weights=None):
    """Accumulate particle (weights) into a ring-ordered HEALPix map."""
    pix = vec2pix_ring(nside, pos)
    return np.bincount(pix, weights=weights, minlength=nside2npix(nside))
