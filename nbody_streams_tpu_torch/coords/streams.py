"""Stream-aligned coordinate frames (reference: coords/streams.py).

(phi1, phi2) great-circle frames defined by the progenitor's angular
momentum: z-hat along L, x-hat toward the progenitor, phi1 along the
stream and phi2 the perpendicular offset; optional optimizer rotation to
minimise the phi2 spread; full observable sets (distance, proper
motions, v_los) for a given observer.
"""
from __future__ import annotations

import warnings

import numpy as np

from .transforms import convert_to_vel_los

__all__ = [
    "generate_stream_coords",
    "to_stream_coords",
    "get_observed_stream_coords",
]


def _stream_rotation(xv_prog):
    """(3, 3) rotation with rows (x-hat, y-hat, z-hat): z along L,
    x toward the progenitor."""
    pos = np.asarray(xv_prog[:3], float)
    vel = np.asarray(xv_prog[3:6], float)
    ang = np.cross(pos, vel)
    zhat = ang / (np.linalg.norm(ang) + 1e-300)
    xhat = pos / (np.linalg.norm(pos) + 1e-300)
    xhat = xhat - zhat * np.dot(xhat, zhat)
    xhat /= np.linalg.norm(xhat) + 1e-300
    yhat = np.cross(zhat, xhat)
    return np.stack([xhat, yhat, zhat])


def _angles(pos, rot, degrees):
    proj = pos @ rot.T
    phi1 = np.arctan2(proj[:, 1], proj[:, 0])
    phi2 = np.arcsin(np.clip(
        proj[:, 2] / (np.linalg.norm(proj, axis=1) + 1e-300), -1, 1))
    if degrees:
        phi1, phi2 = np.rad2deg(phi1), np.rad2deg(phi2)
    return phi1, phi2


def generate_stream_coords(xv, xv_prog=None, return_rotation: bool = False,
                           degrees: bool = True,
                           optimizer_fit: bool = False,
                           fit_kwargs: dict | None = None):
    """(phi1, phi2)[, R] for one stream or a stack of streams.

    xv: (N, 6) or (S, N, 6); xv_prog: (6,) / (S, 6) / None (auto: the
    particle nearest the median position).
    """
    xv = np.asarray(xv, float)
    single = xv.ndim == 2
    if single:
        xv = xv[None]
    if xv.ndim != 3 or xv.shape[-1] != 6:
        raise ValueError(f"xv must be (N, 6) or (S, N, 6), got {xv.shape}")
    n_streams = xv.shape[0]

    if xv_prog is None or np.size(xv_prog) == 0:
        # NaN rows (spray particles not yet released at this snapshot)
        # must not poison the auto progenitor: nanmedian + NaN -> inf
        # distances keeps the selection on the released particles
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            # an all-NaN stream raises a clear ValueError below; numpy's
            # per-slice RuntimeWarning would leak to the caller first
            warnings.simplefilter("ignore", RuntimeWarning)
            med = np.nanmedian(xv[:, :, :3], axis=1)
            d = np.linalg.norm(xv[:, :, :3] - med[:, None, :], axis=2)
        if np.isnan(med).any():
            raise ValueError(
                "cannot auto-select a progenitor: a stream has no "
                "finite particle rows; pass xv_prog=")
        idx = np.argmin(np.where(np.isnan(d), np.inf, d), axis=1)
        progs = xv[np.arange(n_streams), idx]
    else:
        progs = np.atleast_2d(np.asarray(xv_prog, float))
        if progs.shape[0] == 1 and n_streams > 1:
            progs = np.repeat(progs, n_streams, axis=0)
        if progs.shape != (n_streams, 6):
            raise ValueError(
                f"xv_prog shape {np.shape(xv_prog)} does not match "
                f"{n_streams} stream(s): expected (6,) or "
                f"({n_streams}, 6) — a misaligned progenitor array "
                "would silently pair the wrong progenitor with a stream")

    phi1s, phi2s, rots = [], [], []
    for s in range(n_streams):
        rot = _stream_rotation(progs[s])
        if optimizer_fit:
            from scipy.optimize import minimize_scalar

            pos = xv[s, :, :3]

            def spread(alpha):
                c, si = np.cos(alpha), np.sin(alpha)
                # rotate about x-hat in the (y, z) plane
                r2 = np.array([[1, 0, 0], [0, c, -si], [0, si, c]]) @ rot
                _, p2 = _angles(pos, r2, False)
                return np.std(p2)

            res = minimize_scalar(spread, bounds=(-np.pi / 4, np.pi / 4),
                                  method="bounded",
                                  **(fit_kwargs or {}))
            c, si = np.cos(res.x), np.sin(res.x)
            rot = np.array([[1, 0, 0], [0, c, -si], [0, si, c]]) @ rot
        p1, p2 = _angles(xv[s, :, :3], rot, degrees)
        phi1s.append(p1)
        phi2s.append(p2)
        rots.append(rot)

    phi1 = np.array(phi1s)
    phi2 = np.array(phi2s)
    # public convention matches the reference (coords/streams.py:42):
    # COLUMNS of the returned matrices are the basis vectors
    # [xhat, yhat, zhat]; internally _angles uses rows
    rots = np.array(rots).swapaxes(-1, -2)
    if single:
        phi1, phi2, rots = phi1[0], phi2[0], rots[0]
    if return_rotation:
        return phi1, phi2, rots
    return phi1, phi2


# 1 km/s per kpc expressed as an angular rate in mas/yr (inverse of the
# usual k = 4.740470446 km/s per mas/yr/kpc)
_KMS_PER_KPC_TO_MAS_YR = 1.0 / 4.740470446


def to_stream_coords(xv, R=None, degrees: bool = True,
                     return_proper_motions: bool = False,
                     mas_yr: bool = True, *, rotation=None):
    """Project positions / phase-space rows into a pre-computed stream
    frame (reference contract, reference coords/streams.py:197-338).

    xv: (..., 3) positions or (..., 6) phase space (any leading batch
    dims); R: (3, 3) frame (columns = basis vectors) or (S, 3, 3)
    per-batch frames.  Returns ``(phi1, phi2)`` — plus
    ``(mu_phi1*cos(phi2), mu_phi2)`` when ``return_proper_motions=True``
    (requires 6-column input; ``mas_yr`` converts from km/s/kpc using
    the galactocentric radius).  ``rotation=`` is the pre-round-4 native
    keyword alias for ``R``.
    """
    if rotation is not None:
        if R is not None:
            raise TypeError("pass either R or rotation, not both")
        R = rotation
    if R is None:
        raise TypeError("to_stream_coords needs the frame matrix R")
    xv = np.asarray(xv, float)
    R = np.asarray(R, float)
    single = xv.ndim == 1
    if single:
        xv = xv[None]
    lead = xv.shape[:-1]
    if xv.shape[-1] not in (3, 6):
        raise ValueError(f"xv must be (..., 3) or (..., 6), got "
                         f"{xv.shape}")
    if return_proper_motions and xv.shape[-1] != 6:
        raise ValueError("return_proper_motions=True requires "
                         "6-column phase-space input")
    if R.ndim == 3:
        if len(lead) < 1 or R.shape[0] != lead[0]:
            raise ValueError(
                f"per-batch R (S, 3, 3) needs S == xv.shape[0]: "
                f"{R.shape[0]} vs {lead}")
        # columns of R are basis vectors: components = xv @ R per batch
        proj_p = np.einsum("s...i,sij->s...j", xv[..., :3], R)
        proj_v = (np.einsum("s...i,sij->s...j", xv[..., 3:6], R)
                  if xv.shape[-1] == 6 else None)
    else:
        proj_p = xv[..., :3] @ R
        proj_v = xv[..., 3:6] @ R if xv.shape[-1] == 6 else None

    x, y, z = proj_p[..., 0], proj_p[..., 1], proj_p[..., 2]
    rxy = np.hypot(x, y)
    phi1 = np.arctan2(y, x)
    phi2 = np.arctan2(z, rxy)
    if degrees:
        phi1, phi2 = np.rad2deg(phi1), np.rad2deg(phi2)
    if not return_proper_motions:
        if single:
            return phi1[0], phi2[0]
        return phi1, phi2

    vx, vy, vz = proj_v[..., 0], proj_v[..., 1], proj_v[..., 2]
    r2 = x**2 + y**2 + z**2
    r = np.sqrt(r2)
    safe_rxy = np.maximum(rxy, 1e-300)
    dphi1 = (x * vy - y * vx) / np.maximum(rxy**2, 1e-300)   # rad / time
    dphi2 = (vz * rxy - z * (x * vx + y * vy) / safe_rxy) \
        / np.maximum(r2, 1e-300)
    cosphi2 = safe_rxy / np.maximum(r, 1e-300)
    mu1 = dphi1 * cosphi2
    mu2 = dphi2
    if mas_yr:
        mu1 = mu1 * _KMS_PER_KPC_TO_MAS_YR
        mu2 = mu2 * _KMS_PER_KPC_TO_MAS_YR
    if single:
        return phi1[0], phi2[0], mu1[0], mu2[0]
    return phi1, phi2, mu1, mu2


# ICRS direction of the Galactic centre and the frame roll that puts
# the Galactic plane in the x-y plane (the standard Galactocentric
# frame definition used by the reference's Agama/astropy transform)
_GALCEN_RA_DEG = 266.4051
_GALCEN_DEC_DEG = -28.936175
_ROLL0_DEG = 58.5986320306


def _rot_frame(angle_rad, axis):
    """Passive (frame) rotation matrix about x/y/z."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
    if axis == "y":
        return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])


def _galactocentric_matrices(galcen_distance, z_sun):
    """(A, t) such that x_gal = A @ x_icrs + t for heliocentric ICRS
    cartesian x_icrs (standard Galactocentric construction: rotate the
    ICRS frame onto the GC direction, roll the Galactic plane flat,
    tilt by asin(z_sun/d), shift the origin to the Galactic centre)."""
    R = (_rot_frame(np.deg2rad(_ROLL0_DEG), "x")
         @ _rot_frame(np.deg2rad(-_GALCEN_DEC_DEG), "y")
         @ _rot_frame(np.deg2rad(_GALCEN_RA_DEG), "z"))
    H = _rot_frame(-np.arcsin(z_sun / galcen_distance), "y")
    A = H @ R
    t = -(H @ np.array([galcen_distance, 0.0, 0.0]))
    return A, t


def _observed_reference_form(xv, xv_prog, degrees, optimizer_fit,
                             fit_kwargs, galcen_distance, galcen_v_sun,
                             z_sun):
    """Reference contract (reference coords/streams.py:341-430):
    ``(ra, dec, v_los, phi1, phi2)`` from galactocentric phase space via
    a native Galactocentric -> ICRS transform (no Agama/astropy)."""
    xv = np.asarray(xv, float)
    phi1, phi2 = generate_stream_coords(
        xv, xv_prog, degrees=degrees, optimizer_fit=optimizer_fit,
        fit_kwargs=fit_kwargs)
    A, t = _galactocentric_matrices(float(galcen_distance), float(z_sun))
    v_sun = np.asarray(galcen_v_sun, float)
    # x_gal = A x_icrs + t  =>  x_icrs = A^T (x_gal - t)
    p_icrs = (xv[..., :3] - t) @ A
    v_icrs = (xv[..., 3:6] - v_sun) @ A
    r = np.linalg.norm(p_icrs, axis=-1)
    ra = np.mod(np.arctan2(p_icrs[..., 1], p_icrs[..., 0]), 2 * np.pi)
    dec = np.arcsin(np.clip(p_icrs[..., 2] / np.maximum(r, 1e-300),
                            -1.0, 1.0))
    v_los = np.sum(p_icrs * v_icrs, axis=-1) / np.maximum(r, 1e-300)
    if degrees:
        ra, dec = np.rad2deg(ra), np.rad2deg(dec)
    return ra, dec, v_los, phi1, phi2


def get_observed_stream_coords(xv, xv_prog=None, observer=None,
                               degrees: bool = True, **ref_kw):
    """Full observable set for a stream in galactocentric coordinates.

    Returns dict with phi1, phi2, dist (from observer), v_los, pm_phi1,
    pm_phi2 (angular velocities along the frame axes, in the same angle
    unit as phi1/phi2 per code time unit: deg/time when ``degrees=True``,
    rad/time = km/s/kpc otherwise).  Default observer at the galactic
    centre.

    phi1/phi2 are GALACTOCENTRIC stream-frame angles (reference
    semantics, coords/streams.py:341), and pm_phi1/pm_phi2 are the time
    derivatives of those same angles — the observer affects only
    ``dist`` and ``v_los``.

    The reference call form (any of ``galcen_distance=``/
    ``galcen_v_sun=``/``z_sun=``/``optimizer_fit=``/``fit_kwargs=``
    present) instead returns the reference 5-tuple ``(ra, dec, v_los,
    phi1, phi2)`` with RA/Dec from a native Galactocentric -> ICRS
    transform; it also accepts stacked streams (S, N, 6).
    """
    ref_keys = {"galcen_distance", "galcen_v_sun", "z_sun",
                "optimizer_fit", "fit_kwargs"}
    if ref_kw:
        unknown = set(ref_kw) - ref_keys
        if unknown:
            raise TypeError(f"unexpected kwargs: {sorted(unknown)}")
        if observer is not None:
            raise TypeError("observer= belongs to the native dict form; "
                            "the reference form locates the Sun from "
                            "galcen_distance/z_sun")
        return _observed_reference_form(
            xv, xv_prog, degrees,
            ref_kw.get("optimizer_fit", False),
            ref_kw.get("fit_kwargs"),
            ref_kw.get("galcen_distance", 8.122),
            ref_kw.get("galcen_v_sun", (12.9, 245.6, 7.78)),
            ref_kw.get("z_sun", 0.0208))
    xv = np.asarray(xv, float)
    if xv.ndim != 2 or xv.shape[-1] != 6:
        raise ValueError(
            f"get_observed_stream_coords takes one stream (N, 6), got "
            f"{xv.shape}; loop over streams (or use "
            "generate_stream_coords for stacked frames)")
    phi1, phi2, rot = generate_stream_coords(xv, xv_prog,
                                             return_rotation=True,
                                             degrees=degrees)
    obs = np.zeros(6) if observer is None else np.asarray(observer, float)
    rel_p = xv[:, :3] - obs[:3]
    dist = np.linalg.norm(rel_p, axis=1)
    v_los = convert_to_vel_los(xv[:, :3], xv[:, 3:6], observer=obs)

    # angular velocities of (phi1, phi2): galactocentric, so that
    # pm_phi1 == d(phi1)/dt for the angles returned above (rot columns
    # are the basis vectors -> components = xv @ rot)
    proj_p = xv[:, :3] @ rot
    proj_v = xv[:, 3:6] @ rot
    rxy = np.hypot(proj_p[:, 0], proj_p[:, 1]) + 1e-300
    dphi1 = (proj_p[:, 0] * proj_v[:, 1] - proj_p[:, 1] * proj_v[:, 0]) \
        / rxy**2
    r3 = np.linalg.norm(proj_p, axis=1) + 1e-300
    dphi2 = (proj_v[:, 2] * rxy - proj_p[:, 2]
             * (proj_p[:, 0] * proj_v[:, 0] + proj_p[:, 1] * proj_v[:, 1])
             / rxy) / r3**2
    if degrees:
        # keep pm_phi1 == d(phi1)/dt for the angles returned above
        dphi1 = np.rad2deg(dphi1)
        dphi2 = np.rad2deg(dphi2)
    return {
        "phi1": phi1,
        "phi2": phi2,
        "dist": dist,
        "v_los": v_los,
        "pm_phi1": dphi1,
        "pm_phi2": dphi2,
        "rotation": rot,
    }
