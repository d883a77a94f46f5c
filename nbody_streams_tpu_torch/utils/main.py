"""Analysis utilities: profiles, fits, shapes, centering, unbinding.

Counterpart of ``nbody_streams_tpu/utils/main.py``: the same NumPy/SciPy
host-side statistics, and the package's own potential solvers for the
energy-based pieces.  Unbinding's direct self-potential runs the
single-pass potential form of the hand-written CUDA kernel
(``ops.dispatch.DirectGravity.potential``) on the card; its ``'bfe'``
forms fit the port's Multipole.  The unbinding functions take ``device=``
and run on the card unless the caller passes ``device='cpu'`` (there the
kernel's plain version runs); without a card the default raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..constants import G_DEFAULT

__all__ = [
    "make_uneven_grid",
    "empirical_density_profile",
    "empirical_circular_velocity_profile",
    "empirical_velocity_dispersion_profile",
    "empirical_velocity_rms_profile",
    "empirical_velocity_anisotropy_profile",
    "double_power_law_density",
    "fit_double_spheroid_profile",
    "fit_dehnen_profile",
    "fit_plummer_profile",
    "fit_iterative_ellipsoid",
    "uniform_spherical_grid",
    "fibonacci_sphere_grid",
    "find_center",
    "find_center_position",
    "iterative_unbinding",
    "compute_iterative_boundness",
]


# ---------------------------------------------------------------------------
# Grids
# ---------------------------------------------------------------------------

def make_uneven_grid(xmin: float, xmax: float | None = None,
                     nbins: int = 10) -> np.ndarray:
    """Graded 1-D grid: node 0 at 0, node 1 at ``xmin``, last node at
    ``xmax``, spacing growing geometrically (reference contract,
    utils/main.py:107-164).

    ``xmax=None`` returns a uniform grid with spacing ``xmin``; if the
    requested grading is infeasible (``xmax <= (nbins-1)*xmin``) a
    uniform 0..xmax grid is returned.  Shape ``(nbins,)``.
    """
    nbins = int(nbins)
    if nbins < 3:
        raise ValueError("nbins must be at least 3")
    if xmin <= 0:
        raise ValueError("xmin must be positive")
    if xmax is None:
        return np.arange(nbins, dtype=float) * float(xmin)
    if xmax <= xmin:
        raise ValueError("xmax must be greater than xmin")
    n_iv = nbins - 1
    if xmax <= n_iv * xmin:
        return np.linspace(0.0, xmax, nbins)

    # Nodes x_k = xmax (q^k - 1)/(q^n - 1) for a growth ratio q > 1
    # fixed by x_1 = xmin.  Solve for q by bisection on
    # g(q) = (q - 1)/(q^n - 1) - xmin/xmax, which is strictly
    # decreasing in q on (1, inf).
    target = xmin / xmax

    def g(q):
        return np.expm1(np.log(q)) / np.expm1(n_iv * np.log(q)) - target

    lo, hi = 1.0 + 1e-12, 2.0
    while g(hi) > 0.0:
        hi *= 2.0
        if hi > 1e6:
            raise RuntimeError("failed to bracket the grid growth ratio")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if g(mid) > 0.0:
            lo = mid
        else:
            hi = mid
    q = 0.5 * (lo + hi)
    k = np.arange(nbins)
    return np.expm1(k * np.log(q)) / np.expm1(n_iv * np.log(q)) * xmax


def _sphere_projection(x, y, z, radius, proj):
    if proj == "cart":
        return np.column_stack([x, y, z])
    if proj == "sph":
        polar = np.arccos(np.clip(z / radius, -1.0, 1.0))
        return np.column_stack([np.full(len(x), radius), polar,
                                np.mod(np.arctan2(y, x), 2 * np.pi)])
    if proj == "cyl":
        return np.column_stack([np.hypot(x, y), np.arctan2(y, x), z])
    raise ValueError("proj must be 'cart', 'sph', or 'cyl'")


def uniform_spherical_grid(num_pts: int, radius: float = 1.0,
                           proj: str = "cart", seed: int | None = 42):
    """``(num_pts, 3)`` uniformly random points on a sphere surface
    (reference contract, utils/main.py:1327-1382).  ``proj`` selects the
    returned coordinates: 'cart' (x,y,z) | 'sph' (r,theta,phi) |
    'cyl' (R,phi,z)."""
    if not isinstance(num_pts, (int, np.integer)) or num_pts <= 0:
        raise ValueError("num_pts must be a positive integer")
    if radius <= 0:
        raise ValueError("radius must be positive")
    rng = np.random.default_rng(seed)
    cos_t = rng.uniform(-1.0, 1.0, num_pts)
    sin_t = np.sqrt(1.0 - cos_t**2)
    az = rng.uniform(0.0, 2 * np.pi, num_pts)
    return _sphere_projection(radius * sin_t * np.cos(az),
                              radius * sin_t * np.sin(az),
                              radius * cos_t, radius, proj.lower())


def fibonacci_sphere_grid(num_pts: int = 200, radius: float = 1.0,
                          proj: str = "cart", jittered: bool = False,
                          seed: int | None = 42) -> np.ndarray:
    """``(num_pts, 3)`` near-uniform sphere-surface points via the
    golden-angle spiral (reference contract, utils/main.py:1384-1457);
    ``jittered`` adds stratified polar/azimuthal jitter, ``proj`` as in
    :func:`uniform_spherical_grid`."""
    if not isinstance(num_pts, (int, np.integer)) or num_pts <= 0:
        raise ValueError("num_pts must be a positive integer")
    if radius <= 0:
        raise ValueError("radius must be positive")
    i = np.arange(num_pts) + 0.5
    phi = np.pi * (1.0 + np.sqrt(5.0)) * i
    u = i / num_pts
    if jittered:
        rng = np.random.default_rng(seed)
        u = np.clip((i + rng.uniform(-0.5, 0.5, num_pts)) / num_pts,
                    0.0, 1.0)
        phi = phi + rng.uniform(-np.pi / num_pts, np.pi / num_pts,
                                num_pts)
    cos_t = 1.0 - 2.0 * u
    sin_t = np.sqrt(np.maximum(1.0 - cos_t**2, 0.0))
    return _sphere_projection(radius * sin_t * np.cos(phi),
                              radius * sin_t * np.sin(phi),
                              radius * cos_t, radius, proj.lower())


# ---------------------------------------------------------------------------
# Radial profiles
# ---------------------------------------------------------------------------

def _radial_bins(r, bins, r_min=None, r_max=None):
    if np.isscalar(bins):
        r_min = r_min or max(np.percentile(r, 0.2), 1e-6)
        r_max = r_max or np.percentile(r, 99.5)
        edges = np.geomspace(r_min, r_max, int(bins) + 1)
    else:
        edges = np.asarray(bins, float)
    mids = np.sqrt(edges[:-1] * edges[1:])
    idx = np.digitize(r, edges) - 1
    valid = (idx >= 0) & (idx < len(mids))
    return edges, mids, idx, valid


def _ref_grid_form(center, kw):
    """Detect the reference call form of the profile functions
    (reference utils/main.py:168-448: ``nbins=``/``rmin=``/``rmax=``
    keywords, or an integer in the third positional slot where the
    native form takes ``center``).  Returns the uneven-grid edges
    (0-started, reference :func:`make_uneven_grid`) or None."""
    ref = any(k in kw for k in ("nbins", "rmin", "rmax"))
    nbins = int(kw.pop("nbins", 50))
    if center is not None and np.ndim(center) == 0:
        nbins = int(center)
        ref = True
    if not ref:
        return None
    return make_uneven_grid(kw.pop("rmin", 0.1), kw.pop("rmax", 600.0),
                            nbins=nbins + 1)


def _radii_of(pos, center):
    """Radii from positions (N, 3) or pre-computed radii (N,)."""
    pos = np.asarray(pos, float)
    if pos.ndim == 1:
        return pos
    if center is not None:
        pos = pos - np.asarray(center)
    return np.linalg.norm(pos, axis=1)


def empirical_density_profile(pos, mass, center=None, bins=30,
                              r_min=None, r_max=None, **ref_kw):
    """(r_mid, rho(r), counts) spherical mass-density profile.

    The reference call form (``nbins=``/``rmin=``/``rmax=`` or an int
    third positional, reference utils/main.py:168) is also accepted and
    returns the reference 2-tuple contract ``(radius, density)`` on the
    reference's 0-started graded grid with arithmetic bin centres.
    """
    edges_ref = _ref_grid_form(center, ref_kw)
    if ref_kw:
        raise TypeError(f"unexpected kwargs: {sorted(ref_kw)}")
    pos = np.asarray(pos, float)
    n = pos.shape[0]
    mass = np.broadcast_to(np.asarray(mass, float), (n,))
    if edges_ref is not None:
        r = _radii_of(pos, None)
        msum, _ = np.histogram(r, bins=edges_ref, weights=mass)
        vol = 4.0 / 3.0 * np.pi * (edges_ref[1:]**3 - edges_ref[:-1]**3)
        return 0.5 * (edges_ref[1:] + edges_ref[:-1]), msum / vol
    r = _radii_of(pos, center)
    edges, mids, idx, valid = _radial_bins(r, bins, r_min, r_max)
    msum = np.bincount(idx[valid], weights=mass[valid],
                       minlength=len(mids))
    counts = np.bincount(idx[valid], minlength=len(mids))
    vol = 4.0 / 3.0 * np.pi * (edges[1:]**3 - edges[:-1]**3)
    return mids, msum / vol, counts


def empirical_circular_velocity_profile(pos, mass, center=None, bins=30,
                                        G: float = G_DEFAULT,
                                        r_min=None, r_max=None, **ref_kw):
    """(r_mid, v_circ = sqrt(G M(<r)/r)) from exact enclosed mass.

    Reference form (``nbins=``/``rmin=``/``rmax=`` or int third
    positional) uses the reference grid; both forms return 2-tuples.
    """
    edges_ref = _ref_grid_form(center, ref_kw)
    if ref_kw:
        raise TypeError(f"unexpected kwargs: {sorted(ref_kw)}")
    pos = np.asarray(pos, float)
    mass = np.broadcast_to(np.asarray(mass, float), (pos.shape[0],))
    if edges_ref is not None:
        mids = 0.5 * (edges_ref[1:] + edges_ref[:-1])
        r = _radii_of(pos, None)
    else:
        r = _radii_of(pos, center)
        _, mids, _, _ = _radial_bins(r, bins, r_min, r_max)
    order = np.argsort(r)
    m_enc_sorted = np.cumsum(mass[order])
    m_at = np.interp(mids, r[order], m_enc_sorted)
    with np.errstate(divide="ignore", invalid="ignore"):
        vc = np.where(mids > 0, np.sqrt(G * m_at / np.maximum(mids, 1e-300)),
                      0.0)
    return mids, vc


def _velocity_profile(pos, vel, center, center_v, bins, stat,
                      r_min=None, r_max=None):
    pos = np.asarray(pos, float)
    vel = np.asarray(vel, float)
    if center is not None:
        pos = pos - np.asarray(center)
    if center_v is not None:
        vel = vel - np.asarray(center_v)
    r = np.linalg.norm(pos, axis=1)
    edges, mids, idx, valid = _radial_bins(r, bins, r_min, r_max)
    out = np.full(len(mids), np.nan)
    for k in range(len(mids)):
        sel = valid & (idx == k)
        if sel.sum() > 1:
            out[k] = stat(pos[sel], vel[sel], r[sel])
    return mids, out


def _binned_stat(r, values, edges, stat):
    idx = np.digitize(r, edges) - 1
    out = np.full(len(edges) - 1, np.nan)
    for k in range(len(out)):
        sel = idx == k
        if sel.sum() > 1:
            out[k] = stat(values[sel])
    return out


def empirical_velocity_dispersion_profile(pos, vel, center=None,
                                          center_v=None, bins=30,
                                          **kw):
    """(r_mid, sigma_r) radial velocity dispersion.

    The reference form (``nbins=``/``rmin=``/``rmax=`` or int third
    positional, reference utils/main.py:276) bins on the reference grid
    and returns the reference statistic — the std of the speed
    ``|v|`` per bin, not the radial dispersion.
    """
    edges_ref = _ref_grid_form(center, kw)
    if edges_ref is not None:
        if kw:
            raise TypeError(f"unexpected kwargs: {sorted(kw)}")
        r = _radii_of(pos, None)
        vel = np.asarray(vel, float)
        speed = np.linalg.norm(vel, axis=1) if vel.ndim == 2 else vel
        return (0.5 * (edges_ref[1:] + edges_ref[:-1]),
                _binned_stat(r, speed, edges_ref, np.std))

    def stat(p, v, r):
        vr = np.sum(p * v, axis=1) / np.maximum(r, 1e-12)
        return np.std(vr)

    return _velocity_profile(pos, vel, center, center_v, bins, stat, **kw)


def empirical_velocity_rms_profile(pos, vel, center=None, center_v=None,
                                   bins=30, **kw):
    """(r_mid, v_rms) total rms speed profile.

    Reference form (``nbins=``/``rmin=``/``rmax=`` or int third
    positional, reference utils/main.py:316) supported as in
    :func:`empirical_velocity_dispersion_profile`.
    """
    edges_ref = _ref_grid_form(center, kw)
    if edges_ref is not None:
        if kw:
            raise TypeError(f"unexpected kwargs: {sorted(kw)}")
        r = _radii_of(pos, None)
        vel = np.asarray(vel, float)
        speed = np.linalg.norm(vel, axis=-1) if vel.ndim >= 2 else vel
        rms = _binned_stat(r, speed, edges_ref,
                           lambda v: np.sqrt(np.mean(v**2)))
        return 0.5 * (edges_ref[1:] + edges_ref[:-1]), rms

    def stat(p, v, r):
        return np.sqrt(np.mean((v**2).sum(1)))

    return _velocity_profile(pos, vel, center, center_v, bins, stat, **kw)


def empirical_velocity_anisotropy_profile(pos, vel, center=None,
                                          center_v=None, bins=30, **kw):
    """(r_mid, beta = 1 - sigma_t^2/(2 sigma_r^2)).

    The reference form (reference utils/main.py:361: third positional =
    ``mass`` (N,) or scalar, ``nbins=``/``rmin=``/``rmax=``; ``rmax``
    defaults to the 90th radius percentile) computes the mass-weighted
    beta on the reference grid.  Detected by reference keywords or a
    non-(3,)-shaped third positional.
    """
    mass = kw.pop("mass", None)
    ref = any(k in kw for k in ("nbins", "rmin", "rmax")) \
        or mass is not None
    if center is not None and np.shape(center) != (3,):
        mass, center, ref = center, None, True
    if ref:
        pos = np.asarray(pos, float)
        vel = np.asarray(vel, float)
        if pos.ndim != 2 or pos.shape[1] != 3 or vel.shape != pos.shape:
            raise ValueError("pos and vel must both be (N, 3) for the "
                             "anisotropy decomposition")
        r = np.linalg.norm(pos, axis=1)
        rmax = kw.pop("rmax", None)
        if rmax is None:
            rmax = float(np.percentile(r, 90))
        edges = make_uneven_grid(kw.pop("rmin", 0.1), rmax,
                                 nbins=int(kw.pop("nbins", 50)) + 1)
        if kw:
            raise TypeError(f"unexpected kwargs: {sorted(kw)}")
        n = pos.shape[0]
        m = (np.ones(n) if mass is None
             else np.broadcast_to(np.asarray(mass, float), (n,)))
        vr = np.sum(pos * vel, axis=1) / np.maximum(r, 1e-300)
        vt2 = np.sum(vel**2, axis=1) - vr**2
        idx = np.digitize(r, edges) - 1
        valid = (idx >= 0) & (idx < len(edges) - 1)
        nb = len(edges) - 1
        msum = np.bincount(idx[valid], weights=m[valid], minlength=nb)
        with np.errstate(divide="ignore", invalid="ignore"):
            mean_vr = np.bincount(idx[valid], weights=(m * vr)[valid],
                                  minlength=nb) / msum
            s_r2 = np.bincount(idx[valid], weights=(m * vr**2)[valid],
                               minlength=nb) / msum - mean_vr**2
            s_t2 = np.bincount(idx[valid], weights=(m * vt2)[valid],
                               minlength=nb) / msum
            beta = 1.0 - s_t2 / (2.0 * np.where(s_r2 > 0, s_r2, np.nan))
        return 0.5 * (edges[1:] + edges[:-1]), beta

    def stat(p, v, r):
        rr = np.maximum(r, 1e-12)[:, None]
        rhat = p / rr
        # spherical basis: theta-hat, phi-hat
        rho_c = np.sqrt(p[:, 0]**2 + p[:, 1]**2) + 1e-30
        phihat = np.column_stack([-p[:, 1] / rho_c, p[:, 0] / rho_c,
                                  np.zeros(len(p))])
        thetahat = np.cross(phihat, rhat)
        vr = np.sum(rhat * v, axis=1)
        vth = np.sum(thetahat * v, axis=1)
        vph = np.sum(phihat * v, axis=1)
        s_r2 = np.var(vr)
        s_t2 = np.var(vth) + np.var(vph)
        return 1.0 - s_t2 / np.maximum(2.0 * s_r2, 1e-12)

    return _velocity_profile(pos, vel, center, center_v, bins, stat, **kw)


# ---------------------------------------------------------------------------
# Profile fits
# ---------------------------------------------------------------------------

def double_power_law_density(*args, **kw):
    """Zhao (1996) alpha-beta-gamma profile — two call forms.

    Native evaluator: ``double_power_law_density(r, rho_s, r_s, alpha,
    beta, gamma)`` -> rho(r) = rho_s (r/r_s)^-gamma
    [1 + (r/r_s)^alpha]^-((beta-gamma)/alpha).

    Reference factory (reference utils/main.py:450-531):
    ``double_power_law_density(mass, scaleradius, alpha, beta, gamma,
    rcut=None, cutoffstrength=2.0)`` -> a callable ``rho(r)``
    normalised so the profile (with its optional exponential cutoff
    ``exp(-(r/rcut)^cutoffstrength)``) integrates to ``mass``.
    Detected by 5 positional args or any reference keyword.
    """
    ref_keys = {"mass", "scaleradius", "rcut", "cutoffstrength"}
    if not (ref_keys & kw.keys()) and len(args) + len(kw) >= 6:
        # native evaluator form
        names = ["r", "rho_s", "r_s", "alpha", "beta", "gamma"]
        p = dict(zip(names, args))
        p.update(kw)
        x = np.asarray(p["r"], float) / p["r_s"]
        g, b, a = p["gamma"], p["beta"], p["alpha"]
        return p["rho_s"] * x**(-g) * (1.0 + x**a)**(-(b - g) / a)

    from scipy.integrate import quad

    names = ["mass", "scaleradius", "alpha", "beta", "gamma", "rcut",
             "cutoffstrength"]
    p = dict(zip(names, args))
    p.update(kw)
    unknown = set(p) - set(names)
    if unknown:
        raise TypeError(f"unexpected kwargs: {sorted(unknown)}")
    mass, a = float(p["mass"]), float(p["scaleradius"])
    alpha, beta, gamma = (float(p["alpha"]), float(p["beta"]),
                          float(p["gamma"]))
    rcut = p.get("rcut")
    cut_s = float(p.get("cutoffstrength", 2.0))
    if beta <= 3.0 and rcut is None:
        raise ValueError(
            "beta <= 3 requires a finite rcut to normalise total mass")

    def shape(r):
        x = np.asarray(r, float) / a
        # over: x**alpha overflows to inf far outside the profile, where
        # (1 + inf)**(-k) correctly collapses rho to 0 — harmless, but
        # the RuntimeWarning would leak to fit callers
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            rho = np.where(
                x > 0.0,
                x**(-gamma) * (1.0 + x**alpha)**(-(beta - gamma) / alpha),
                0.0)
        if rcut is not None and rcut > 0:
            rho = rho * np.exp(-(np.asarray(r, float) / rcut)**cut_s)
        return rho

    upper = 8.0 * rcut if (rcut is not None and rcut > 0) \
        else max(1e4 * a, 1e3)
    total, _ = quad(lambda r: r**2 * shape(r), 0.0, upper,
                    epsrel=1e-6, limit=200)
    norm = mass / (4.0 * np.pi * total)
    if not np.isfinite(norm) or norm <= 0:
        raise RuntimeError(
            "normalisation integral failed; provide rcut or steeper "
            "outer slope")
    return lambda r: norm * shape(r)


def _fit_log_profile(model, r, rho, p0, bounds):
    from scipy.optimize import curve_fit

    good = (rho > 0) & np.isfinite(rho)
    popt, pcov = curve_fit(model, r[good], np.log(rho[good]), p0=p0,
                           bounds=bounds, maxfev=20000)
    return popt, np.sqrt(np.diag(pcov))


def _ellipsoidal_density_profile(pos, mass, bins, axis_y=1.0, axis_z=1.0,
                                 pct=(0.1, 99.9)):
    """(r_centers, rho_vals) on log-spaced shells of the ellipsoidal
    radius r~ = sqrt(x^2 + (y/q_y)^2 + (z/q_z)^2) (reference binning,
    utils/main.py:843-852)."""
    pos = np.asarray(pos, float)
    n = pos.shape[0]
    mass = np.broadcast_to(np.asarray(mass, float), (n,))
    x, y, z = pos.T
    r = np.sqrt(x**2 + (y / axis_y)**2 + (z / axis_z)**2)
    rmin, rmax = np.percentile(r, list(pct))
    edges = np.geomspace(rmin, rmax, int(bins) + 1)
    centers = np.sqrt(edges[:-1] * edges[1:])
    msum, _ = np.histogram(r, bins=edges, weights=mass)
    vol = (4.0 / 3.0 * np.pi * axis_y * axis_z
           * (edges[1:]**3 - edges[:-1]**3))
    return centers, msum / vol


_REF_SPHEROID_KWARGS = frozenset((
    "r_centers", "rho_vals", "pos", "mass", "bins", "axis_y", "axis_z",
    "weighting", "plot_results", "return_profiles", "rcut",
    "cutoff_strength"))


def fit_double_spheroid_profile(r=None, rho=None, p0=None, **ref_kw):
    """Fit the alpha-beta-gamma profile to a density curve; returns
    (params dict, 1-sigma errors dict).

    The reference call form (reference utils/main.py:532-798, detected
    by any of its keywords ``pos=``/``mass=``/``bins=``/``axis_y=``/
    ``weighting=``/``return_profiles=``/``rcut=``/...) bins particles on
    ellipsoidal radii when no profile is given, weights the log-space
    residuals, fits the mass-normalised Zhao model and returns the
    reference contract ``(M, a, alpha, beta, gamma)`` (plus
    ``(r_centers, rho_vals, rho_residuals, r2_rho_vals)`` when
    ``return_profiles=True``).
    """
    if ref_kw:
        unknown = set(ref_kw) - _REF_SPHEROID_KWARGS
        if unknown:
            raise TypeError(f"unexpected kwargs: {sorted(unknown)}")
        return _fit_spheroid_reference_form(
            r_centers=np.asarray(
                ref_kw.pop("r_centers", r if r is not None else ()),
                float),
            rho_vals=np.asarray(
                ref_kw.pop("rho_vals", rho if rho is not None else ()),
                float),
            **ref_kw)
    r = np.asarray(r, float)
    rho = np.asarray(rho, float)
    if p0 is None:
        p0 = [np.interp(np.median(r), r, rho), np.median(r), 1.0, 3.0, 1.0]

    def model(rr, lrho_s, lr_s, alpha, beta, gamma):
        return np.log(double_power_law_density(
            rr, np.exp(lrho_s), np.exp(lr_s), alpha, beta, gamma))

    p0l = [np.log(max(p0[0], 1e-300)), np.log(p0[1]), p0[2], p0[3], p0[4]]
    bounds = ([-200, np.log(r.min() / 10), 0.2, 1.0, 0.0],
              [200, np.log(r.max() * 10), 5.0, 8.0, 2.8])
    popt, perr = _fit_log_profile(model, r, rho, p0l, bounds)
    names = ["rho_s", "r_s", "alpha", "beta", "gamma"]
    vals = [np.exp(popt[0]), np.exp(popt[1]), *popt[2:]]
    errs = [vals[0] * perr[0], vals[1] * perr[1], *perr[2:]]
    return dict(zip(names, vals)), dict(zip(names, errs))


def _fit_spheroid_reference_form(
        r_centers, rho_vals, pos=None, mass=None, bins: int = 20,
        axis_y: float = 1.0, axis_z: float = 1.0, weighting="uniform",
        plot_results: bool = False, return_profiles: bool = False,
        rcut=None, cutoff_strength: float = 2.0):
    """Reference-contract spheroid fit (reference utils/main.py:532).

    Fits (M, a, alpha, beta, gamma) of the mass-normalised Zhao model to
    a log-density profile; the profile is measured from particles on the
    reference's 0-started graded grid of ellipsoidal radii when not
    supplied directly.
    """
    from scipy.optimize import minimize

    if len(r_centers) != len(rho_vals) or len(rho_vals) < 2:
        if pos is None or len(np.asarray(pos)) == 0:
            raise ValueError(
                "Either supply r_centers & rho_vals, or pos & mass.")
        pos = np.asarray(pos, float)
        if pos.ndim != 2 or pos.shape[1] != 3:
            raise ValueError(f"pos must be (N, 3), got {pos.shape}")
        m = np.broadcast_to(np.asarray(mass, float), (pos.shape[0],))
        x, y, z = pos.T
        r_t = np.sqrt(x**2 + (y / axis_y)**2 + (z / axis_z)**2)
        edges = make_uneven_grid(0.1, float(np.percentile(r_t, 90)),
                                 nbins=int(bins) + 1)
        r_centers = 0.5 * (edges[:-1] + edges[1:])
        vol = (4.0 / 3.0 * np.pi * axis_y * axis_z
               * (edges[1:]**3 - edges[:-1]**3))
        msum, _ = np.histogram(r_t, bins=edges, weights=m)
        rho_vals = msum / np.maximum(vol, 1e-18)
        m_total = float(m.sum())
    else:
        # total mass from the trapezoidal integral of rho r^3 dln r
        m_total = float(4.0 * np.pi * np.trapezoid(
            rho_vals * r_centers**3, x=np.log(r_centers)))

    if isinstance(weighting, str):
        schemes = {
            "uniform": np.ones_like(r_centers),
            "inner": 1.0 / np.maximum(r_centers**2, 1e-18),
            "outer": r_centers**2,
            "sqrt": np.sqrt(np.maximum(r_centers, 1e-18)),
            "inverse_sqrt": 1.0 / np.sqrt(np.maximum(r_centers, 1e-18)),
        }
        weights = schemes.get(weighting, np.ones_like(r_centers))
    else:
        weights = np.asarray(weighting, float)
        if len(weights) != len(r_centers):
            raise ValueError("weighting array length must match the "
                             "number of profile points")

    log_rho_data = np.log10(np.maximum(rho_vals, 1e-12))

    def model_rho(params):
        log_m, log_a, alpha, beta, gamma = params
        rho_fn = double_power_law_density(
            mass=10**log_m, scaleradius=10**log_a, alpha=alpha,
            beta=beta, gamma=gamma, rcut=rcut,
            cutoffstrength=cutoff_strength)
        return rho_fn(r_centers)

    def objective(params):
        try:
            log_model = np.log10(np.maximum(model_rho(params), 1e-12))
            return float(np.sum(weights * (log_model - log_rho_data)**2))
        except Exception:
            return 1e10

    p0 = [np.log10(m_total), np.log10(5.0), 1.0, 3.0, 1.0]
    bounds = [(np.log10(m_total * 0.8), np.log10(m_total * 1.2)),
              (np.log10(0.1), np.log10(r_centers[-1])),
              (0.1, np.inf), (1.0, np.inf), (0.0, np.inf)]
    res = minimize(objective, p0, method="L-BFGS-B", bounds=bounds)
    log_m, log_a, alpha_f, beta_f, gamma_f = res.x
    params = (10**log_m, 10**log_a, float(alpha_f), float(beta_f),
              float(gamma_f))

    if plot_results:  # diagnostic only; the fit itself is headless
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.loglog(r_centers, rho_vals, "o", label="data")
        ax.loglog(r_centers, model_rho(res.x), "-", label="fit")
        ax.set_xlabel("r")
        ax.set_ylabel("rho")
        ax.legend()
    if return_profiles:
        rho_model = model_rho(res.x)
        return params, (r_centers, rho_vals, rho_vals - rho_model,
                        r_centers**2 * rho_vals)
    return params


def fit_dehnen_profile(r, rho=None, p0=None, *, mass=None,
                       axis_y: float = 1.0,
                       axis_z: float = 1.0, bins: int = 50):
    """Fit a Dehnen (1993) profile rho = (3-g) M a / (4 pi r^g (r+a)^(4-g));
    returns ({'mass','scaleRadius','gamma'}, errors).

    The reference particle form (reference utils/main.py:801:
    ``fit_dehnen_profile(pos (N,3), mass, axis_y=, axis_z=, bins=)``,
    detected by a 2-D first argument) bins on the ellipsoidal radius
    and returns the reference contract
    ``(M_fit, a_fit, gamma_fit, r_centers, rho_vals)``.
    """
    r = np.asarray(r, float)
    if r.ndim == 2:
        m = mass if mass is not None else (
            rho if rho is not None else 1.0)
        centers, rho_vals = _ellipsoidal_density_profile(
            r, m, bins, axis_y, axis_z)
        vals, _ = fit_dehnen_profile(centers, rho_vals, p0)
        return (vals["mass"], vals["scaleRadius"], vals["gamma"],
                centers, rho_vals)
    rho = np.asarray(rho, float)

    def model(rr, logm, loga, gamma):
        m, a = np.exp(logm), np.exp(loga)
        return np.log((3.0 - gamma) * m * a
                      / (4.0 * np.pi * rr**gamma * (rr + a)**(4.0 - gamma)))

    if p0 is None:
        p0 = [np.log(4 * np.pi * np.trapezoid(rho * r**2, r)),
              np.log(np.median(r)), 1.0]
    bounds = ([-200, np.log(r.min() / 10), 0.0],
              [200, np.log(r.max() * 10), 2.8])
    popt, perr = _fit_log_profile(model, r, rho, p0, bounds)
    vals = dict(mass=np.exp(popt[0]), scaleRadius=np.exp(popt[1]),
                gamma=popt[2])
    errs = dict(mass=vals["mass"] * perr[0],
                scaleRadius=vals["scaleRadius"] * perr[1], gamma=perr[2])
    return vals, errs


def fit_plummer_profile(r, rho=None, p0=None, *, mass=None,
                        bins: int = 30):
    """Fit a Plummer sphere; returns ({'mass','scaleRadius'}, errors).

    The reference particle form (reference utils/main.py:872:
    ``fit_plummer_profile(pos (N,3), mass, bins=)``, detected by a 2-D
    first argument) returns the reference contract
    ``(M_fit, b_fit, r_centers, rho_vals)``.
    """
    r = np.asarray(r, float)
    if r.ndim == 2:
        m = mass if mass is not None else (
            rho if rho is not None else 1.0)
        centers, rho_vals = _ellipsoidal_density_profile(r, m, bins)
        vals, _ = fit_plummer_profile(centers, rho_vals, p0)
        return vals["mass"], vals["scaleRadius"], centers, rho_vals
    rho = np.asarray(rho, float)

    def model(rr, logm, logb):
        m, b = np.exp(logm), np.exp(logb)
        return np.log(3.0 * m / (4.0 * np.pi * b**3)
                      * (1.0 + (rr / b)**2)**-2.5)

    if p0 is None:
        p0 = [np.log(4 * np.pi * np.trapezoid(rho * r**2, r)),
              np.log(np.median(r))]
    bounds = ([-200, np.log(r.min() / 10)], [200, np.log(r.max() * 10)])
    popt, perr = _fit_log_profile(model, r, rho, p0, bounds)
    vals = dict(mass=np.exp(popt[0]), scaleRadius=np.exp(popt[1]))
    errs = dict(mass=vals["mass"] * perr[0],
                scaleRadius=vals["scaleRadius"] * perr[1])
    return vals, errs


# ---------------------------------------------------------------------------
# Shape
# ---------------------------------------------------------------------------

_REF_ELLIPSOID_KWARGS = frozenset((
    "vel", "Rmin", "Rmax", "reduced_structure", "orient_with_momentum",
    "max_iter", "verbose", "return_ellip_triax"))


def fit_iterative_ellipsoid(pos, mass=None, center=None, r_max=None,
                            n_iter: int = 20, tol: float = 1e-4,
                            reduced: bool = True, **ref_kw):
    """Iterative ellipsoidal shape fit via the (reduced) inertia tensor.

    Returns dict with axis ratios b/a, c/a, the rotation matrix (rows =
    principal axes, descending), and convergence info (reference:
    utils/main.py:1025-1326).

    The reference call form (detected by its keywords ``Rmax=``/
    ``Rmin=``/``vel=``/``orient_with_momentum=``/... or an (N, 3) third
    positional = velocities) returns the reference contract
    ``(abc [1, b/a, c/a], transform rows [e_a, e_b, e_c][, ellip,
    triax])``.
    """
    if center is not None and np.ndim(center) == 2:
        ref_kw.setdefault("vel", center)
        center = None
    if ref_kw:
        unknown = set(ref_kw) - _REF_ELLIPSOID_KWARGS
        if unknown:
            raise TypeError(f"unexpected kwargs: {sorted(unknown)}")
        return _ellipsoid_reference_form(pos, mass, tol=tol, **ref_kw)
    pos = np.asarray(pos, float)
    n = pos.shape[0]
    w = (np.ones(n) if mass is None
         else np.broadcast_to(np.asarray(mass, float), (n,)).copy())
    if center is not None:
        pos = pos - np.asarray(center)
    if r_max is None:
        r_max = np.percentile(np.linalg.norm(pos, axis=1), 90)

    axes = np.eye(3)
    q = s = 1.0
    converged = False
    it = -1   # n_iter=0: report 0 iterations, identity result
    for it in range(n_iter):
        y = pos @ axes.T
        r_ell2 = y[:, 0]**2 + (y[:, 1] / q)**2 + (y[:, 2] / s)**2
        sel = r_ell2 <= r_max**2
        if sel.sum() < 10:
            break
        ww = w[sel]
        if reduced:
            ww = ww / np.maximum(r_ell2[sel], 1e-12)
        x = pos[sel]
        # matmul form: same 3x3 inertia tensor without the (N, 3, 3)
        # temporary (~720 MB/iteration at N = 1e7)
        tensor = (x * ww[:, None]).T @ x
        tensor /= ww.sum()
        evals, evecs = np.linalg.eigh(tensor)
        order = np.argsort(evals)[::-1]
        evals = evals[order]
        axes_new = evecs[:, order].T
        q_new = np.sqrt(evals[1] / evals[0])
        s_new = np.sqrt(evals[2] / evals[0])
        if abs(q_new - q) < tol and abs(s_new - s) < tol:
            q, s, axes = q_new, s_new, axes_new
            converged = True
            break
        q, s, axes = q_new, s_new, axes_new
    return {"b_over_a": q, "c_over_a": s, "axes": axes,
            "converged": converged, "iterations": it + 1}


def _ellipsoid_reference_form(pos, mass=None, vel=None,
                              Rmin: float = 0.0, Rmax: float = 1.0,
                              reduced_structure: bool = True,
                              orient_with_momentum: bool = True,
                              tol: float = 1e-4, max_iter: int = 50,
                              verbose: bool = False,
                              return_ellip_triax: bool = False):
    """Reference-contract adaptive-ellipsoid fit (reference
    utils/main.py:1025-1326): iterate the (reduced) structure tensor
    inside an adaptive ellipsoidal shell [Rmin, Rmax], optionally
    re-orienting the minor axis along the selection's angular momentum,
    and return ``(abc, transform[, ellip, triax])``."""
    pos = np.asarray(pos, float)
    n = pos.shape[0]
    m = (np.ones(n) if mass is None
         else np.broadcast_to(np.asarray(mass, float), (n,)))
    if not (Rmin >= 0 and Rmax > 0 and Rmax > Rmin):
        raise ValueError("Need Rmin >= 0, Rmax > 0, and Rmax > Rmin.")
    use_momentum = orient_with_momentum and vel is not None
    if orient_with_momentum and vel is None and verbose:
        print("Warning: orient_with_momentum=True but vel not "
              "provided. Disabling momentum orientation.")
    v = None if vel is None else np.asarray(vel, float)

    def nan_result():
        out = (np.full(3, np.nan), np.full((3, 3), np.nan))
        return out + (np.nan, np.nan) if return_ellip_triax else out

    axes = np.eye(3)
    q = s = 1.0
    for it in range(max_iter):
        y = pos @ axes.T
        r_ell2 = y[:, 0]**2 + (y[:, 1] / q)**2 + (y[:, 2] / s)**2
        sel = (r_ell2 < Rmax**2) & (r_ell2 >= Rmin**2)
        if sel.sum() < 10:
            return nan_result()
        ww = m[sel]
        if reduced_structure:
            ww = ww / np.maximum(np.sum(pos[sel]**2, axis=1), 1e-12)
        x = pos[sel]
        tensor = (x * ww[:, None]).T @ x / ww.sum()
        evals, evecs = np.linalg.eigh(tensor)
        order = np.argsort(evals)[::-1]
        evals = np.maximum(evals[order], 0.0)
        axes_new = evecs[:, order].T          # rows e_a, e_b, e_c
        if use_momentum:
            # minor axis along the selection's angular momentum;
            # major/intermediate re-orthogonalised against it
            L = np.sum(m[sel, None] * np.cross(x, v[sel]), axis=0)
            if np.linalg.norm(L) > 0:
                e_c = L / np.linalg.norm(L)
                e_a = axes_new[0] - np.dot(axes_new[0], e_c) * e_c
                if np.linalg.norm(e_a) < 1e-12:
                    e_a = axes_new[1] - np.dot(axes_new[1], e_c) * e_c
                e_a = e_a / np.linalg.norm(e_a)
                axes_new = np.vstack([e_a, np.cross(e_c, e_a), e_c])
        q_new = np.sqrt(evals[1] / max(evals[0], 1e-300))
        s_new = np.sqrt(evals[2] / max(evals[0], 1e-300))
        dq, ds = abs(q_new - q), abs(s_new - s)
        q, s, axes = q_new, s_new, axes_new
        if verbose:
            print(f"  ellipsoid iter {it}: q={q:.5f} s={s:.5f}")
        if dq < tol and ds < tol:
            break
    abc = np.array([1.0, q, s])
    if not return_ellip_triax:
        return abc, axes
    ellip = 1.0 - s
    denom = 1.0 - s**2
    triax = (1.0 - q**2) / denom if denom > 0 else np.nan
    return abc, axes, ellip, triax


# ---------------------------------------------------------------------------
# Centering
# ---------------------------------------------------------------------------

def _shrinking_sphere(pos, mass, n_iter=12, frac=0.7, min_particles=50):
    com = (pos * mass[:, None]).sum(0) / mass.sum()
    r = np.linalg.norm(pos - com, axis=1).max()
    for _ in range(n_iter):
        r *= frac
        d = np.linalg.norm(pos - com, axis=1)
        sel = d <= r
        if sel.sum() < min_particles:
            break
        com = (pos[sel] * mass[sel, None]).sum(0) / mass[sel].sum()
    return com


def find_center(pos, *args, vel=None, mass=None,
                method: str = "density_peak",
                potential_solver=None, vel_aperture: float | None = None,
                G: float = G_DEFAULT, return_velocity=None,
                top_fraction: float = 0.01, **solver_kwargs):
    """Locate the density/potential centre of a particle set.

    method='density_peak': centre of the ``top_fraction`` most-bound
    particles by self-potential (solver from
    :func:`iterative_unbinding`'s menu); method='shrinking_sphere':
    geometric shrinking sphere; method='kde': Gaussian-KDE density peak.
    Returns centre (3,), or (centre, v_centre) when ``vel`` is given
    (v from particles within ``vel_aperture`` of the centre).

    Positional layout: both the native ``(pos, vel, mass, method)`` and
    the reference's ``(pos, mass, vel, method)`` (reference
    utils/main.py:1580) are accepted — extra positionals are classified
    by shape ((N, 3) -> vel, (N,)/scalar -> mass, str -> method).
    ``return_velocity=`` is honoured when passed explicitly (True
    requires ``vel``; False returns the centre only even if ``vel`` was
    given); ``theta=`` (tree opening angle) is accepted and ignored —
    the direct solver is exact.  ``device=`` (with the solver's other
    keywords) places the self-potential of 'density_peak': the card
    unless the caller passes ``device='cpu'``.
    """
    pos = np.asarray(pos, float)
    n = pos.shape[0]
    for a in args:
        if a is None:
            continue
        if isinstance(a, str):
            method = a
        elif np.ndim(a) == 2:
            if vel is not None:
                raise TypeError("vel passed twice")
            vel = a
        else:
            if mass is not None:
                raise TypeError("mass passed twice")
            mass = a
    solver_kwargs.pop("theta", None)
    mass_arr = (np.ones(n) if mass is None
                else np.broadcast_to(np.asarray(mass, float), (n,)))

    if method == "shrinking_sphere":
        center = _shrinking_sphere(pos, mass_arr)
    elif method == "kde":
        # Gaussian-KDE density peak (reference method='kde'): evaluate
        # the KDE at (a subsample of) the particles, take the
        # mass-weighted centroid of the top-density few
        from scipy.stats import gaussian_kde

        sub = pos if n <= 20000 else pos[
            np.random.default_rng(0).choice(n, 20000, replace=False)]
        dens = gaussian_kde(sub.T, weights=None)(pos.T)
        k = max(1, int(n * top_fraction))
        sel = np.argpartition(-dens, k - 1)[:k]
        center = (pos[sel] * mass_arr[sel, None]).sum(0) \
            / mass_arr[sel].sum()
    elif method == "density_peak":
        phi = _self_potential(pos, mass_arr,
                              solver=potential_solver or "direct",
                              G=G, **solver_kwargs)
        k = max(1, int(n * top_fraction))
        sel = np.argpartition(phi, k - 1)[:k]
        center = (pos[sel] * mass_arr[sel, None]).sum(0) \
            / mass_arr[sel].sum()
    else:
        raise ValueError(f"unknown centering method {method!r}")

    if return_velocity is False or vel is None and not return_velocity:
        return center
    if vel is None:
        raise ValueError("return_velocity=True requires vel")
    vel = np.asarray(vel, float)
    d = np.linalg.norm(pos - center, axis=1)
    ap = np.percentile(d, 10) if vel_aperture is None else vel_aperture
    sel = d <= ap
    if not sel.any():
        raise ValueError(
            f"vel_aperture={ap:g} selects no particles around the centre "
            f"(nearest particle at distance {d.min():g}); enlarge it or "
            "pass vel_aperture=None for the 10th-percentile default")
    v_center = (vel[sel] * mass_arr[sel, None]).sum(0) / mass_arr[sel].sum()
    return center, v_center


def find_center_position(pos, mass=None, method: str = "density_peak",
                         **kwargs):
    """Position-only deprecated alias (reference main.py:1692-1709:
    positional layout (pos, mass, method))."""
    import warnings

    warnings.warn("find_center_position is deprecated; use find_center "
                  "instead.", DeprecationWarning, stacklevel=2)
    out = find_center(pos, mass=mass, method=method,
                      return_velocity=False, **kwargs)
    return out[0] if isinstance(out, tuple) else out


# ---------------------------------------------------------------------------
# Unbinding
# ---------------------------------------------------------------------------

def _direct_potential(pos, mass, softening, G, kernel, precision, device):
    """The self-masked direct potential of (pos, mass) through
    ``DirectGravity.potential``: the CUDA kernel's potential form on the
    card, its plain version on the CPU; float64 numpy out."""
    from ..friction import _np
    from ..ops.dispatch import DirectGravity

    pos = np.asarray(pos, float)
    n = pos.shape[0]
    solver = DirectGravity(
        np.broadcast_to(np.asarray(mass, float), (n,)).copy(), softening,
        G=G,
        kernel=kernel, precision=precision, impl="cuda", device=device)
    return _np(solver.potential(
        torch.as_tensor(pos, dtype=solver.dtype, device=solver.device)))


def _self_potential(pos, mass, solver: str = "direct", G: float = G_DEFAULT,
                    softening=0.0, kernel: str = "plummer",
                    precision: str = "float32_kahan", r_grid_n: int = 64,
                    device="cuda"):
    """Per-particle self-potential via a pluggable solver, on ``device``.

    'direct' (alias 'direct_gpu', 'direct_tpu', 'tree', 'tree_gpu'):
    exact O(N^2) summation through the CUDA kernel's potential form;
    'bfe': spherical shell approximation (O(N log N)).
    """
    key = solver.lower()
    if key in ("direct", "direct_gpu", "direct_tpu", "tree", "tree_gpu"):
        return _direct_potential(pos, mass, softening, G, kernel,
                                 precision, device)
    if key == "bfe":
        from ..fast_sims import spherical_potential_from_particles
        from ..friction import _np

        # the refit profile is origin-centred: evaluate relative to the
        # cluster's centre of mass
        com = (pos * mass[:, None]).sum(0) / mass.sum()
        pot = spherical_potential_from_particles(pos, mass, center=com,
                                                 n_grid=r_grid_n, G=G,
                                                 device=device)
        return _np(pot.potential(pos - com))
    raise ValueError(f"unknown potential solver {solver!r}")


_REF_UNBIND_KWARGS = frozenset((
    "pos_star", "vel_star", "mass_star", "center_position",
    "recursive_iter_converg", "potential_compute_method", "center_on",
    "vel_aperture", "tol_frac_change", "return_history", "top_fraction",
    "theta", "lmax"))


def iterative_unbinding(pos, vel, mass, solver: str = "direct",
                        max_iter: int = 20, G: float = G_DEFAULT,
                        softening=0.0, center_velocity: bool = True,
                        verbose: bool = False, device="cuda",
                        **solver_kwargs):
    """Iteratively remove unbound particles (E = phi + v^2/2 > 0).

    Returns (bound_mask (N,), info dict).  Velocities are measured
    relative to the bound subset's mass-weighted mean each iteration
    (reference: utils/main.py:1722-2047).

    The reference call form is also accepted (detected by its
    reference-only kwargs: ``pos_star``/``potential_compute_method``/
    ``center_position``/``tol_frac_change``/... or a vector
    ``center_velocity``) and returns the reference contract
    ``((bound_dark[, bound_star][, histories...]), center_position,
    center_velocity)`` with int masks — see
    :func:`compute_iterative_boundness`.

    The self-potential runs on ``device``: the card unless the caller
    passes ``device='cpu'`` (without a card the default raises).
    """
    if (not isinstance(center_velocity, bool)
            or _REF_UNBIND_KWARGS & solver_kwargs.keys()):
        ref_kwargs = dict(solver_kwargs)
        if not isinstance(center_velocity, bool):
            ref_kwargs["center_velocity"] = center_velocity
        if solver != "direct":
            ref_kwargs.setdefault("potential_compute_method", solver)
        ref_kwargs.setdefault("recursive_iter_converg", max_iter
                              if max_iter != 20 else 50)
        return _unbinding_reference_form(
            pos, vel, mass, softening=softening, G=G, verbose=verbose,
            device=device, **ref_kwargs)
    pos = np.asarray(pos, float)
    vel = np.asarray(vel, float)
    n = pos.shape[0]
    mass = np.broadcast_to(np.asarray(mass, float), (n,)).copy()

    bound = np.ones(n, dtype=bool)
    history = []
    for it in range(max_iter):
        nb = int(bound.sum())
        if nb < 2:
            break
        phi = np.full(n, np.inf)
        phi_b = _self_potential(pos[bound], mass[bound], solver=solver,
                                G=G, softening=softening, device=device,
                                **solver_kwargs)
        phi[bound] = phi_b
        if center_velocity:
            v0 = (vel[bound] * mass[bound, None]).sum(0) / mass[bound].sum()
        else:
            v0 = np.zeros(3)
        ke = 0.5 * ((vel - v0) ** 2).sum(1)
        new_bound = (phi + ke) < 0.0
        n_removed = int((bound & ~new_bound).sum())
        history.append(n_removed)
        if verbose:
            print(f"  unbinding iter {it}: removed {n_removed}, "
                  f"bound {int(new_bound.sum())}/{n}")
        if n_removed == 0:
            bound = new_bound
            break
        bound = new_bound
    return bound, {
        "iterations": len(history),
        "removed_per_iter": history,
        "bound_fraction": float(bound.sum()) / n,
    }


def _unbinding_reference_form(
        pos_dark, vel_dark, mass_dark, pos_star=None, vel_star=None,
        mass_star=None, center_position=(), center_velocity=(),
        recursive_iter_converg: int = 50,
        potential_compute_method: str = "tree", softening: float = 0.03,
        G: float = G_DEFAULT, center_on: str = "dark",
        vel_aperture: float = 5.0, tol_frac_change: float = 1e-4,
        verbose: bool = True, return_history: bool = False,
        device="cuda", **kwargs):
    """Reference-contract unbinding (reference utils/main.py:1722-2047).

    Multi-component (dark + star), automatic density-peak centering
    (mass-weighted centroid of the lowest-phi ``top_fraction`` of
    ``center_on`` particles; velocity = aperture mean), fixed centre,
    iterate ``E = phi + |v_rel|^2/2 < 0`` until the changed fraction
    drops below ``tol_frac_change``.  Solvers: 'tree'/'tree_gpu'/
    'direct'/'direct_gpu' all run the exact direct sum (the CUDA kernel's
    potential form on ``device`` — force error 0 instead of the tree's
    1-5%; ``theta`` accepted and ignored); 'bfe' fits a native Multipole (``lmax``, default 8) on the
    bound subset each iteration.  Returns ``((bound_dark[, bound_star]
    [, history_dark][, history_star]), center_position,
    center_velocity)`` with int masks, exactly the reference contract.
    """
    method = potential_compute_method.lower()
    if method not in ("tree", "tree_gpu", "direct", "direct_gpu",
                      "direct_tpu", "bfe"):
        raise ValueError(
            f"unknown potential_compute_method {potential_compute_method!r}")
    lmax = int(kwargs.pop("lmax", 8))
    top_fraction = float(kwargs.pop("top_fraction", 0.01))
    kwargs.pop("theta", None)             # tree opening angle: exact here
    precision = kwargs.pop("precision", "float32_kahan")
    kernel = kwargs.pop("kernel", "plummer")
    if kwargs:
        raise TypeError(f"unexpected kwargs: {sorted(kwargs)}")

    pos_dark = np.asarray(pos_dark, float)
    vel_dark = np.asarray(vel_dark, float)
    n_dark = pos_dark.shape[0]
    mass_dark = np.broadcast_to(np.asarray(mass_dark, float),
                                (n_dark,)).copy()
    has_stars = pos_star is not None
    if has_stars:
        pos_star = np.asarray(pos_star, float)
        vel_star = np.asarray(vel_star, float)
        mass_star = np.broadcast_to(np.asarray(mass_star, float),
                                    (pos_star.shape[0],)).copy()
        pos_all = np.vstack((pos_dark, pos_star))
        vel_all = np.vstack((vel_dark, vel_star))
        mass_all = np.concatenate((mass_dark, mass_star))
    else:
        pos_all, vel_all, mass_all = pos_dark, vel_dark, mass_dark
    if center_on == "star" and not has_stars:
        raise ValueError("center_on='star' requires star data")
    if center_on == "both" or not has_stars:
        ctr_sl = slice(None)
    elif center_on == "star":
        ctr_sl = slice(n_dark, None)
    else:
        ctr_sl = slice(None, n_dark)

    def phi_of(pos_eval, mass_src, bound_mask):
        if method == "bfe":
            from ..friction import _np
            from ..potentials import fit_multipole_from_particles
            from ..potentials.multipole import MultipolePotential

            coefs = fit_multipole_from_particles(
                pos_eval[bound_mask], mass_src[bound_mask], lmax=lmax,
                G=G)
            return _np(MultipolePotential(coefs).to(resolve_device(device))
                       .potential(pos_eval))
        # exact direct sum; unbound sources masked to zero mass (they
        # still receive phi at their positions and can re-bind)
        return _direct_potential(pos_eval, mass_src * bound_mask,
                                 softening, G, kernel, precision, device)

    center_position = np.asarray(center_position, float)
    center_velocity = np.asarray(center_velocity, float)
    all_bound = np.ones(len(pos_all), dtype=bool)
    if center_position.size < 3:
        phi_init = phi_of(pos_all, mass_all, all_bound)
        phi_c, pos_c, m_c = (phi_init[ctr_sl], pos_all[ctr_sl],
                             mass_all[ctr_sl])
        n_pick = max(10, int(len(phi_c) * top_fraction))
        idx = np.argsort(phi_c)[:n_pick]
        center_position = np.average(pos_c[idx], axis=0,
                                     weights=m_c[idx])
    if center_velocity.size < 3:
        pos_c, vel_c, m_c = (pos_all[ctr_sl], vel_all[ctr_sl],
                             mass_all[ctr_sl])
        sel = np.sum((pos_c - center_position) ** 2, axis=1) \
            < vel_aperture ** 2
        if not sel.any():
            sel = np.ones(len(pos_c), dtype=bool)
        center_velocity = np.average(vel_c[sel], axis=0,
                                     weights=m_c[sel])
    if verbose:
        print(f"unbinding centre: pos {np.around(center_position, 2)} "
              f"vel {np.around(center_velocity, 2)}")

    pos_rel = pos_all - center_position
    vel_rel = vel_all - center_velocity
    kin = 0.5 * np.sum(vel_rel ** 2, axis=1)
    mask = np.ones(len(pos_all), dtype=bool)
    hist_dark, hist_star = [], []
    for i in range(recursive_iter_converg):
        if int(mask.sum()) < 5:
            break
        phi = phi_of(pos_rel, mass_all, mask)
        new = (phi + kin) < 0.0
        hist_dark.append(new[:n_dark].copy())
        if has_stars:
            hist_star.append(new[n_dark:].copy())
        frac = float(np.mean(new != mask))
        if verbose:
            print(f"  unbinding iter {i}: delta bound mask = {frac:.5f}")
        mask = new
        if frac < tol_frac_change:
            break

    results = [mask[:n_dark].astype(int)]
    if has_stars:
        results.append(mask[n_dark:].astype(int))
    if return_history:
        results.append(hist_dark)
        if has_stars:
            results.append(hist_star)
    return tuple(results), center_position, center_velocity


def compute_iterative_boundness(*args, **kwargs):
    """Deprecated reference alias (reference utils/main.py:1714-1720):
    always runs the reference-contract form."""
    import warnings

    warnings.warn(
        "compute_iterative_boundness is deprecated; use "
        "iterative_unbinding.", DeprecationWarning, stacklevel=2)
    return _unbinding_reference_form(*args, **kwargs)
