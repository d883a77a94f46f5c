"""Fit BFE potentials directly from particle snapshots.

Counterpart of ``nbody_streams_tpu/potentials/fit.py`` (the Arora+2022
workflow: dark matter/hot gas -> Multipole, stars/cold gas -> CylSpline):

* Multipole: exact particle basis-function expansion — for each (l, m),
  Phi_lm(r) = -G/(2l+1) [ r^-(l+1) sum_{r_i<=r} m_i r_i^l Y_lm(i)
                          + r^l sum_{r_i>r} m_i r_i^-(l+1) Y_lm(i) ],
  computed with radius-sorted prefix/suffix sums: O(N log N + N n_lm).
  The analytic dPhi/dr is tabulated too, so the evaluator's Hermite
  interpolation is pinned to the exact particle forces at the nodes.
* CylSpline: the potential is evaluated on an azimuthal ring of points
  per (R, z) node by direct summation over all particles (the two-set
  potential form of ``csrc/direct.cu::direct_tile_kernel`` through
  ``ops/cuda_direct.cuda_potential_2set`` — O(N_grid x N), float32 with
  Kahan), then Fourier analysed into the per-m tables.

Overflow note: the r^l prefix sums are evaluated in float64 with radii
normalised to the grid median, safe for lmax <= 16 over ~4 decades of
radius (the common lmax = 8 regime by a wide margin).
"""
from __future__ import annotations

import math

import numpy as np

from ..constants import G_DEFAULT
from .base import resolve_device
from .coefs import CylSplineCoefs, MultipoleCoefs, generate_lmax_pairs
from .multipole import MUL0, MUL1

__all__ = [
    "fit_multipole_from_particles",
    "fit_cylspline_from_particles",
    "fit_potential",
    "create_snapshot_dict",
]


def create_snapshot_dict(pos_dark, mass_dark, pos_star=None, mass_star=None,
                         pos_gas=None, mass_gas=None, temperature_gas=None):
    """Pack particle arrays into a FIRE-like snapshot dictionary.

    Drop-in for the reference ``create_snapshot_dict``
    (agama_helper/_fit.py:44-128): returns
    ``{"dark": {"host.distance": pos, "mass": mass}, "star": {...},
    "gas": {...}}`` with empty sub-dicts for omitted species and an
    optional ``"temperature"`` entry for gas.  ``fit_potential`` accepts
    this dict directly (gas is split into hot/cold at
    ``cold_temp_log10_thresh`` when temperatures are present).
    """
    def check(pos, mass, name):
        pos = np.asarray(pos, float)
        mass = np.asarray(mass, float)
        if pos.ndim != 2 or pos.shape[1] != 3:
            raise ValueError(f"pos_{name} must be shape (N, 3)")
        if mass.ndim == 0:
            mass = np.broadcast_to(mass, (pos.shape[0],)).copy()
        if mass.shape[0] != pos.shape[0]:
            raise ValueError(f"mass_{name} length must match pos_{name}")
        return pos, mass

    pos_dark, mass_dark = check(pos_dark, mass_dark, "dark")
    snap = {"dark": {"host.distance": pos_dark, "mass": mass_dark},
            "star": {}, "gas": {}}
    if (pos_star is None) != (mass_star is None):
        raise ValueError("pos_star and mass_star must be given together")
    if pos_star is not None:
        pos_star, mass_star = check(pos_star, mass_star, "star")
        snap["star"] = {"host.distance": pos_star, "mass": mass_star}
    if (pos_gas is None) != (mass_gas is None):
        raise ValueError("pos_gas and mass_gas must be given together")
    if pos_gas is not None:
        pos_gas, mass_gas = check(pos_gas, mass_gas, "gas")
        snap["gas"] = {"host.distance": pos_gas, "mass": mass_gas}
        if temperature_gas is not None:
            temperature_gas = np.asarray(temperature_gas, float)
            if temperature_gas.shape[0] != pos_gas.shape[0]:
                raise ValueError(
                    "temperature_gas length must match pos_gas")
            snap["gas"]["temperature"] = temperature_gas
    elif temperature_gas is not None:
        raise ValueError("temperature_gas requires pos_gas/mass_gas")
    return snap


def _normalise_particles(particles, cold_temp_log10_thresh):
    """Accept both particle-dict forms: the native
    ``{species: (pos, mass)}`` and the reference's FIRE-style nested
    ``{species: {"host.distance": pos, "mass": mass[, "temperature": T]}}``
    (the ``create_snapshot_dict`` format).  Nested gas with temperatures
    is split into 'cold_gas' (-> CylSpline) and 'hot_gas' (-> Multipole)
    at ``log10 T = cold_temp_log10_thresh``, matching the reference's
    Arora+2022 split (agama_helper/_fit.py cold_temp_log10_thresh)."""
    out = {}
    for name, val in particles.items():
        if isinstance(val, dict):
            if not val:
                continue                      # empty sub-dict: omitted
            pos = np.asarray(val["host.distance"], float)
            mass = np.asarray(val["mass"], float)
            temp = val.get("temperature")
            if name == "gas" and temp is not None:
                cold = np.log10(np.maximum(np.asarray(temp, float),
                                           1e-30)) \
                    < cold_temp_log10_thresh
                if cold.any():
                    out["cold_gas"] = (pos[cold], mass[cold])
                if (~cold).any():
                    out["hot_gas"] = (pos[~cold], mass[~cold])
            else:
                out[name] = (pos, mass)
        else:
            out[name] = val
    return out


def _real_sph_harm(labels, pos):
    """Y_lm values per particle in the framework's 4-pi-normalised basis
    (Y_00 == 1), shape (n_lm, N)."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    r = np.sqrt(x**2 + y**2 + z**2) + 1e-300
    rc = np.sqrt(x**2 + y**2) + 1e-300
    ct = z / r
    st = rc / r
    cp = x / rc
    sp = y / rc
    lmax = max(l for l, _ in labels)
    mmax = max(abs(m) for _, m in labels)

    cos_m = {0: np.ones_like(cp)}
    sin_m = {0: np.zeros_like(sp)}
    for m in range(1, mmax + 1):
        cos_m[m] = cos_m[m - 1] * cp - sin_m[m - 1] * sp
        sin_m[m] = sin_m[m - 1] * cp + cos_m[m - 1] * sp

    p = {}
    for m in range(0, mmax + 1):
        pref = math.sqrt((2 * m + 1)
                         / (4.0 * math.pi * math.factorial(2 * m)))
        dfact = 1.0
        for i in range(1, 2 * m, 2):
            dfact *= i
        pmm = ((-1.0) ** m) * pref * dfact * st**m
        p[(m, m)] = pmm
        if m + 1 <= lmax:
            p[(m + 1, m)] = math.sqrt(2 * m + 3.0) * ct * pmm
        for l in range(m + 2, lmax + 1):
            a = math.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = math.sqrt(((l - 1.0) ** 2 - m * m)
                          / (4.0 * (l - 1.0) ** 2 - 1.0))
            p[(l, m)] = a * (ct * p[(l - 1, m)] - b * p[(l - 2, m)])

    out = np.empty((len(labels), len(x)))
    for i, (l, m) in enumerate(labels):
        am = abs(m)
        mul = MUL0 if m == 0 else MUL1
        trig = cos_m[am] if m >= 0 else sin_m[am]
        out[i] = mul * p[(l, am)] * trig
    return out


def _symmetry_labels(lmax, mmax, symmetry):
    labels = generate_lmax_pairs(lmax, mmax)
    key = symmetry.lower()
    if key in ("none", "n"):
        return labels
    if key in ("spherical", "s"):
        return [(0, 0)]
    if key in ("axisymmetric", "axisym", "a"):
        return [(l, m) for l, m in labels if m == 0]
    if key in ("triaxial", "t"):
        return [(l, m) for l, m in labels
                if l % 2 == 0 and m >= 0 and m % 2 == 0]
    if key in ("bisymmetric", "b"):
        return [(l, m) for l, m in labels if m % 2 == 0]
    raise ValueError(f"unknown symmetry {symmetry!r}")


def fit_multipole_from_particles(pos, mass, r_grid=None, lmax: int = 8,
                                 mmax: int | None = None,
                                 symmetry: str = "none", center=None,
                                 G: float = G_DEFAULT) -> MultipoleCoefs:
    """Exact particle-BFE Multipole coefficients (with dPhi/dr tables)."""
    pos = np.asarray(pos, float)
    n = pos.shape[0]
    mass = np.broadcast_to(np.asarray(mass, float), (n,))
    if center is not None:
        pos = pos - np.asarray(center, float)
    labels = _symmetry_labels(lmax, mmax if mmax is not None else lmax,
                              symmetry)

    r = np.linalg.norm(pos, axis=1)
    order = np.argsort(r)
    r_s = np.maximum(r[order], 1e-12)
    m_s = mass[order]
    y = _real_sph_harm(labels, pos[order])          # (n_lm, N)

    if r_grid is None:
        r_grid = np.geomspace(np.percentile(r_s, 0.2),
                              np.percentile(r_s, 99.8), 40)
    r_grid = np.asarray(r_grid, float)

    r_ref = np.median(r_s)                          # overflow guard
    u = r_s / r_ref
    ug = r_grid / r_ref

    n_lm = len(labels)
    phi = np.zeros((len(r_grid), n_lm))
    dphi = np.zeros((len(r_grid), n_lm))
    idx = np.searchsorted(r_s, r_grid, side="right")

    for i, (l, m) in enumerate(labels):
        w_in = m_s * y[i] * u**l                     # prefix sums
        w_out = m_s * y[i] * u ** (-(l + 1))         # suffix sums
        cin = np.concatenate([[0.0], np.cumsum(w_in)])
        cout = np.concatenate([np.cumsum(w_out[::-1])[::-1], [0.0]])
        s_in = cin[idx]
        s_out = cout[idx]
        pref = -G / (2.0 * l + 1.0)
        # f_in = r_i^l / r^(l+1) = (u^l / ug^(l+1)) / r_ref, ditto f_out
        phi[:, i] = pref * (s_in * ug ** (-(l + 1)) + s_out * ug**l) \
            / r_ref
        dphi[:, i] = pref / r_ref**2 * (
            -(l + 1) * s_in * ug ** (-(l + 2))
            + l * s_out * ug ** (l - 1)
        )
    return MultipoleCoefs(
        R_grid=r_grid, lm_labels=labels, phi=phi, dphi_dr=dphi,
        metadata={"type": "Multipole", "lmax": str(lmax),
                  "symmetry": symmetry, "n_particles": str(n)},
    )


def cylspline_grid(pos, R_grid=None, z_grid=None, mmax: int = 8,
                   n_phi: int | None = None):
    """The probe grid of :func:`fit_cylspline_from_particles`: (R_grid,
    z_grid, n_phi, points (nR * nz * n_phi, 3)), the defaults built from
    the (centred) particle positions ``pos``."""
    rc = np.hypot(pos[:, 0], pos[:, 1])
    if R_grid is None:
        R_max = np.percentile(rc, 99.5)
        if R_max <= 0:
            raise ValueError(
                "cannot auto-build R_grid: the 99.5th percentile of the "
                "particles' cylindrical radius is 0 (all particles on the "
                "z-axis); pass R_grid= explicitly")
        R_grid = np.concatenate([[0.0], np.geomspace(R_max * 2e-3, R_max,
                                                     24)])
    if z_grid is None:
        z_max = np.percentile(np.abs(pos[:, 2]), 99.5)
        if z_max <= 0:
            # razor-thin disc: span a thin but finite slab scaled to the
            # radial extent so the bicubic has a valid vertical axis
            z_max = 1e-3 * max(np.percentile(rc, 99.5), 1.0)
        zp = np.geomspace(z_max * 2e-3, z_max, 12)
        z_grid = np.concatenate([-zp[::-1], [0.0], zp])
    R_grid = np.asarray(R_grid, float)
    z_grid = np.asarray(z_grid, float)
    n_phi = n_phi or max(8, 4 * mmax)

    phis = 2.0 * np.pi * np.arange(n_phi) / n_phi
    rr, zz, pp = np.meshgrid(R_grid, z_grid, phis, indexing="ij")
    grid_pts = np.column_stack([
        (rr * np.cos(pp)).ravel(), (rr * np.sin(pp)).ravel(), zz.ravel(),
    ])
    return R_grid, z_grid, n_phi, grid_pts


def fit_cylspline_from_particles(pos, mass, R_grid=None, z_grid=None,
                                 mmax: int = 8, n_phi: int | None = None,
                                 softening: float = 0.0, center=None,
                                 G: float = G_DEFAULT,
                                 symmetry: str = "none",
                                 device="cuda") -> CylSplineCoefs:
    """CylSpline tables by direct summation on an (R, z, phi) grid.

    The grid potential is computed by the two-set potential kernel
    (``cuda_potential_2set``) on ``device`` — the card by default; pass
    ``device='cpu'`` for its plain torch version — and Fourier-analysed
    over the azimuthal ring.
    """
    import torch

    from ..ops.cuda_direct import cuda_potential_2set

    pos = np.asarray(pos, float)
    n = pos.shape[0]
    mass = np.broadcast_to(np.asarray(mass, float), (n,))
    if center is not None:
        pos = pos - np.asarray(center, float)

    R_grid, z_grid, n_phi, grid_pts = cylspline_grid(pos, R_grid, z_grid,
                                                     mmax, n_phi)

    # direct potential of all particles at the grid points.  The grid
    # nodes are massless probe points: their own softening is zero and
    # the pair rule h_eff = max(h_i, h_j) picks up the *source*
    # particles' softening alone
    device = resolve_device(device)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    phi_vals = cuda_potential_2set(
        dev(grid_pts), dev(np.zeros(len(grid_pts))), dev(pos),
        dev(mass * G), dev(np.full(n, softening)),
        "plummer" if softening > 0 else "newtonian", True,
    ).cpu().numpy().astype(float)

    phi_vals = phi_vals.reshape(len(R_grid), len(z_grid), n_phi)

    # Fourier analysis: Phi(phi) = sum_{m>=0} C_m cos(m phi)
    #                             + sum_{m>0} S_m sin(m phi)
    spec = np.fft.rfft(phi_vals, axis=2) / n_phi
    m_values = list(range(-mmax, mmax + 1))
    tables = []
    for m in m_values:
        am = abs(m)
        if am >= spec.shape[2]:
            tables.append(np.zeros((len(R_grid), len(z_grid))))
        elif m == 0:
            tables.append(spec[:, :, 0].real.copy())
        elif m > 0:
            # the rfft Nyquist bin (am == n_phi/2, even n_phi) is not
            # conjugate-paired: its cos coefficient is Re(spec) x 1
            fac = 1.0 if 2 * am == n_phi else 2.0
            tables.append(fac * spec[:, :, am].real)
        else:
            tables.append(-2.0 * spec[:, :, am].imag)
    if symmetry.lower() in ("axisymmetric", "axisym", "a"):
        m_values, tables = [0], [tables[mmax]]
    return CylSplineCoefs(
        R_grid=R_grid, z_grid=z_grid, m_values=m_values,
        phi=np.stack(tables),
        metadata={"type": "CylSpline", "mmax": str(mmax),
                  "symmetry": symmetry, "n_particles": str(n)},
    )


def fit_potential(particles: dict, lmax: int = 8, mmax_cyl: int = 8,
                  symmetry: str = "none",
                  mult_species=("dark", "hot_gas"),
                  cylspl_species=("star", "cold_gas", "gas"),
                  center=None, rotation=None,
                  subsample_factor: float = 1.0, seed: int = 0,
                  G: float = G_DEFAULT,
                  cold_temp_log10_thresh: float = 4.5, device="cuda",
                  **kwargs):
    """Fit a composite BFE potential from a particle snapshot.

    ``particles``: {species: (pos (N,3), mass (N,) or float)}, or the
    reference's FIRE-style nested form produced by
    :func:`create_snapshot_dict` ({species: {"host.distance": pos,
    "mass": mass[, "temperature": T]}}) — nested gas with temperatures
    splits into hot (-> Multipole) / cold (-> CylSpline) components at
    ``log10 T = cold_temp_log10_thresh``.  The reference kwarg aliases
    ``sym=`` (-> symmetry) and ``pole_l=`` (-> lmax) are accepted.
    Extended (spheroidal) components fit a Multipole, disky components a
    CylSpline (the Arora+2022 split, reference: _fit.py:133-420).

    ``rotation``: optional (3, 3) matrix applied to positions after the
    ``center`` shift (disk-plane alignment, reference ``rotation=``);
    ``subsample_factor`` < 1 fits a random subset with masses reweighted
    by 1/f (reference ``subsample_factor``).  ``device``: where the
    CylSpline grid is summed and the combined evaluator is built — the
    card unless the caller passes ``device='cpu'``.  Other keywords go to
    :func:`fit_cylspline_from_particles`.

    Returns {'multipole': MultipoleCoefs | None,
             'cylspline': CylSplineCoefs | None,
             'potential': the combined evaluator}.
    """
    if "sym" in kwargs:
        symmetry = kwargs.pop("sym")
        if isinstance(symmetry, (list, tuple)):
            if len(symmetry) != 1:
                raise ValueError(
                    "the reference's multi-symmetry sym=[...] form fits "
                    "one file per symmetry; call fit_potential once per "
                    "symmetry here")
            symmetry = symmetry[0]
    if "pole_l" in kwargs:
        lmax = kwargs.pop("pole_l")
        if isinstance(lmax, (list, tuple)):
            if len(lmax) != 1:
                raise ValueError(
                    "the reference's multi-order pole_l=[...] form fits "
                    "one file per order; call fit_potential once per "
                    "order here")
            lmax = int(lmax[0])
    device = resolve_device(device)
    particles = _normalise_particles(particles, cold_temp_log10_thresh)
    if rotation is not None:
        rotation = np.asarray(rotation, float)
        if rotation.shape != (3, 3):
            raise ValueError(f"rotation must be (3, 3), got "
                             f"{rotation.shape}")
    if not 0.0 < subsample_factor <= 1.0:
        raise ValueError("subsample_factor must be in (0, 1]")
    rng = np.random.default_rng(seed)

    def prep(pos, mass):
        pos = np.asarray(pos, float)
        mass = np.broadcast_to(np.asarray(mass, float),
                               (pos.shape[0],)).copy()
        if center is not None:
            pos = pos - np.asarray(center, float)
        if rotation is not None:
            pos = pos @ rotation.T
        if subsample_factor < 1.0:
            k = max(1, int(round(pos.shape[0] * subsample_factor)))
            sel = rng.choice(pos.shape[0], size=k, replace=False)
            pos = pos[sel]
            mass = mass[sel] / subsample_factor   # conserve total mass
        return pos, mass

    mult_pos, mult_m = [], []
    cyl_pos, cyl_m = [], []
    for name, (pos, mass) in particles.items():
        if name in cylspl_species:
            dest_pos, dest_m = cyl_pos, cyl_m
        elif name in mult_species:
            dest_pos, dest_m = mult_pos, mult_m
        else:
            # neither list claims it: excluding mass silently would be
            # worse than the (reference-matching) default of Multipole,
            # but routing a species the caller explicitly listed
            # elsewhere must not happen by accident
            import warnings

            warnings.warn(
                f"species {name!r} is in neither mult_species nor "
                "cylspl_species; folding it into the Multipole component",
                stacklevel=2)
            dest_pos, dest_m = mult_pos, mult_m
        pos, mass = prep(pos, mass)
        dest_pos.append(pos)
        dest_m.append(mass)

    out = {"multipole": None, "cylspline": None}
    pots = []
    if mult_pos:
        coefs = fit_multipole_from_particles(
            np.concatenate(mult_pos), np.concatenate(mult_m),
            lmax=lmax, symmetry=symmetry, G=G)
        out["multipole"] = coefs
        from .multipole import MultipolePotential

        pots.append(MultipolePotential(coefs))
    if cyl_pos:
        coefs = fit_cylspline_from_particles(
            np.concatenate(cyl_pos), np.concatenate(cyl_m),
            mmax=mmax_cyl, G=G, symmetry=symmetry, device=device,
            **kwargs)
        out["cylspline"] = coefs
        from .cylspline import CylSplinePotential

        pots.append(CylSplinePotential(coefs))
    out["potential"] = sum(pots).to(device) if pots else None
    return out
