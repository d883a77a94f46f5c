"""Plotting helpers (reference: viz/plots.py:110-916).

matplotlib wrappers over the SPH renderer and the stream coordinate
machinery.  Mollweide sky maps use matplotlib's built-in projection (the
reference requires healpy, which is not needed here).  matplotlib is
imported inside the functions only; ``plot_density(method='sph',
arch=...)`` passes ``arch`` on to the renderer ('auto' is the card).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "plot_density",
    "plot_mollweide",
    "plot_stream_sky",
    "plot_stream_evolution",
]


def _get_axis(ax=None, **subplot_kw):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(**subplot_kw)
    return ax


_AXIS_INDEX = {"x": 0, "y": 1, "z": 2}


def plot_density(pos=None, mass=1.0, method: str = "sph", npix: int = 256,
                 extent=None, axes=(0, 1), z_slice=None, log: bool = True,
                 cmap: str = "magma", scale_bar: float | None = None,
                 colorbar: bool = True, ax=None, vmin=None, vmax=None,
                 **render_kwargs):
    """Projected density image (methods: 'sph', 'histogram',
    'gauss_smooth').  Returns (ax, image_array).

    Reference kwarg aliases (viz/plots.py:110-133) are accepted:
    ``snap=``/``spec=`` (a ParticleReader snapshot dict + species key),
    ``gridsize=`` (-> extent), ``resolution=`` (-> npix),
    ``xval=``/``yval=`` ('x'/'y'/'z' -> axes; the reference defaults to
    an x-z projection only when *both* are given), ``slice_width=``/
    ``slice_axis=`` (-> z_slice on that axis), ``scale_size=``
    (-> scale_bar), ``smooth_sigma=`` (gauss_smooth sigma) and
    ``return_dens=`` (ignored: the image array is always returned).
    """
    snap = render_kwargs.pop("snap", None)
    spec = render_kwargs.pop("spec", "dark")
    if snap is not None:
        if pos is not None:
            raise ValueError("pass either pos= or snap=, not both")
        try:
            if hasattr(snap, "__getitem__"):
                part = snap[spec]
            elif hasattr(snap, spec):
                part = getattr(snap, spec)
            else:                  # our read_snapshot: .species dict
                part = snap.species[spec]
        except (KeyError, AttributeError):
            raise ValueError(
                f"snap has no species {spec!r}; pass pos/mass directly "
                "or check the species name") from None
        pos = np.asarray(part["posvel"], float)[:, :3]
        mass = np.asarray(part["mass"], float)
    if pos is None:
        raise ValueError("plot_density needs pos= (or snap=)")
    if "gridsize" in render_kwargs:
        extent = float(render_kwargs.pop("gridsize")) / 2.0
    if "resolution" in render_kwargs:
        npix = int(render_kwargs.pop("resolution"))
    if "xval" in render_kwargs or "yval" in render_kwargs:
        axes = (_AXIS_INDEX[render_kwargs.pop("xval", "x")],
                _AXIS_INDEX[render_kwargs.pop("yval", "z")])
        if axes[0] == axes[1]:
            raise ValueError("xval and yval must differ")
    slice_width = render_kwargs.pop("slice_width", 0.0)
    slice_axis = render_kwargs.pop("slice_axis", None)
    if slice_width and z_slice is None:
        if slice_axis is not None and _AXIS_INDEX[slice_axis] in axes:
            raise ValueError(
                f"slice_axis {slice_axis!r} is a projected axis")
        z_slice = float(slice_width)
    if "scale_size" in render_kwargs:
        scale_size = render_kwargs.pop("scale_size")
        if scale_size:
            scale_bar = scale_size
    if "smooth_sigma" in render_kwargs:
        render_kwargs["sigma"] = float(render_kwargs.pop("smooth_sigma"))
    density_kind = render_kwargs.pop("density_kind", "surface")
    if density_kind not in ("surface", "volume"):
        raise ValueError(f"unknown density_kind {density_kind!r}")
    if density_kind == "volume" and not (slice_width or z_slice):
        raise ValueError("density_kind='volume' requires slice_width")
    render_kwargs.pop("return_dens", None)
    pos = np.asarray(pos, float)
    n = pos.shape[0]
    mass = np.broadcast_to(np.asarray(mass, float), (n,))
    if z_slice is not None:
        k = next(a for a in (0, 1, 2) if a not in axes)
        sel = np.abs(pos[:, k]) <= z_slice
        pos, mass = pos[sel], mass[sel]

    i, j = axes
    if extent is None:
        lim = np.percentile(
            np.abs(pos[:, [i, j]]), 99.0) * 1.2
        extent = (-lim, lim, -lim, lim)
    elif np.isscalar(extent):
        extent = (-extent, extent, -extent, extent)

    if method == "sph":
        from .sph import render_surface_density

        img, extent = render_surface_density(pos, mass, extent=extent,
                                             npix=npix, axes=axes,
                                             **render_kwargs)
    elif method in ("histogram", "gauss_smooth"):
        img, xe, ye = np.histogram2d(
            pos[:, i], pos[:, j], bins=npix,
            range=[extent[:2], extent[2:]], weights=mass)
        area = (xe[1] - xe[0]) * (ye[1] - ye[0])
        img = img.T / area
        if method == "gauss_smooth":
            from scipy.ndimage import gaussian_filter

            img = gaussian_filter(img, sigma=render_kwargs.get("sigma", 1.5))
    else:
        raise ValueError(f"unknown density method {method!r}")

    if density_kind == "volume":
        # M/kpc^2 -> M/kpc^3 over the +-z_slice slab (reference
        # viz/plots.py density_kind='volume': divide by 2*slice_width)
        img = img / (2.0 * z_slice)

    ax = _get_axis(ax)
    shown = np.log10(np.maximum(img, img[img > 0].min() if (img > 0).any()
                                else 1e-30)) if log else img
    im = ax.imshow(shown, origin="lower", extent=extent, cmap=cmap,
                   vmin=vmin, vmax=vmax, aspect="equal")
    labels = "xyz"
    ax.set_xlabel(f"{labels[i]} [kpc]")
    ax.set_ylabel(f"{labels[j]} [kpc]")
    if colorbar:
        import matplotlib.pyplot as plt

        plt.colorbar(im, ax=ax,
                     label=(r"$\log_{10}\,\Sigma$ [M$_\odot$/kpc$^2$]"
                            if log else r"$\Sigma$"))
    if scale_bar:
        x0 = extent[0] + 0.1 * (extent[1] - extent[0])
        y0 = extent[2] + 0.08 * (extent[3] - extent[2])
        ax.plot([x0, x0 + scale_bar], [y0, y0], color="w", lw=2)
        ax.text(x0 + scale_bar / 2, y0, f" {scale_bar:g} kpc",
                color="w", va="bottom", ha="center")
    return ax, img


def plot_mollweide(pos, weights=None, initial_nside: int = 60, ax=None,
                   cmap: str = "magma", log: bool = True,
                   log_scale: bool | None = None, normalize: bool = False,
                   filter_radius=(0, 0), smooth_fwhm_deg=None,
                   density_threshold: float = 1e5, add_traj=None,
                   add_end_pt: bool = False, add_traj_dist: bool = False,
                   return_map: bool = False,
                   nside_bins: int | None = None, verbose: bool = False):
    """All-sky Mollweide map of a 3-D particle field on a native HEALPix
    (ring-scheme) pixelisation — no healpy needed.

    Mirrors the reference's healpy-based version (reference:
    viz/plots.py:433-617): per-pixel surface density [weight/deg^2],
    dynamic nside upscaling above ``density_threshold`` particles,
    ``filter_radius`` as either (radius, tol) shell or (rmin, rmax)
    range, log scaling, median ``normalize``, Gaussian smoothing
    (default FWHM = 3 sqrt(pixel area)), and optional trajectory
    overlay.  Smoothing is done in lon/lat image space with a
    per-row 1/cos(lat) longitude width (a flat-sky approximation of
    healpy's harmonic smoothing, accurate away from the poles).

    Returns (ax, smoothed HEALPix map (npix,)).
    """
    del add_traj_dist       # declared-but-unused in the reference too
    from scipy.ndimage import gaussian_filter1d

    from .healpix import (ang2pix_ring, healpix_map, nside2npix,
                          pix2ang_ring)

    if log_scale is not None:      # reference kwarg name
        log = log_scale
    if nside_bins is not None:     # pre-HEALPix alias for the resolution
        initial_nside = int(nside_bins)
    # return_map accepted for reference compatibility: the smoothed map
    # is always returned (alongside the axis, which the reference's
    # healpy version never exposed)
    del return_map
    pos = np.asarray(pos, float)
    weights = None if weights is None else np.asarray(weights, float)

    fr = tuple(filter_radius)
    if fr[0] > 0 and fr[1] > 0 and fr[0] >= fr[1]:     # (radius, tol) shell
        d = np.linalg.norm(pos, axis=1)
        mask = np.isclose(d, fr[0], atol=fr[1])
    elif fr[0] >= 0 and fr[1] > fr[0]:                 # (rmin, rmax)
        d = np.linalg.norm(pos, axis=1)
        mask = (d >= fr[0]) & (d <= fr[1])
    else:
        if fr[0] > 0 and fr[1] == 0:
            import warnings

            warnings.warn(
                f"filter_radius={fr} matches neither the (radius, tol) "
                "shell form nor the (rmin, rmax) range form — no filter "
                "applied (reference-compatible behaviour); give a "
                "nonzero tolerance for a shell", stacklevel=2)
        mask = slice(None)
    pos = pos[mask]
    if weights is not None:
        weights = weights[mask]

    nside = int(initial_nside)
    if pos.shape[0] > density_threshold:
        nside = min(512, int(initial_nside
                             * (pos.shape[0] / density_threshold) ** 0.5))
        if verbose:
            print(f"dynamic nside: {nside}")

    sky = healpix_map(nside, pos, weights=weights)
    area_deg2 = 4.0 * np.pi * (180.0 / np.pi) ** 2 / nside2npix(nside)
    sky = sky / area_deg2
    filled = sky > 0
    if log:
        # empty pixels must land BELOW the dimmest filled pixel, not at
        # 0.0: with per-pixel densities < 1/deg^2 the filled log values
        # are negative and a 0.0 background would render brighter than
        # the signal (and the smoothing would blend fake zeros into it)
        if filled.any():
            vals = np.log10(sky[filled])
            sky = np.full_like(sky, vals.min())
            sky[filled] = vals
    if normalize and filled.any():
        med = np.median(sky[filled])
        if log:
            # log-domain normalisation is a subtraction; dividing by a
            # (possibly zero or negative) log-median inverts the map
            sky = sky - med
        else:
            sky = sky / med - 1

    # project to a lon/lat image, smooth, and resample back to pixels
    n_lat = max(4 * nside, 180)
    lat_c = np.linspace(-np.pi / 2, np.pi / 2, n_lat + 1)[:-1] \
        + np.pi / (2 * n_lat)
    lon_c = np.linspace(-np.pi, np.pi, 2 * n_lat + 1)[:-1] \
        + np.pi / (2 * n_lat)
    LON, LAT = np.meshgrid(lon_c, lat_c)
    img = sky[ang2pix_ring(nside, np.pi / 2 - LAT,
                           np.mod(LON, 2 * np.pi))]
    if smooth_fwhm_deg is None:
        fwhm_rad = 3.0 * np.sqrt(4.0 * np.pi / nside2npix(nside))
    else:
        fwhm_rad = np.radians(float(smooth_fwhm_deg))
    sig_pix = fwhm_rad / 2.355 / (np.pi / n_lat)
    if sig_pix > 0.05:
        for i, la in enumerate(lat_c):     # wrap in lon, width ~ 1/cos(lat)
            s = sig_pix / max(np.cos(la), 0.05)
            img[i] = gaussian_filter1d(img[i], s, mode="wrap")
        img = gaussian_filter1d(img, sig_pix, axis=0, mode="nearest")

    ax = _get_axis(ax, subplot_kw={"projection": "mollweide"})
    ax.pcolormesh(lon_c, lat_c, img, cmap=cmap, rasterized=True)
    ax.grid(True, alpha=0.3)

    if add_traj is not None and len(add_traj) > 0:
        tr = np.asarray(add_traj, float)
        lon_t = np.arctan2(tr[:, 1], tr[:, 0])
        lat_t = np.arcsin(np.clip(
            tr[:, 2] / (np.linalg.norm(tr, axis=1) + 1e-300), -1, 1))
        ax.plot(lon_t, lat_t, c="lime", ls="--", lw=1)
        if add_end_pt:
            ax.plot(lon_t[-1], lat_t[-1], marker="*", c="lime", ms=10)

    # smoothed map resampled back onto HEALPix pixels (what the
    # reference's return_map=True hands back)
    th_p, ph_p = pix2ang_ring(nside, np.arange(nside2npix(nside)))
    ii = np.clip(((np.pi / 2 - th_p + np.pi / 2)
                  / np.pi * n_lat).astype(int), 0, n_lat - 1)
    jj = np.clip(((np.mod(ph_p + np.pi, 2 * np.pi))
                  / (2 * np.pi) * 2 * n_lat).astype(int), 0, 2 * n_lat - 1)
    sky_smoothed = img[ii, jj]
    return ax, sky_smoothed


def plot_stream_sky(xv, xv_prog=None, ax=None, s: float = 1.0,
                    color_by: str | None = "dist", degrees: bool = True,
                    **scatter_kw):
    """Stream in its (phi1, phi2) frame.  Returns (ax, observables dict)."""
    from ..coords import get_observed_stream_coords

    obs = get_observed_stream_coords(np.asarray(xv, float), xv_prog,
                                     degrees=degrees)
    ax = _get_axis(ax)
    c = obs.get(color_by) if color_by else None
    sc = ax.scatter(obs["phi1"], obs["phi2"], s=s, c=c, **scatter_kw)
    if color_by:
        import matplotlib.pyplot as plt

        plt.colorbar(sc, ax=ax, label=color_by)
    unit = "deg" if degrees else "rad"
    ax.set_xlabel(rf"$\phi_1$ [{unit}]")
    ax.set_ylabel(rf"$\phi_2$ [{unit}]")
    return ax, obs


def plot_stream_evolution(part_xv, times, n_panels: int = 4,
                          axes=(0, 1), mass=1.0, npix: int = 200,
                          method: str = "histogram", **kwargs):
    """Multi-panel evolution of a stream (part_xv: (T, N, 6) or
    (N, T, 6)).  Returns (fig, axes array)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    part_xv = np.asarray(part_xv, float)
    times = np.asarray(times, float)
    if part_xv.shape[0] != len(times) and part_xv.shape[1] == len(times):
        part_xv = np.transpose(part_xv, (1, 0, 2))
    if part_xv.shape[0] != len(times):
        raise ValueError(
            f"part_xv shape {part_xv.shape} matches times of length "
            f"{len(times)} on neither axis — check for an off-by-one "
            "snapshot list (panels would be mislabelled or index out of "
            "bounds)")
    n_t = part_xv.shape[0]
    sel = np.linspace(0, n_t - 1, min(n_panels, n_t)).round().astype(int)

    fig, axs = plt.subplots(1, len(sel),
                            figsize=(4 * len(sel), 4), squeeze=False)
    for ax, k in zip(axs[0], sel):
        xv_k = part_xv[k]
        good = np.isfinite(xv_k).all(axis=1)
        m_k = mass
        if np.ndim(mass) == 1 and len(mass) == len(xv_k):
            m_k = np.asarray(mass)[good]    # keep mass aligned with rows
        if good.any():
            plot_density(xv_k[good], m_k, method=method, npix=npix,
                         axes=axes, ax=ax, colorbar=False, **kwargs)
        ax.set_title(f"t = {times[k]:.3f}")
    fig.tight_layout()
    return fig, axs[0]
