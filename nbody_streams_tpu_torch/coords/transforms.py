"""Coordinate and vector-field transforms (reference: coords/transforms.py).

Conventions (identical to the reference):
* spherical: (rho, theta, phi) with theta = colatitude from +z and
  phi in [0, 2 pi) (``mollweide=True`` maps phi to (-pi, pi] for healpy),
* cylindrical: (R, phi, z),
* NaNs propagate row-wise.
"""
from __future__ import annotations

import numpy as np

__all__ = ["convert_coords", "convert_vectors", "convert_to_vel_los"]

_SYSTEMS = ("cart", "sph", "cyl")


def _as_rows(arr):
    """Flatten (..., 3) to (M, 3); returns (rows, lead_shape)."""
    arr = np.asarray(arr, float)
    if arr.ndim == 0 or arr.shape[-1] != 3:
        raise ValueError(f"expected (..., 3), got {arr.shape}")
    return arr.reshape(-1, 3), arr.shape[:-1]


def _nan_rows(inp, out):
    bad = ~np.isfinite(inp).all(axis=-1)
    out[bad] = np.nan
    return out


def _to_cart(coords, system, mollweide):
    if system == "cart":
        return coords.copy()
    if system == "sph":
        rho, th, ph = coords[:, 0], coords[:, 1], coords[:, 2]
        if mollweide:
            ph = np.where(ph < 0, ph + 2 * np.pi, ph)
        st = np.sin(th)
        return np.column_stack([rho * st * np.cos(ph),
                                rho * st * np.sin(ph),
                                rho * np.cos(th)])
    # cyl
    r, ph, z = coords[:, 0], coords[:, 1], coords[:, 2]
    return np.column_stack([r * np.cos(ph), r * np.sin(ph), z])


def _from_cart(xyz, system, mollweide):
    if system == "cart":
        return xyz.copy()
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    phi = np.mod(np.arctan2(y, x), 2 * np.pi)
    if system == "sph":
        rxy = np.hypot(x, y)
        if mollweide:
            phi = np.where(phi > np.pi, phi - 2 * np.pi, phi)
        return np.column_stack([np.sqrt(rxy**2 + z**2),
                                np.arctan2(rxy, z), phi])
    return np.column_stack([np.hypot(x, y), phi, z])


def convert_coords(coords=None, from_sys: str = None, to_sys: str = None,
                   mollweide: bool = False, *, data=None):
    """Convert points between 'cart', 'sph' and 'cyl' systems
    (``data=`` is the reference keyword name for the first argument,
    reference coords/transforms.py:152)."""
    if data is not None:
        if coords is not None:
            raise TypeError("pass either coords or data, not both")
        coords = data
    if from_sys not in _SYSTEMS or to_sys not in _SYSTEMS:
        raise ValueError(
            f"coordinate systems must be one of {_SYSTEMS}, got "
            f"{from_sys!r} -> {to_sys!r}"
        )
    arr, lead = _as_rows(coords)
    if from_sys == to_sys:
        out = arr.copy()
    else:
        out = _from_cart(_to_cart(arr, from_sys, mollweide), to_sys,
                         mollweide)
    out = _nan_rows(arr, out)
    return out.reshape(lead + (3,))


def _sph_basis(theta, phi):
    """Rows: (r-hat, theta-hat, phi-hat) as (N, 3, 3)."""
    st, ct = np.sin(theta), np.cos(theta)
    sp, cp = np.sin(phi), np.cos(phi)
    basis = np.empty((len(theta), 3, 3))
    basis[:, 0] = np.column_stack([st * cp, st * sp, ct])
    basis[:, 1] = np.column_stack([ct * cp, ct * sp, -st])
    basis[:, 2] = np.column_stack([-sp, cp, np.zeros_like(sp)])
    return basis


def _cyl_basis(phi):
    """Rows: (R-hat, phi-hat, z-hat) as (N, 3, 3)."""
    sp, cp = np.sin(phi), np.cos(phi)
    basis = np.zeros((len(phi), 3, 3))
    basis[:, 0] = np.column_stack([cp, sp, np.zeros_like(sp)])
    basis[:, 1] = np.column_stack([-sp, cp, np.zeros_like(sp)])
    basis[:, 2, 2] = 1.0
    return basis


def convert_vectors(*args, vectors=None, positions=None,
                    from_sys: str | None = None, to_sys: str | None = None,
                    position_system: str = "cart",
                    mollweide: bool = False, pos=None, vec=None):
    """Rotate a vector field between coordinate bases — two call forms.

    Reference form (the positional contract, reference
    coords/transforms.py:265): ``convert_vectors(pos, vec, from_sys,
    to_sys)`` with ``pos`` and ``vec`` both in the *source* system;
    returns the tuple ``(pos_new, vec_new)`` in the target system.

    Native form (keywords ``vectors=``/``positions=``): converts only
    the vector components; ``positions`` are given in
    ``position_system`` coordinates and only the rotated vectors are
    returned.  Components: cart (vx, vy, vz); sph (v_r, v_theta,
    v_phi); cyl (v_R, v_phi, v_z).
    """
    if vectors is None and positions is None:
        # reference form: (pos, vec, from_sys, to_sys) positionally
        # and/or by the reference keyword names
        ref = list(args) + [None] * (4 - len(args))
        pos = ref[0] if pos is None else pos
        vec = ref[1] if vec is None else vec
        from_sys = ref[2] if from_sys is None else from_sys
        to_sys = ref[3] if to_sys is None else to_sys
        if pos is None or vec is None or from_sys is None \
                or to_sys is None:
            raise TypeError(
                "convert_vectors needs (pos, vec, from_sys, to_sys) "
                "(reference form) or vectors=/positions=/from_sys=/"
                "to_sys= (native form)")
        vec_new = _convert_vectors_native(vec, pos, from_sys, to_sys,
                                          position_system=from_sys,
                                          mollweide=mollweide)
        return convert_coords(pos, from_sys, to_sys,
                              mollweide=mollweide), vec_new
    # native form: remaining positionals are (from_sys, to_sys)
    if pos is not None or vec is not None:
        raise TypeError("pass either the reference (pos/vec) or the "
                        "native (vectors/positions) names, not both")
    strs = [a for a in args if isinstance(a, str)]
    if strs:
        if from_sys is None and len(strs) >= 1:
            from_sys = strs[0]
        if to_sys is None and len(strs) >= 2:
            to_sys = strs[1]
    return _convert_vectors_native(vectors, positions, from_sys, to_sys,
                                   position_system=position_system,
                                   mollweide=mollweide)


def _convert_vectors_native(vectors, positions, from_sys: str,
                            to_sys: str, position_system: str = "cart",
                            mollweide: bool = False):
    if from_sys not in _SYSTEMS or to_sys not in _SYSTEMS:
        raise ValueError(
            f"vector systems must be one of {_SYSTEMS}, got "
            f"{from_sys!r} -> {to_sys!r}"
        )
    vec, lead = _as_rows(vectors)
    pos, plead = _as_rows(positions)
    if plead != lead:
        raise ValueError(
            f"positions shape {plead + (3,)} does not match vectors "
            f"shape {lead + (3,)}")
    xyz = _to_cart(pos, position_system, mollweide)
    sph = _from_cart(xyz, "sph", False)
    theta, phi = sph[:, 1], sph[:, 2]

    def basis(system):
        if system == "cart":
            return np.broadcast_to(np.eye(3), (len(xyz), 3, 3))
        if system == "sph":
            return _sph_basis(theta, phi)
        return _cyl_basis(phi)

    v_cart = np.einsum("nij,ni->nj", basis(from_sys), vec) \
        if from_sys != "cart" else vec
    out = np.einsum("nij,nj->ni", basis(to_sys), v_cart) \
        if to_sys != "cart" else np.array(v_cart, copy=True)
    # NaN propagation over BOTH inputs: a NaN position corrupts the
    # basis even when the output basis happens not to use that
    # coordinate, so the whole row must go NaN
    out = _nan_rows(np.concatenate([vec, pos], axis=1),
                    np.asarray(out, float))
    return out.reshape(lead + (3,))


def convert_to_vel_los(positions, velocities=None, observer=None, *,
                       reference_xv=None):
    """Line-of-sight velocity relative to an observer (default origin).

    The reference call form (reference coords/transforms.py:369:
    ``convert_to_vel_los(xv, reference_xv=None)`` with a single
    phase-space array of trailing dimension 6, optionally minus a
    broadcastable reference) is detected by the (..., 6) first argument
    and returns a scalar for (6,) input.
    """
    first = np.asarray(positions, float)
    if first.shape[-1] == 6:
        if velocities is not None and reference_xv is None:
            reference_xv = velocities
        xv = first
        if reference_xv is not None:
            xv = xv - np.asarray(reference_xv, float)
        r = np.linalg.norm(xv[..., :3], axis=-1)
        los = np.sum(xv[..., :3] * xv[..., 3:6], axis=-1) \
            / np.maximum(r, 1e-30)
        return float(los) if los.ndim == 0 else los
    pos, lead = _as_rows(positions)
    vel, _ = _as_rows(velocities)
    if observer is not None:
        obs = np.asarray(observer, float)
        pos = pos - obs[:3]
        if obs.size >= 6:
            vel = vel - obs[3:6]
    r = np.linalg.norm(pos, axis=1)
    los = np.sum(pos * vel, axis=1) / np.maximum(r, 1e-30)
    return los.reshape(lead) if lead else los[0]
