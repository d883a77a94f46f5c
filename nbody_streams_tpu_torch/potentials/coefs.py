"""Basis-function-expansion coefficient containers and parsers.

File-format compatible with Agama / the reference framework
(reference: agama_helper/_coefs.py — MultipoleCoefs :126, CylSplineCoefs
:326, parsers :430/:523, auto-detect :619): plain-text ``.coef_mult`` /
``.coef_cylsp`` files, HDF5 archives, or raw strings.

Conventions (documented in the reference CUDA kernel header,
_multipole_potential_kernel.cu:1-46): real spherical harmonics with
orthonormalised associated Legendre functions and angular multiplier
2*sqrt(pi) (m=0) / 2*sqrt(2*pi) (m!=0); cos modes m>=0, sin modes m<0;
so the l=0,m=0 column is the spherical average of Phi.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

__all__ = [
    "MultipoleCoefs",
    "CylSplineCoefs",
    "read_mult_coefs",
    "read_cylspl_coefs",
    "read_coefs",
    "generate_lmax_pairs",
]


def generate_lmax_pairs(lmax: int, mmax: int | None = None):
    """All (l, m) pairs up to lmax in Agama column order."""
    mmax = lmax if mmax is None else mmax
    out = []
    for l in range(lmax + 1):
        for m in range(-min(l, mmax), min(l, mmax) + 1):
            out.append((l, m))
    return out


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------

@dataclass
class MultipoleCoefs:
    """Spherical-harmonic BFE: Phi_lm(r) tables on a radial grid.

    R_grid (nR,), lm_labels [(l, m)], phi (nR, n_lm),
    dphi_dr (nR, n_lm) or None, metadata dict.
    """

    R_grid: np.ndarray
    lm_labels: list
    phi: np.ndarray
    dphi_dr: np.ndarray | None = None
    metadata: dict = field(default_factory=dict)

    @property
    def lmax(self) -> int:
        return max((l for l, _ in self.lm_labels), default=0)

    @property
    def l_values(self):
        return sorted({l for l, _ in self.lm_labels})

    @property
    def m_values(self):
        return sorted({m for _, m in self.lm_labels})

    def radial_power(self, l: int,
                     use_quadrature: bool = True) -> np.ndarray:
        """Per-radius power of one harmonic order: sum_m Phi_lm(r)^2,
        or sum_m |Phi_lm(r)| with ``use_quadrature=False`` (reference
        _coefs.py:171)."""
        cols = [i for i, (ll, _) in enumerate(self.lm_labels) if ll == l]
        if not cols:
            return np.zeros(self.R_grid.shape)
        block = self.phi[:, cols]
        return ((block ** 2).sum(axis=1) if use_quadrature
                else np.abs(block).sum(axis=1))

    def total_power(self, l: int | None = None,
                    use_quadrature: bool = True):
        """``total_power(l)`` -> float (reference contract,
        _coefs.py:194); ``total_power()`` -> the native {l: power(r)}
        dict over every order present."""
        if l is not None:
            return float(self.radial_power(l, use_quadrature).sum())
        return {ll: self.radial_power(ll, use_quadrature)
                for ll in self.l_values}

    def zeroed(self, keep_lm,
               include_negative: bool = True) -> "MultipoleCoefs":
        """Copy with all harmonics except ``keep_lm`` zeroed out.

        Reference semantics (_coefs.py:213): a bare int ``l`` keeps
        every (l, m) present for that order, and negative-m
        counterparts are auto-added (disable with
        ``include_negative=False`` for exact-pair control).
        """
        keep = set()
        for item in keep_lm:
            if isinstance(item, (int, np.integer)):
                keep.update(tuple(lm) for lm in self.lm_labels
                            if lm[0] == int(item))
            else:
                keep.add(tuple(item))
        if include_negative:
            keep |= {(l, -m) for l, m in keep}
        phi = self.phi.copy()
        dphi = None if self.dphi_dr is None else self.dphi_dr.copy()
        for i, lm in enumerate(self.lm_labels):
            if tuple(lm) not in keep:
                phi[:, i] = 0.0
                if dphi is not None:
                    dphi[:, i] = 0.0
        return MultipoleCoefs(self.R_grid.copy(), list(self.lm_labels), phi,
                              dphi, dict(self.metadata))

    def to_coef_string(self) -> str:
        """Serialise to the Agama .coef_mult text format (lossless)."""
        meta = dict(self.metadata)
        meta.setdefault("type", "Multipole")
        meta["gridSizeR"] = str(len(self.R_grid))
        meta.setdefault("lmax", str(self.lmax))
        meta.setdefault("symmetry", "None")
        lines = ["[Potential]"]
        for k in ("type", "gridSizeR", "lmax", "symmetry"):
            lines.append(f"{k}={meta[k]}")
        lines.append("Coefficients")

        def section(name, data):
            lines.append(name)
            header = "#radius\t" + "\t".join(
                f"l={l},m={m}" for l, m in self.lm_labels
            )
            lines.append(header)
            for r, row in zip(self.R_grid, data):
                lines.append(
                    f"{r:.17g}\t" + "\t".join(f"{v:.17g}" for v in row)
                )

        section("#Phi", self.phi)
        if self.dphi_dr is not None:
            lines.append("")
            section("#dPhi/dr", self.dphi_dr)
        return "\n".join(lines) + "\n"


@dataclass
class CylSplineCoefs:
    """Azimuthal-harmonic 2-D BFE: per-m Phi_m(R, z) tables.

    R_grid (nR,), z_grid (nz,), m_values [m...],
    phi (n_m, nR, nz) — R varies along rows, z along columns, matching the
    Agama text layout ('#R(row)\\z(col)').  metadata dict.
    """

    R_grid: np.ndarray
    z_grid: np.ndarray
    m_values: list
    phi: np.ndarray
    metadata: dict = field(default_factory=dict)

    @property
    def mmax(self) -> int:
        return max((abs(m) for m in self.m_values), default=0)

    def zeroed(self, keep_m,
               include_negative: bool = True) -> "CylSplineCoefs":
        """Copy keeping only azimuthal orders ``keep_m`` (negative-m
        counterparts auto-added unless ``include_negative=False``;
        reference _coefs.py:356)."""
        keep = set(int(m) for m in keep_m)
        if include_negative:
            keep |= {-m for m in keep if m != 0}
        phi = self.phi.copy()
        for i, m in enumerate(self.m_values):
            if m not in keep:
                phi[i] = 0.0
        return CylSplineCoefs(self.R_grid.copy(), self.z_grid.copy(),
                              list(self.m_values), phi, dict(self.metadata))

    def to_coef_string(self) -> str:
        meta = dict(self.metadata)
        meta.setdefault("type", "CylSpline")
        meta["gridSizeR"] = str(len(self.R_grid))
        meta["gridSizez"] = str(len(self.z_grid))
        meta.setdefault("mmax", str(self.mmax))
        meta.setdefault("symmetry", "None")
        lines = ["[Potential]"]
        for k in ("type", "gridSizeR", "gridSizez", "mmax", "symmetry"):
            lines.append(f"{k}={meta[k]}")
        lines.append("Coefficients")
        lines.append("#Phi")
        for i, m in enumerate(self.m_values):
            lines.append(f"{m}\t#m")
            lines.append("#R(row)\\z(col)\t" + "\t".join(
                f"{z:.13g}" for z in self.z_grid))
            for j, r in enumerate(self.R_grid):
                lines.append(f"{r:.17g}\t" + "\t".join(
                    f"{v:.17g}" for v in self.phi[i, j]))
            lines.append("")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Parsers
# ---------------------------------------------------------------------------

def _source_to_lines(source, group_name, dataset_name):
    """Accept a file path, HDF5 archive path, or raw text content."""
    if isinstance(source, Path) or (
        isinstance(source, str) and "\n" not in source
        and len(source) < 4096 and Path(source).exists()
    ):
        path = Path(source)
        if path.suffix.lower() in (".h5", ".hdf5"):
            import h5py

            with h5py.File(path, "r") as f:
                raw = f[group_name][dataset_name][()]
            text = raw.decode() if isinstance(raw, bytes) else str(raw)
            return text.splitlines()
        return path.read_text().splitlines()
    return str(source).splitlines()


def _parse_meta(lines):
    meta = {}
    for line in lines:
        s = line.strip()
        if s == "Coefficients":
            break
        if "=" in s and not s.startswith("[") and not s.startswith("#"):
            k, _, v = s.partition("=")
            meta[k.strip()] = v.strip()
    return meta


def read_mult_coefs(source, group_name: str = "snap_000",
                    dataset_name: str = "coefs") -> MultipoleCoefs:
    """Parse a Multipole coefficient source (path / HDF5 / raw string)."""
    lines = _source_to_lines(source, group_name, dataset_name)
    meta = _parse_meta(lines)
    if "gridSizeR" not in meta:
        raise ValueError(
            "coefficient source has no gridSizeR header — not a valid "
            "Agama coef file (or the header failed to parse)")
    n_r = int(meta["gridSizeR"])

    markers = {}
    for i, line in enumerate(lines):
        s = line.strip()
        if s.startswith("#Phi") or s.startswith("#rho"):
            markers.setdefault("phi", i)
        elif s.startswith("#dPhi/dr"):
            markers["dphi"] = i
    if "phi" not in markers:
        raise ValueError("no #Phi (or #rho) section found")

    def parse_section(idx):
        cols = lines[idx + 1].strip().split("\t")
        labels = []
        for tok in cols[1:]:
            lpart, mpart = tok.split(",")
            labels.append((int(lpart.split("=")[1]),
                           int(mpart.split("=")[1])))
        radii, rows = [], []
        for line in lines[idx + 2: idx + 2 + n_r]:
            vals = line.strip().split("\t")
            radii.append(float(vals[0]))
            rows.append([float(v) for v in vals[1:]])
        return np.array(radii), labels, np.array(rows)

    r_grid, labels, phi = parse_section(markers["phi"])
    dphi = None
    if "dphi" in markers:
        _, _, dphi = parse_section(markers["dphi"])
    return MultipoleCoefs(r_grid, labels, phi, dphi, meta)


def read_cylspl_coefs(source, group_name: str = "snap_000",
                      dataset_name: str = "coefs") -> CylSplineCoefs:
    """Parse a CylSpline coefficient source (path / HDF5 / raw string)."""
    lines = _source_to_lines(source, group_name, dataset_name)
    meta = _parse_meta(lines)
    if "gridSizeR" not in meta:
        raise ValueError(
            "coefficient source has no gridSizeR header — not a valid "
            "Agama coef file (or the header failed to parse)")
    n_r = int(meta["gridSizeR"])
    n_z = int(meta.get("gridSizez", meta.get("gridSizeZ", 0)))

    m_values, blocks = [], []
    r_grid = None
    z_grid = None
    i = 0
    while i < len(lines):
        s = lines[i].strip()
        # Block marker: '<m>\t#m' (Agama layout); accept 'm=<m>' too.
        toks = s.split()
        is_marker = (len(toks) == 2 and toks[1] == "#m") or (
            s.startswith("m=") and "," not in s and "\t" not in s
        )
        if is_marker:
            m_values.append(int(toks[0] if toks[1:] == ["#m"]
                                else s.split("=")[1]))
            header = lines[i + 1].strip().split("\t")
            z_here = np.array([float(v) for v in header[1:]])
            if z_grid is None:
                z_grid = z_here
            rs, rows = [], []
            for line in lines[i + 2: i + 2 + n_r]:
                vals = line.strip().split("\t")
                rs.append(float(vals[0]))
                rows.append([float(v) for v in vals[1:]])
            if r_grid is None:
                r_grid = np.array(rs)
            blocks.append(np.array(rows))
            i += 2 + n_r
        else:
            i += 1
    if r_grid is None:
        raise ValueError("no m-harmonic blocks found in CylSpline source")
    if n_z and z_grid.size != n_z:
        raise ValueError(
            f"gridSizez={n_z} but parsed {z_grid.size} z columns"
        )
    return CylSplineCoefs(r_grid, z_grid, m_values, np.stack(blocks), meta)


def read_coefs(source, **kwargs):
    """Auto-detect Multipole vs CylSpline from the header/type."""
    lines = _source_to_lines(
        source, kwargs.get("group_name", "snap_000"),
        kwargs.get("dataset_name", "coefs"),
    )
    meta = _parse_meta(lines)
    kind = meta.get("type", "").lower()
    text = "\n".join(lines)
    if "cylspline" in kind or "gridSizez" in meta or "gridSizeZ" in meta:
        return read_cylspl_coefs(text)
    return read_mult_coefs(text)
