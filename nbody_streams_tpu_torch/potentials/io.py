"""HDF5 coefficient archives (reference: agama_helper/_io.py).

One Agama coefficient text string per HDF5 group — the batch format used
for evolving potentials, with an optional embedded ``times`` dataset.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None

__all__ = [
    "write_coef_to_h5",
    "write_snapshot_coefs_to_h5",
    "read_coef_string",
    "list_coef_groups",
]


def _require_h5py():
    if h5py is None:
        raise ImportError(
            "h5py is required for coefficient archives "
            "(pip install h5py)")


def write_coef_to_h5(h5_path, coef_string: str,
                     group_name: str = "snap_000",
                     dataset_name: str = "coefs",
                     overwrite: bool = False,
                     metadata: dict | None = None) -> None:
    """Store one coefficient string under ``group_name/dataset_name``."""
    _require_h5py()
    h5_path = Path(h5_path)
    dt = h5py.string_dtype(encoding="utf-8")
    with h5py.File(h5_path, "a") as f:
        grp = f.require_group(group_name)
        if dataset_name in grp:
            if not overwrite:
                raise RuntimeError(
                    f"{group_name}/{dataset_name} exists; pass "
                    "overwrite=True to replace"
                )
            del grp[dataset_name]
        grp.create_dataset(dataset_name, data=coef_string, dtype=dt)
        for k, v in (metadata or {}).items():
            grp.attrs[k] = v


def write_snapshot_coefs_to_h5(h5_path=None, coef_strings=None, times=None,
                               group_fmt: str = "snap_{snap:03d}",
                               dataset_name: str = "coefs",
                               overwrite: bool = True, *,
                               snapshot_ids=None, coef_file_patterns=None,
                               h5_output_paths=None,
                               encoding: str = "utf-8") -> None:
    """Batch-pack snapshot coefficient strings (+ optional times dataset).

    With ``overwrite=True`` (default) any OTHER ``group_fmt``-matching
    snapshot groups already in the file are deleted first: re-packing an
    archive with fewer snapshots must not leave stale snap_* groups
    behind (they would desync from the ``times`` dataset and break
    ``load_evolving_potential``'s groups/times pairing).

    The reference file-pattern form (reference _io.py:
    ``write_snapshot_coefs_to_h5(snapshot_ids, coef_file_patterns,
    h5_output_paths, ...)``, detected by an integer-sequence first
    argument or its keywords) reads ``pattern.format(snap=id)`` source
    files and writes one archive per pattern, storing groups under
    ``group_fmt.format(snap=id)`` and embedding ``times`` in each.
    """
    _require_h5py()
    if snapshot_ids is None and h5_path is not None \
            and not isinstance(h5_path, (str, Path)):
        # reference positional layout
        snapshot_ids, coef_file_patterns, h5_output_paths = \
            h5_path, coef_strings, h5_output_paths or times
        if h5_output_paths is times:
            times = None
    if snapshot_ids is not None:
        snap_list = [int(s) for s in snapshot_ids]
        if coef_file_patterns is None or h5_output_paths is None:
            raise TypeError("the reference form needs snapshot_ids, "
                            "coef_file_patterns and h5_output_paths")
        if len(coef_file_patterns) != len(h5_output_paths):
            raise ValueError(
                f"coef_file_patterns (len={len(coef_file_patterns)}) and "
                f"h5_output_paths (len={len(h5_output_paths)}) must have "
                "the same length")
        if times is not None and len(times) != len(snap_list):
            raise ValueError(
                f"times (len={len(times)}) must match snapshot_ids "
                f"(len={len(snap_list)})")
        for pattern, out_path in zip(coef_file_patterns, h5_output_paths):
            srcs = [Path(pattern.format(snap=s)) for s in snap_list]
            missing = [str(p) for p in srcs if not p.exists()]
            if missing:
                raise FileNotFoundError(
                    f"Coefficient file(s) not found: {missing[:5]}")
            # per-group overwrite (the reference semantic: other groups
            # in an existing archive are left alone)
            out_path = Path(out_path)
            for s, src in zip(snap_list, srcs):
                write_coef_to_h5(out_path, src.read_text(encoding=encoding),
                                 group_fmt.format(snap=s), dataset_name,
                                 overwrite=overwrite)
            if times is not None:
                with h5py.File(out_path, "a") as f:
                    if "times" in f:
                        del f["times"]
                    f.create_dataset("times",
                                     data=np.asarray(times, float))
        return
    h5_path = Path(h5_path)
    coef_strings = list(coef_strings)
    if overwrite and h5_path.exists():
        import re as _re

        pat = _re.compile(
            "^" + _re.escape(group_fmt).replace(
                _re.escape("{snap:03d}"), r"\d+").replace(
                _re.escape("{snap}"), r"\d+") + "$")
        with h5py.File(h5_path, "a") as f:
            for k in [k for k in f.keys()
                      if isinstance(f[k], h5py.Group) and pat.match(k)]:
                del f[k]
    for i, s in enumerate(coef_strings):
        write_coef_to_h5(h5_path, s, group_fmt.format(snap=i),
                         dataset_name, overwrite=overwrite)
    with h5py.File(h5_path, "a") as f:
        # always drop a stale 'times' dataset: re-packing with times=None
        # must not leave old epochs paired with the new coefficients
        # (load_evolving_potential's length check cannot catch that)
        if "times" in f:
            del f["times"]
        if times is not None:
            f.create_dataset("times", data=np.asarray(times, float))


def read_coef_string(h5_path, group_name: str = "snap_000",
                     dataset_name: str = "coefs") -> str:
    """Fetch one stored coefficient string."""
    _require_h5py()
    with h5py.File(h5_path, "r") as f:
        raw = f[group_name][dataset_name][()]
    return raw.decode() if isinstance(raw, bytes) else str(raw)


def list_coef_groups(h5_path, dataset_name: str = "coefs"):
    """(group_names, times or None) for the archive's snapshot groups.

    Sorted numerically by trailing index (snap_999 < snap_1000) so the
    order always matches the embedded ``times`` dataset — plain
    lexicographic sorting breaks past 3-digit archives.
    """
    import re as _re

    _require_h5py()

    def key(name):
        m = _re.search(r"(\d+)$", name)
        return (int(m.group(1)) if m else -1, name)

    with h5py.File(h5_path, "r") as f:
        groups = sorted(
            (k for k in f.keys()
             if isinstance(f[k], h5py.Group) and dataset_name in f[k]),
            key=key,
        )
        times = np.asarray(f["times"][:]) if "times" in f else None
    return groups, times
