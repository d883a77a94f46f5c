"""Snapshot / restart I/O and the ParticleReader.

File-format compatible with the reference framework (reference:
nbody_io.py:770-1073) so data written by either implementation can be read
by the other:

* ``snapshot.h5`` (or ``snapshot.NNN.h5`` shards): group ``/snapshots`` with
  gzip'd ``snap.NNN`` (N, 6) float64 datasets and ``snap_time.NNN`` attrs;
  group ``/properties`` with ``n_species``/``species_names`` attrs and
  per-species sub-groups storing ``N`` plus *smart* mass/softening — a
  scalar dataset ``m``/``eps`` when uniform, else compressed
  ``m_array``/``eps_array``.
* ``restart.npz`` with phase_space/time/step/snapshot_counter (+ species
  metadata arrays).
* ``snapshot.times`` two-column text index, auto-maintained.

All of this runs host-side, off the device hot path: the integrator hands
over already-fetched NumPy arrays at snapshot boundaries (see run.py).
The module is the JAX package's ``nbody_io`` unchanged, so files written by
either package load in the other.
"""
from __future__ import annotations

import glob
import math
import os
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np

try:
    import h5py

    H5PY_AVAILABLE = True
except ImportError:  # pragma: no cover - h5py is baked into the image
    H5PY_AVAILABLE = False

from .species import Species

__all__ = ["ParticleReader"]


# ---------------------------------------------------------------------------
# Writers (internal, used by the integrators)
# ---------------------------------------------------------------------------

def _is_uniform(arr: np.ndarray):
    """(is_uniform, value) — True when every element equals the first."""
    if arr.size == 0:
        return True, 0.0
    v = arr.flat[0]
    return bool(np.all(arr == v)), float(v)


def _snapshot_filename(output_dir: Path, snap_index: int,
                       num_files_to_write: int | None,
                       total_expected_snapshots: int | None) -> Path:
    """Single file, or round-robin/contiguous sharding across num_files."""
    nf = int(num_files_to_write or 1)
    if nf <= 1:
        return output_dir / "snapshot.h5"
    if total_expected_snapshots and total_expected_snapshots > 0:
        per_file = math.ceil(total_expected_snapshots / nf)
        idx = min(int(snap_index) // per_file, nf - 1)
    else:
        idx = int(snap_index) % nf
    return output_dir / f"snapshot.{idx:03d}.h5"


def _write_smart(grp, name: str, arr: np.ndarray,
                 scalar_fallback: bool = False) -> None:
    """Smart storage: scalar dataset when uniform, gzip array otherwise.

    ``scalar_fallback`` additionally writes a scalar ``name`` dataset
    (first element) beside the array — the legacy dark/star layout
    always carries a scalar ``m``/``eps``, which reference-era readers
    expect to find.
    """
    uniform, val = _is_uniform(arr)
    if uniform:
        grp.create_dataset(name, data=val)
        return
    if scalar_fallback:
        grp.create_dataset(name, data=float(arr.flat[0]))
    grp.create_dataset(f"{name}_array", data=arr, compression="gzip")


def _write_species_properties(props, species: list[Species]) -> None:
    if "n_species" not in props.attrs:
        props.attrs["n_species"] = len(species)
        props.attrs["species_names"] = np.array(
            [s.name.encode("utf-8") for s in species]
        )
    for s in species:
        if s.name in props:
            continue
        grp = props.create_group(s.name)
        grp.create_dataset("N", data=int(s.N))
        _write_smart(grp, "m", s.mass_array())
        _write_smart(grp, "eps", s.softening_array())


def _save_snapshot(
    phase_space: np.ndarray,
    snap_index: int,
    time: float,
    output_dir,
    *,
    species: list[Species] | None = None,
    time_step: float | None = None,
    num_files_to_write: int | None = None,
    total_expected_snapshots: int | None = None,
    mass_dark: float | np.ndarray | None = None,
    eps_dark: float | np.ndarray | None = None,
) -> None:
    """Append one snapshot; never overwrites an existing snap dataset."""
    if not H5PY_AVAILABLE:
        raise ImportError("h5py is required for snapshot I/O")
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    fname = _snapshot_filename(output_dir, snap_index, num_files_to_write,
                               total_expected_snapshots)

    with h5py.File(fname, "a") as f:
        snaps = f.require_group("snapshots")
        name = f"snap.{snap_index:03d}"
        if name in snaps:
            return  # append-only: existing data is never clobbered
        snaps.create_dataset(name, data=phase_space, compression="gzip")
        snaps.attrs[f"snap_time.{snap_index:03d}"] = float(time)

        props = f.require_group("properties")
        if species is not None:
            _write_species_properties(props, species)
        else:
            # single-species fallback written in the legacy layout
            n = phase_space.shape[0]
            if "dark" not in props:
                grp = props.create_group("dark")
                grp.create_dataset("N", data=n)
                m_arr = np.atleast_1d(np.asarray(
                    1.0 if mass_dark is None else mass_dark, float))
                _write_smart(grp, "m", m_arr, scalar_fallback=True)
                h_arr = np.atleast_1d(np.asarray(
                    0.0 if eps_dark is None else eps_dark, float))
                _write_smart(grp, "eps", h_arr, scalar_fallback=True)
            if "star" not in props:
                grp = props.create_group("star")
                grp.create_dataset("N", data=0)
                grp.create_dataset("m", data=1.0)
                grp.create_dataset("eps", data=0.0)
        if "time_step" not in props:
            props.create_dataset("time_step", data=float(time_step or 0.0))


def _save_restart(
    phase_space: np.ndarray,
    time: float,
    step: int,
    output_dir,
    snapshot_counter: int,
    *,
    mass_arr: np.ndarray | None = None,
    softening_arr: np.ndarray | None = None,
    species_names: list[str] | None = None,
    species_N: list[int] | None = None,
    filename: str = "restart.npz",
    state: dict | None = None,
) -> None:
    """Atomic-ish restart checkpoint (write temp then replace).

    ``state`` (name -> array) adds the integrator's state beyond the phase
    space, as ``state_<name>`` entries; the JAX package's reader ignores
    them.  The archive is stored uncompressed: zlib took ~10-15 s a write
    at N = 2M on the host (PERF.md, the scale drivers), several KDK steps;
    ``np.load``, and so the JAX package's reader, reads either form."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    payload: dict = dict(
        phase_space=np.asarray(phase_space, np.float64),
        time=np.float64(time),
        step=np.int64(step),
        snapshot_counter=np.int64(snapshot_counter),
    )
    if mass_arr is not None:
        payload["mass_arr"] = np.asarray(mass_arr, np.float64)
    if softening_arr is not None:
        payload["softening_arr"] = np.asarray(softening_arr, np.float64)
    if species_names is not None:
        payload["species_names"] = np.array(
            [n.encode("utf-8") for n in species_names]
        )
    if species_N is not None:
        payload["species_N"] = np.array(species_N, dtype=np.int64)
    for key, val in (state or {}).items():
        payload[f"state_{key}"] = np.asarray(val)

    tmp = out / (filename + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    tmp.replace(out / filename)


def _load_restart(output_dir):
    """Load restart state; returns a 9-tuple or None.

    ``(phase_space, time, step, snapshot_counter, mass_arr, softening_arr,
    species_names, species_N, state)`` with None entries for fields absent
    in older files (including the reference's 4-field format and the JAX
    package's files, which hold no ``state``).  ``state`` is the dict
    ``_save_restart`` was given.
    """
    path = Path(output_dir) / "restart.npz"
    if not path.exists():
        return None
    # context-manage the NpzFile: a live zip handle on restart.npz
    # while _save_restart replaces the same file is asking for trouble
    with np.load(path, allow_pickle=False) as data:
        xv = np.array(data["phase_space"])
        t = float(data["time"])
        step = int(data["step"])
        # None (not 0) when absent — the reference's 4-field format.
        # The driver reconstructs the counter from the resume step;
        # counter=0 would make its catch-up loop rewrite snapshot.times
        # rows for every already-written snapshot.
        counter = (int(data["snapshot_counter"])
                   if "snapshot_counter" in data.files else None)

        def opt(key):
            return np.array(data[key]) if key in data.files else None

        names = opt("species_names")
        mass_arr = opt("mass_arr")
        soft_arr = opt("softening_arr")
        ns = opt("species_N")
        state = {k.removeprefix("state_"): np.array(data[k])
                 for k in data.files if k.startswith("state_")} or None
    if names is not None:
        names = [
            n.decode("utf-8") if isinstance(n, (bytes, np.bytes_)) else str(n)
            for n in names
        ]
    if ns is not None:
        ns = [int(v) for v in ns]
    return (xv, t, step, counter, mass_arr, soft_arr, names, ns, state)


def _update_snapshot_times(output_dir, snap_index: int, time: float) -> None:
    """Maintain the two-column 'snap_index time' text index."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "snapshot.times"

    rows: dict[int, float] = {}
    if path.exists():
        try:
            arr = np.loadtxt(str(path), comments="#", ndmin=2)
            for r in arr:
                rows[int(r[0])] = float(r[1])
        except Exception:
            pass
    rows[int(snap_index)] = float(time)
    items = sorted(rows.items())
    arr = np.array(items, dtype=float)
    np.savetxt(str(path), arr, fmt="%d %.10e", header="snap_index time",
               comments="# ")


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def _times_namespace(arr: np.ndarray) -> SimpleNamespace:
    arr = np.atleast_2d(np.asarray(arr, float))
    return SimpleNamespace(snap=arr[:, 0].astype(int), time=arr[:, 1])


# extract_orbits warns before allocating more than this (reference
# parity: nbody_io.py:632-640); module-level so tests can lower it
_RAM_WARN_GB = 4.0


def _extract_parallel(jobs, t, nk, start, stop, workers):
    """Parallel snapshot extraction: shared-memory output + plain
    subprocess workers (``_extract_worker.py`` run as a file).

    Plain subprocesses, not ``multiprocessing``: forking a
    multithreaded parent is a documented deadlock,
    and spawn/forkserver re-import the parent's ``__main__``, which
    re-executes unguarded user scripts — unacceptable for a library
    API.  Running the worker FILE directly also skips the package (and
    torch) import, so worker startup is ~0.5 s (numpy + h5py only).

    On success the returned (T, N_k, 6) array is backed directly by the
    shared-memory mapping — the segment name is unlinked immediately
    (POSIX keeps the mapping alive) and the mapping is released by a
    finalizer when the array is garbage collected, so peak RAM is 1x
    the output, not shm + copy.  Returns None if shared memory / worker
    processes are unavailable (caller falls back to serial)."""
    import json
    import subprocess
    import sys
    import tempfile
    import weakref
    from multiprocessing import shared_memory

    shape = (t, nk, 6)
    if t == 0 or nk == 0:
        return np.empty(shape, dtype=np.float64)  # nothing to read
    try:
        shm = shared_memory.SharedMemory(
            create=True, size=int(np.prod(shape)) * 8)
    except OSError as exc:
        warnings.warn(
            f"shared memory unavailable ({exc}); extract_orbits reading "
            "serially", RuntimeWarning, stacklevel=3)
        return None

    worker = str(Path(__file__).with_name("_extract_worker.py"))
    procs, spec_files = [], []
    failed = None
    try:
        for batch in (jobs[w::workers] for w in range(workers)):
            if not batch:
                continue
            # spec via a temp file, not a stdin pipe: job lists can
            # exceed the 64 KB pipe buffer and deadlock the writer
            with tempfile.NamedTemporaryFile(
                    "w", suffix=".json", delete=False) as sf:
                json.dump({"shm_name": shm.name, "shape": shape,
                           "start": start, "stop": stop,
                           "jobs": batch}, sf)
                spec_files.append(sf.name)
            p = subprocess.Popen(
                [sys.executable, worker, spec_files[-1]],
                stdin=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True)
            procs.append(p)
        for p in procs:
            _, err = p.communicate()
            if p.returncode != 0 and failed is None:
                failed = (err or "").strip().splitlines()[-1:] or ["?"]
    except OSError as exc:  # pragma: no cover - env
        failed = [str(exc)]
        for p in procs:
            p.kill()
        for p in procs:
            try:
                p.wait(timeout=10)
            except Exception:
                pass
    finally:
        for name in spec_files:
            try:
                os.unlink(name)
            except OSError:
                pass
    if failed is not None:
        warnings.warn(
            f"worker-process extraction failed ({failed[0]}); reading "
            "serially", RuntimeWarning, stacklevel=3)
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass  # a dying worker's resource tracker already unlinked it
        return None
    out = np.ndarray(shape, dtype=np.float64, buffer=shm.buf)
    try:
        shm.unlink()                  # drop the name; mapping survives
    except FileNotFoundError:         # pragma: no cover - tracker race
        pass
    weakref.finalize(out, shm.close)  # release mapping with the array
    return out


class ParticleReader:
    """Read simulation output written by this framework (or the reference).

    Reference-equivalent surface (reference: nbody_io.py:157-768):
    glob multi-file support, species/properties parsing for both the
    multi-species and legacy dark/star schemas, int-index or float-time
    snapshot lookup, ``snapshot.times`` auto-creation, and bulk orbit
    extraction to per-species ``(T, N_k, 6)`` arrays.

    Parameters
    ----------
    sim_pattern : str
        Path or glob pattern for snapshot HDF5 files.
    times_file_path : str, optional
        Explicit snapshot.times path (default: sibling of the first file).
    verbose : bool
    """

    def __init__(self, sim_pattern: str, times_file_path: str | None = None,
                 verbose: bool = False):
        if not H5PY_AVAILABLE:
            raise ImportError("h5py is required for ParticleReader")
        self._verbose = bool(verbose)
        self.file_list = sorted(glob.glob(str(sim_pattern)))
        if not self.file_list:
            raise FileNotFoundError(
                f"No HDF5 files found matching pattern: {sim_pattern}"
            )
        self._log(f"found {len(self.file_list)} file(s)")
        self._read_properties()
        self._scan_snapshots()
        self._load_or_create_times(times_file_path)

    # -- internals ---------------------------------------------------------
    def _log(self, msg: str) -> None:
        if self._verbose:
            print(f"[ParticleReader] {msg}")

    def _read_properties(self) -> None:
        self._timestep = 0.0
        self.species_list: list[Species] = []
        with h5py.File(self.file_list[0], "r") as f:
            props = f.get("properties")
            if props is None:
                return
            if "time_step" in props:
                try:
                    self._timestep = float(props["time_step"][()])
                except Exception:
                    pass

            if "n_species" in props.attrs:
                raw = props.attrs["species_names"]
                names = [
                    n.decode("utf-8") if isinstance(n, (bytes, np.bytes_))
                    else str(n)
                    for n in raw
                ]
            else:
                names = [n for n in ("dark", "star") if n in props]

            for name in names:
                grp = props.get(name)
                if grp is None:
                    continue
                n_sp = int(grp["N"][()]) if "N" in grp else 0
                if n_sp <= 0:
                    continue
                if "m_array" in grp:
                    mass = grp["m_array"][:]
                else:
                    mass = float(grp["m"][()]) if "m" in grp else 1.0
                if "eps_array" in grp:
                    eps = grp["eps_array"][:]
                else:
                    eps = float(grp["eps"][()]) if "eps" in grp else 0.0
                self.species_list.append(Species(name, n_sp, mass, eps))

        for s in self.species_list:
            self._log(f"[{s.name}] N={s.N:,}")

    def _scan_snapshots(self) -> None:
        self._snap_to_file: dict[int, str] = {}
        self._snap_to_time: dict[int, float] = {}
        for path in self.file_list:
            with h5py.File(path, "r") as f:
                grp = f.get("snapshots")
                if grp is None:
                    continue
                for key in grp.keys():
                    try:
                        idx = int(key.split(".")[-1])
                    except ValueError:
                        continue
                    self._snap_to_file[idx] = path
                    attr = f"snap_time.{idx:03d}"
                    if attr in grp.attrs:
                        self._snap_to_time[idx] = float(grp.attrs[attr])
        self.Snapshots = np.array(sorted(self._snap_to_file), dtype=int)
        self._log(f"{self.Snapshots.size} snapshots mapped")

    def _load_or_create_times(self, times_file_path) -> None:
        self.Times = None
        candidates = []
        if times_file_path is not None:
            candidates.append(Path(times_file_path))
        candidates.append(Path(self.file_list[0]).parent / "snapshot.times")
        for cand in candidates:
            if cand.exists():
                try:
                    self.Times = _times_namespace(
                        np.loadtxt(str(cand), comments="#")
                    )
                    self._log(f"loaded times from {cand}")
                    return
                except Exception:
                    continue
        # Fail-safe creation from per-snapshot HDF5 time attrs
        if self.Snapshots.size:
            snaps = self.Snapshots
            if all(int(s) in self._snap_to_time for s in snaps):
                times = np.array(
                    [self._snap_to_time[int(s)] for s in snaps]
                )
            elif self._timestep > 0:
                times = (snaps - snaps.min()) * self._timestep
            else:
                times = np.arange(snaps.size, dtype=float)
            arr = np.column_stack([snaps, times])
            path = Path(self.file_list[0]).parent / "snapshot.times"
            try:
                np.savetxt(str(path), arr, fmt="%d %.10e",
                           header="snap_index time", comments="# ")
                self.Times = _times_namespace(arr)
                self._log(f"created {path}")
            except Exception:
                self.Times = None

    # -- public API --------------------------------------------------------
    def read_snapshot(self, identifier):
        """Load one snapshot by int index or float physical time.

        Returns a SimpleNamespace with ``.species`` ({name: {'posvel',
        'mass'}}), legacy ``.dark``/``.star`` aliases, ``.snap`` and
        ``.time``.
        """
        if isinstance(identifier, (float, np.floating)):
            if self.Times is None:
                raise ValueError(
                    "Time-based lookup requires a snapshot.times file"
                )
            pick = int(np.argmin(np.abs(self.Times.time - identifier)))
            snap_index = int(self.Times.snap[pick])
        elif isinstance(identifier, (int, np.integer)):
            snap_index = int(identifier)
        else:
            raise TypeError(
                "identifier must be an int snapshot index or float time"
            )

        if snap_index not in self._snap_to_file:
            raise ValueError(f"Snapshot {snap_index} not found")

        with h5py.File(self._snap_to_file[snap_index], "r") as f:
            data = f["snapshots"][f"snap.{snap_index:03d}"][:]

        by_species: dict[str, dict] = {}
        start = 0
        for s in self.species_list:
            by_species[s.name] = {
                "posvel": data[start:start + s.N],
                "mass": s.mass_array(),
            }
            start += s.N
        if not self.species_list:
            by_species["dark"] = {"posvel": data,
                                  "mass": np.ones(data.shape[0])}

        empty = {"posvel": np.empty((0, 6)), "mass": np.empty(0)}
        part = SimpleNamespace(
            species=by_species,
            dark=by_species.get("dark", empty),
            star=by_species.get("star", empty),
            snap=snap_index,
        )
        if self.Times is not None:
            mask = self.Times.snap == snap_index
            # a stale/truncated snapshot.times must not hide the HDF5
            # attr that is always recorded alongside the snapshot
            part.time = (float(self.Times.time[mask][0]) if mask.any()
                         else self._snap_to_time.get(snap_index))
        else:
            part.time = self._snap_to_time.get(snap_index)
        return part

    def extract_orbits(self, particle_type="star",
                       max_workers: int | str = "auto", snap_indices=None,
                       *, min_parallel_workers=None):
        """Bulk-load one species across snapshots into a (T, N_k, 6) array.

        Returns a SimpleNamespace with ``.posvel`` (T, N_k, 6), ``.times``
        (T,) (or None), ``.snaps`` (T,) and ``.mass`` (N_k,) — plus the
        reference-contract attributes (reference nbody_io.py:548-768):
        ``.species`` ({name: (T, N_k, 6)}), a per-species attribute
        (``.star``, ``.dark``, ...) and ``.Times``.
        ``particle_type='all'``/``True`` loads every species in the
        file; ``False`` returns None.  ``min_parallel_workers=`` is the
        reference's worker-cap name (actual workers =
        min(cap, cpus, snapshots), same as ``max_workers=``).

        Worker strategy: h5py serialises all HDF5 API calls (including
        gzip-chunk decompression) under a single global lock, so thread
        pools give no real parallelism — measured on a single-core host,
        4 threads were *slower* than serial (98 s vs 81 s over 100
        compressed 200k-particle snapshots; docs/io.md).  Multi-snapshot
        parallel reads therefore use a **process pool writing into POSIX
        shared memory** (the reference's design: nbody_io.py:548-768),
        chosen automatically when the host has multiple cores and the
        extraction is large enough to amortise worker spawn; everything
        else reads serially.  ``max_workers=1`` forces serial;
        an integer > 1 forces that many processes.

        Warns before allocating > 4 GB (reference
        parity: nbody_io.py:632-640).
        """
        if min_parallel_workers is not None:
            max_workers = int(min_parallel_workers)
        if particle_type is False:
            return None
        if particle_type is True or particle_type == "all":
            combined = SimpleNamespace(species={})
            for s in self.species_list:
                one = self.extract_orbits(s.name, max_workers=max_workers,
                                          snap_indices=snap_indices)
                combined.species[s.name] = one.posvel
                setattr(combined, s.name, one.posvel)
                combined.Times = one.times
                combined.times = one.times
                combined.snaps = one.snaps
            return combined
        species = next(
            (s for s in self.species_list if s.name == particle_type), None
        )
        if species is None:
            raise ValueError(
                f"Species {particle_type!r} not in file; available: "
                f"{[s.name for s in self.species_list]}"
            )
        start = 0
        for s in self.species_list:
            if s.name == particle_type:
                break
            start += s.N
        stop = start + species.N

        snaps = (self.Snapshots if snap_indices is None
                 else np.asarray(snap_indices, int))

        total_gb = snaps.size * species.N * 6 * 8 / 1e9
        if total_gb > _RAM_WARN_GB:
            warnings.warn(
                f"extract_orbits will allocate ~{total_gb:.1f} GB of RAM "
                f"({snaps.size} snapshots x {species.N} particles). Use "
                "snap_indices to load a subset, or iterate over "
                "read_snapshot() instead.",
                # UserWarning, NOT ResourceWarning: Python's default
                # filters silently swallow ResourceWarning, and a
                # suppressed pre-OOM notice is no notice at all
                UserWarning, stacklevel=2)

        if max_workers == "auto":
            try:  # affinity/cgroup-aware, unlike os.cpu_count()
                ncpu = len(os.sched_getaffinity(0))
            except AttributeError:  # pragma: no cover - non-Linux
                ncpu = os.cpu_count() or 1
            # spawned workers re-import the package (seconds each); each
            # worker needs enough snapshots to amortise its startup
            workers = 1 if ncpu < 2 else int(min(4, ncpu, snaps.size // 16))
            workers = max(1, workers)
        else:
            workers = max(1, int(max_workers))

        jobs = [(i, int(s), str(self._snap_to_file[int(s)]))
                for i, s in enumerate(snaps)]
        if workers > 1:
            out = _extract_parallel(jobs, snaps.size, species.N,
                                    start, stop, workers)
        else:
            out = None
        if out is None:  # serial path, and fallback if shm is unavailable
            out = np.empty((snaps.size, species.N, 6), dtype=np.float64)
            for i, snap, path in jobs:
                with h5py.File(path, "r") as f:
                    out[i] = f["snapshots"][f"snap.{snap:03d}"][start:stop]

        times = None
        if self.Times is not None:
            tmap = dict(zip(self.Times.snap, self.Times.time))
            times = np.array([tmap.get(int(s), np.nan) for s in snaps])
        elif self._snap_to_time:
            times = np.array(
                [self._snap_to_time.get(int(s), np.nan) for s in snaps]
            )
        ns = SimpleNamespace(
            posvel=out, times=times, snaps=snaps, mass=species.mass_array(),
            species={particle_type: out}, Times=times,
        )
        setattr(ns, particle_type, out)
        return ns
