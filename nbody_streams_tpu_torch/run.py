"""Integration driver: device-resident KDK runs with snapshot/restart I/O.

Counterpart of ``nbody_streams_tpu/run.py``.  The loop runs chunks of KDK
steps between event boundaries (snapshots, restarts, NaN checks); the
state stays on the device and the host fetches it only at boundaries.
Snapshot and restart files are the JAX package's formats (``nbody_io``),
so a run started by either package resumes in the other.  Self-gravity is
``DirectGravity`` or the solver a ``solver_factory`` builds (the SCF tier);
an external field and a ``ForceExtra`` (the dynamical friction) add their
terms.  ``profile_dir`` traces the chunks with ``torch.profiler``.  Not
ported: multi-device ``devices``.
"""
from __future__ import annotations

import contextlib
import copy
import time as pytime
import warnings
from pathlib import Path

import numpy as np
import torch

from .constants import G_DEFAULT, validate_kernel, validate_precision
from .integrate import (
    ForceExtra,
    IntegratorState,
    init_state,
    make_accel_fn,
    make_kdk_step,
    run_chunk,
    system_energy,
)
from .nbody_io import (
    _load_restart,
    _save_restart,
    _save_snapshot,
    _update_snapshot_times,
)
from .ops.dispatch import DirectGravity
from .species import Species

__all__ = ["run_nbody", "run_nbody_tpu",
           "run_nbody_gpu", "run_nbody_cpu"]

# grace added to the boundary-work watchdog deadline (fetch + energy
# eval); module-level so tests can shrink it
_BOUNDARY_GRACE_S = 60.0
# grace added to each watched sub-chunk's deadline
_CHUNK_GRACE_S = 30.0
# watched sub-chunk length: a hang loses at most this many steps
_WATCH_STEPS = 50


class CallbackForceExtra(ForceExtra):
    """Adapter for reference-style plain callables
    ``fn(pos, vel, masses, time) -> (N, 3)`` on numpy arrays: the state is
    copied to the host for each call."""

    def __init__(self, fn, mass_np):
        self.fn = fn
        self.mass_np = np.asarray(mass_np, np.float64)

    def __call__(self, state, pos, vel, mass, t, phi=None, step=0):
        out = self.fn(pos.cpu().numpy(), vel.cpu().numpy(), self.mass_np,
                      float(t))
        return torch.as_tensor(np.asarray(out), dtype=pos.dtype,
                               device=pos.device), state


class _ChunkWatchdog:
    """Per-chunk deadline: a daemon timer that, if a chunk exceeds its
    deadline, saves an emergency restart from the last host state and
    interrupts the main thread (a hung device call cannot be cancelled,
    but the run fails fast with its state preserved)."""

    def __init__(self, timeout_s: float, on_timeout):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._timer = None

    def __enter__(self):
        import _thread
        import threading

        def fire():
            try:
                self.on_timeout()
            finally:
                _thread.interrupt_main()

        self._timer = threading.Timer(self.timeout_s, fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
        return False


def _resolve_device(architecture: str) -> torch.device:
    """'gpu' and 'auto' -> the CUDA device (each raises without one: the
    CPU runs only when asked for); 'cpu'."""
    if architecture == "cpu":
        return torch.device("cpu")
    if architecture in ("gpu", "auto", None):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"architecture={architecture!r} but torch sees no CUDA "
                "device; pass architecture='cpu' to run on the CPU")
        return torch.device("cuda")
    if architecture == "tpu":
        raise ValueError("architecture='tpu' is the JAX package's "
                         "(nbody_streams_tpu); this package runs on 'gpu' "
                         "or 'cpu'")
    raise ValueError(f"Unknown architecture {architecture!r}")


def run_copies(external_potential, force_extra, masses, device, dtype):
    """The external field and the extra force as a run uses them: a torch
    module field as a copy moved to ``device`` and ``dtype`` (the caller's
    object is left as it is), a ``ForceExtra`` with a ``to(device, dtype)``
    method (the dynamical friction) as the copy it returns, and a plain
    ``fn(pos, vel, masses, t)`` wrapped in ``CallbackForceExtra``."""
    if isinstance(external_potential, torch.nn.Module):
        external_potential = copy.deepcopy(external_potential).to(
            device=device, dtype=dtype)
    fx = force_extra
    if fx is not None and not isinstance(fx, ForceExtra):
        fx = CallbackForceExtra(fx, masses)
    elif callable(getattr(fx, "to", None)):
        fx = fx.to(device=device, dtype=dtype)
    return external_potential, fx


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _profiled(profile_dir, device: torch.device):
    """``torch.profiler`` around the run's chunks when ``profile_dir`` is
    set (CPU activity, and CUDA activity on the card); the Chrome trace
    is written into ``profile_dir`` on the way out, as the JAX package's
    ``jax.profiler.start_trace`` / ``stop_trace`` pair does."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        _synchronize(device)
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(
            out / f"nbody_trace_{pytime.strftime('%Y%m%d-%H%M%S')}.json"))


def _snapshot_schedule(total_steps: int, snapshots: int) -> np.ndarray:
    if snapshots > 1:
        steps = np.round(np.linspace(0, total_steps, snapshots)).astype(int)
        # more snapshots than steps: the rounded schedule repeats steps,
        # and duplicates would be written with the wrong data/time —
        # collapse them (fewer snapshots than asked, each one correct)
        return np.unique(steps)
    return np.array([total_steps], dtype=int)


def run_nbody(
    phase_space: np.ndarray,
    masses: np.ndarray,
    time_start: float,
    time_end: float,
    dt: float,
    softening=0.0,
    G: float = G_DEFAULT,
    precision: str = "float32_kahan",
    kernel: str = "spline",
    external_potential=None,
    external_update_interval: int = 1,
    force_extra=None,
    output_dir: str = "./output",
    save_snapshots: bool = True,
    snapshots: int = 10,
    num_files_to_write: int = 1,
    restart_interval: int = 1000,
    continue_run: bool = False,
    overwrite: bool = False,
    verbose: bool = True,
    debug_energy: bool = False,
    species: list[Species] | None = None,
    architecture: str = "auto",
    impl: str = "auto",
    devices=None,
    block_size: int | None = None,
    nan_check: bool = True,
    step_timeout_s: float | None = None,
    profile_dir: str | None = None,
    solver_factory=None,
    target_drift: float | None = None,
) -> np.ndarray:
    """Run a KDK leapfrog N-body integration; returns final (N, 6) float64.

    The surface of ``nbody_streams_tpu.run.run_nbody``, on a CUDA GPU or
    the CPU:

    * ``precision``: 'float32' | 'float32_kahan' (compensated force
      accumulation *and* compensated state updates) | 'float64' (the
      oracle impl) | 'float32_fast' (runs as 'float32', with a warning).
    * ``impl``: 'auto' | 'cuda' (hand-written kernels) | 'torch' (oracle).
    * ``architecture``: 'gpu' or 'auto' (the CUDA device; each raises
      without one) | 'cpu'.
    * ``external_potential``: any object with ``force(pos, t)``, called
      with the (N, 3) state tensor and the step's time as a Python float.
      A torch module (every ``potentials`` class) runs as a copy moved to
      the run's device and state dtype; the caller's object is left as it
      is.  ``force_extra`` (a :class:`ForceExtra`, or a plain
      ``fn(pos, vel, masses, t)`` on numpy arrays) is duck-typed too; a
      ``force_extra`` with a ``to(device, dtype)`` method (the dynamical
      friction) runs as the copy that method returns.
    * ``solver_factory``: ``(mass_arr, soft_arr, device=) -> solver``,
      called with the resolved device in place of building
      ``DirectGravity`` (how ``run_simulation(method='scf')`` installs the
      SCF tier); ``impl``/``kernel``/``block_size`` then do not apply.
    * ``profile_dir``: the chunks run under ``torch.profiler`` (CPU and,
      on the card, CUDA activity), and a Chrome trace is written into
      ``profile_dir`` when the loop ends, a failing run's included.
    * ``devices`` with more than one device is not ported yet and raises
      ``NotImplementedError``.
    """
    validate_kernel(kernel)
    validate_precision(precision)
    if external_potential is not None and not callable(
            getattr(external_potential, "force", None)):
        raise TypeError(
            "external_potential must have a force(pos, t) method; got "
            f"{type(external_potential).__name__}")
    if devices is not None and len(devices) > 1:
        raise NotImplementedError(
            "multi-device runs are not ported yet (ROADMAP.md Queue 1 "
            "item 6)")

    phase_space = np.asarray(phase_space, np.float64)
    if phase_space.ndim != 2 or phase_space.shape[1] != 6:
        raise ValueError(f"phase_space must be (N, 6), got {phase_space.shape}")
    n = phase_space.shape[0]
    masses = np.asarray(masses, np.float64)
    if masses.ndim == 0:
        masses = np.full(n, float(masses))
    if masses.shape != (n,):
        raise ValueError(f"masses must have length N={n}, got {masses.shape}")
    soft_arr = np.asarray(softening, np.float64)
    if soft_arr.ndim == 0:
        soft_arr = np.full(n, float(soft_arr))

    output_path = Path(output_dir)

    # Overwrite / continue guards (reference: run.py:513-526)
    if save_snapshots and not continue_run:
        existing = sorted(output_path.glob("snapshot*.h5"))
        if existing:
            if overwrite:
                for f in existing:
                    f.unlink()
                (output_path / "snapshot.times").unlink(missing_ok=True)
                # a stale restart.npz from the clobbered run must not
                # survive: a later continue_run would resume the OLD run
                (output_path / "restart.npz").unlink(missing_ok=True)
                if verbose:
                    print(f"Removed {len(existing)} existing snapshot "
                          f"file(s) in '{output_dir}'.")
            else:
                raise FileExistsError(
                    f"Output directory '{output_dir}' already contains "
                    f"snapshot files: {[f.name for f in existing]}. Pass "
                    "overwrite=True to delete them, or continue_run=True "
                    "to resume."
                )

    start_step = 0
    t_now = float(time_start)
    snapshot_counter = None
    xv = phase_space.copy()
    if continue_run:
        restart = _load_restart(output_path)
        if restart is not None:
            xv, t_now, start_step, saved_counter = restart[:4]
            # reference-format files carry no counter: leave None so the
            # searchsorted fallback below reconstructs it from start_step
            snapshot_counter = (None if saved_counter is None
                                else int(saved_counter))
            if verbose:
                print(f"Resuming from step {start_step}, time {t_now:.6e}")
        elif save_snapshots and sorted(output_path.glob("snapshot*.h5")):
            # no restart but old snapshots present: starting from step 0
            # would silently no-op every write (snapshots are append-only)
            raise FileNotFoundError(
                f"continue_run=True but '{output_path}/restart.npz' is "
                "missing while snapshot files exist — cannot resume. "
                "Pass overwrite=True to start over, or restore the "
                "restart file.")
        else:
            warnings.warn(
                "continue_run=True but no restart.npz found in "
                f"'{output_path}': starting a fresh run from step 0",
                stacklevel=2)

    total_steps = int(round((time_end - time_start) / dt))
    snap_steps = _snapshot_schedule(total_steps, snapshots)
    if snapshot_counter is None:
        snapshot_counter = int(np.searchsorted(snap_steps, start_step, "left"))

    device = _resolve_device(architecture)
    state_dtype = torch.float64 if precision == "float64" else torch.float32

    snap_kwargs = dict(
        num_files_to_write=num_files_to_write,
        total_expected_snapshots=snapshots,
        time_step=dt,
    )
    restart_kwargs = {}
    if species is not None:
        snap_kwargs["species"] = species
        restart_kwargs = dict(
            mass_arr=masses,
            softening_arr=soft_arr,
            species_names=[s.name for s in species],
            species_N=[s.N for s in species],
        )
    else:
        # full array: nbody_io smart storage compresses to a scalar when
        # uniform; masses[0] alone would mislabel unequal-mass runs
        snap_kwargs["mass_dark"] = np.asarray(masses, float)
        snap_kwargs["eps_dark"] = np.asarray(soft_arr, float)

    external_potential, fx = run_copies(external_potential, force_extra,
                                        masses, device, state_dtype)

    if solver_factory is not None:
        solver = solver_factory(masses, soft_arr, device=device)
    else:
        solver = DirectGravity(
            masses, soft_arr, G=G, kernel=kernel, precision=precision,
            impl=impl, block_size=block_size, device=device,
            target_drift=target_drift,
        )

    if verbose:
        print("=" * 70)
        print(f"N-body integration  [{device.type}/{solver.impl}, "
              f"{precision}, kernel={getattr(solver, 'kernel', kernel)}]")
        print(f"Particles: {n:,}  steps: {total_steps:,} "
              f"(start {start_step})  dt={dt:.3e}")
        print("=" * 70)

    accel_fn = make_accel_fn(solver, solver.mass, external_potential,
                             external_update_interval, fx)
    step_fn = make_kdk_step(accel_fn, dt, time_start,
                            compensated=(precision == "float32_kahan"))

    # slab-order reuse: the order is carried in the state and refreshed
    # every presort_every steps, not per force call
    presort = solver.spatial_sort_active
    presort_every = getattr(solver, "presort_interval", None)
    state = init_state(
        xv[:, :3], xv[:, 3:], accel_fn, solver.mass, time_start,
        start_step=start_step, dt=dt, dtype=state_dtype, force_extra=fx,
        sort_fn=solver.sort_key if presort else None, device=device,
    )

    e_ref = None
    if debug_energy:
        ke, pe = system_energy(state, solver, solver.mass)
        e_ref = float(ke) + float(pe)
        if verbose:
            print(f"[energy t0] KE={float(ke):.4e} PE={float(pe):.4e} "
                  f"E={e_ref:.4e}")

    def fetch_xv(st: IntegratorState) -> np.ndarray:
        return torch.cat([st.pos, st.vel], dim=1).cpu().numpy().astype(
            np.float64)

    def write_snapshot(xv_host, counter, t):
        _save_snapshot(xv_host, counter, t, output_path, **snap_kwargs)
        _update_snapshot_times(output_path, counter, t)
        if verbose:
            print(f"  snapshot {counter:03d} @ t={t:.6e}")

    # Initial snapshot if scheduled at start_step
    if (snapshot_counter < len(snap_steps)
            and snap_steps[snapshot_counter] == start_step):
        if save_snapshots:
            write_snapshot(fetch_xv(state), snapshot_counter, t_now)
        snapshot_counter += 1

    # Event boundaries: snapshot steps + restart multiples.  With
    # snapshots off, keep a bounded NaN-check cadence (<= 250 steps).
    if save_snapshots:
        events = set(snap_steps[snap_steps > start_step].tolist())
    elif nan_check:
        events = set(range(start_step + 250, total_steps, 250))
    else:
        events = set()
    if restart_interval and restart_interval > 0:
        events.update(range(
            ((start_step // restart_interval) + 1) * restart_interval,
            total_steps + 1, restart_interval))
    events.add(total_steps)
    boundaries = sorted(e for e in events if e > start_step)

    last_xv = xv          # emergency payload: last *completed* state
    wd_step = start_step
    wd_t = time_start + start_step * dt

    def emergency_restart():
        _save_restart(last_xv, wd_t, wd_step, output_path, snapshot_counter,
                      **restart_kwargs)
        print(f"WATCHDOG: sub-chunk exceeded the {step_timeout_s}s/step "
              f"deadline after step {wd_step}; emergency restart (all "
              f"completed work) saved to {output_path}/restart.npz",
              flush=True)

    def boundary_guard():
        # boundary device work (fetch, energy eval) is watched too
        return (_ChunkWatchdog(step_timeout_s * 4 + _BOUNDARY_GRACE_S,
                               emergency_restart)
                if step_timeout_s else contextlib.nullcontext())

    t_wall0 = pytime.perf_counter()
    current = start_step
    # a watchdog interrupt or a NaN abort still writes the trace: that
    # failing run is the one being profiled
    with _profiled(profile_dir, device):
        for boundary in boundaries:
            n_steps = boundary - current
            if n_steps <= 0:
                continue
            done = 0
            while done < n_steps:
                s = min(_WATCH_STEPS if step_timeout_s else n_steps,
                        n_steps - done)
                if step_timeout_s:
                    with _ChunkWatchdog(step_timeout_s * s + _CHUNK_GRACE_S,
                                        emergency_restart):
                        state = run_chunk(step_fn, state, s, presort=presort,
                                          presort_every=presort_every)
                        _synchronize(device)
                else:
                    state = run_chunk(step_fn, state, s, presort=presort,
                                      presort_every=presort_every)
                done += s
                if step_timeout_s:
                    with boundary_guard():
                        last_xv = fetch_xv(state)
                    wd_step = current + done
                    wd_t = time_start + wd_step * dt
            current = boundary
            t_now = time_start + current * dt

            due_snap = (snapshot_counter < len(snap_steps)
                        and current >= snap_steps[snapshot_counter])
            due_restart = (restart_interval and current % restart_interval == 0
                           ) or current == total_steps
            # snapshots-off boundaries exist only as NaN-gate checks
            due_check = nan_check and not save_snapshots
            if due_snap or due_restart or debug_energy or due_check:
                # the watchdog path already fetched this exact state
                xv_host = last_xv if step_timeout_s else fetch_xv(state)
                last_xv = xv_host
                if nan_check and not np.isfinite(xv_host).all():
                    # the diagnostic payload goes to a SEPARATE file: the last
                    # good restart.npz must survive the abort
                    _save_restart(xv_host, t_now, current, output_path,
                                  snapshot_counter,
                                  filename="restart_nanabort.npz",
                                  **restart_kwargs)
                    raise FloatingPointError(
                        f"Non-finite phase space at step {current}; "
                        "offending state saved to "
                        f"{output_path}/restart_nanabort.npz (the last good "
                        "restart.npz is untouched — rerun with "
                        "continue_run=True to resume from it)")
                while (snapshot_counter < len(snap_steps)
                       and current >= snap_steps[snapshot_counter]):
                    if save_snapshots:
                        write_snapshot(xv_host, snapshot_counter, t_now)
                    snapshot_counter += 1
                if due_restart:
                    _save_restart(xv_host, t_now, current, output_path,
                                  snapshot_counter, **restart_kwargs)
            if verbose:
                elapsed = pytime.perf_counter() - t_wall0
                steps_done = current - start_step
                rate = steps_done / elapsed if elapsed > 0 else 0.0
                line = (f"  step {current:>7}/{total_steps} | t={t_now:.4e} "
                        f"| {rate:.1f} steps/s | "
                        f"avg {1e3 * elapsed / max(steps_done, 1):.1f} "
                        "ms/step")
                if debug_energy and e_ref is not None:
                    with boundary_guard():
                        ke, pe = system_energy(state, solver, solver.mass)
                        ke, pe = float(ke), float(pe)
                    etot = ke + pe
                    q = f"{ke / abs(pe):.3f}" if pe else "inf"
                    de = (etot - e_ref) / abs(e_ref) if e_ref else etot - e_ref
                    line += f" | Q={q} dE/E={de:+.2e}"
                print(line, flush=True)

    with boundary_guard():
        xv_final = fetch_xv(state)
    if current != total_steps:
        # only when no boundary reached total_steps (resuming a finished
        # run): save the ACTUAL step of the state, never total_steps
        _save_restart(xv_final, t_now, current, output_path,
                      snapshot_counter, **restart_kwargs)

    if verbose:
        wall = pytime.perf_counter() - t_wall0
        steps_done = total_steps - start_step
        if steps_done > 0 and wall > 0:
            print(f"Done: {steps_done} steps in {wall:.2f} s "
                  f"({steps_done / wall:.1f} steps/s, "
                  f"{1e3 * wall / steps_done:.2f} ms/step)")
    return xv_final


def run_nbody_tpu(*args, **kwargs):
    """Accelerator-pinned driver (the JAX package's name; the reference's
    ``run_nbody_gpu``): ``run_nbody`` with ``architecture='gpu'``."""
    kwargs.setdefault("architecture", "gpu")
    return run_nbody(*args, **kwargs)


run_nbody_gpu = run_nbody_tpu


def run_nbody_cpu(*args, **kwargs):
    """CPU-pinned driver (the reference's ``run_nbody_cpu``): the torch
    oracle on the CPU.

    The reference's CPU-only knobs are accepted: ``method`` ('direct' or
    'tree' — the reference's pyfalcon tree runs here as the exact direct
    sum), ``theta`` (tree opening angle: exact here) and ``nthreads``
    (torch manages its own thread pool) are validated and dropped."""
    method = kwargs.pop("method", "direct")
    if method not in ("direct", "tree"):
        raise ValueError(f"unknown method {method!r} (use 'direct' or "
                         "'tree')")
    kwargs.pop("theta", None)
    kwargs.pop("nthreads", None)
    kwargs.setdefault("architecture", "cpu")
    kwargs.setdefault("impl", "torch")
    return run_nbody(*args, **kwargs)
