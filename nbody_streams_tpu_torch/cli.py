"""Command-line interface.

``nbody-torch-run``: run a simulation from command-line flags or a JSON
config (the port of ``nbody_streams_tpu.cli``; ``--architecture`` is
'auto' or 'gpu', the card, or 'cpu').
``nbody-torch-bench``: the headline throughput benchmark (``bench``), or
with arguments the benchmark suite (``bench_suite``).
``nbody-torch-build-native``: build the native host library.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _build_parser():
    p = argparse.ArgumentParser(
        prog="nbody-torch-run",
        description="direct N-body simulation runner (PyTorch + CUDA)",
    )
    p.add_argument("--config", help="JSON config file (flags override it)")
    p.add_argument("--n", type=int, default=10000,
                   help="particle count for the generated Plummer IC")
    p.add_argument("--mass", type=float, default=1e9,
                   help="total mass [Msun]")
    p.add_argument("--scale-radius", type=float, default=1.0,
                   help="Plummer scale radius [kpc]")
    p.add_argument("--ic-file", help="restart.npz or .npy (N,6) IC file "
                   "(overrides the generated Plummer sphere)")
    p.add_argument("--t-start", type=float, default=0.0)
    p.add_argument("--t-end", type=float, default=0.1)
    p.add_argument("--dt", type=float, default=1e-4)
    p.add_argument("--softening", type=float, default=0.01)
    p.add_argument("--kernel", default="spline",
                   choices=["newtonian", "plummer", "dehnen_k1",
                            "dehnen_k2", "spline"])
    p.add_argument("--precision", default="float32_kahan",
                   choices=["float32", "float32_kahan", "float64"])
    p.add_argument("--architecture", default="auto",
                   choices=["auto", "cpu", "gpu"],
                   help="'auto' and 'gpu' run on the card (each fails "
                   "without one), 'cpu' on the CPU")
    p.add_argument("--method", default="direct",
                   choices=["direct", "tree"])
    p.add_argument("--external-potential",
                   help="potential INI/coef file evaluated as an "
                   "external field")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--snapshots", type=int, default=10)
    p.add_argument("--restart-interval", type=int, default=1000)
    p.add_argument("--continue", dest="continue_run", action="store_true")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--no-snapshots", action="store_true")
    p.add_argument("--debug-energy", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--seed", type=int, default=42069)
    return p


def main(argv=None):
    parser = _build_parser()
    args = parser.parse_args(argv)

    if args.config:
        with open(args.config) as fh:
            cfg = json.load(fh)
        # "flag was given" must mean PRESENT ON THE COMMAND LINE, not
        # value != default — a flag explicitly set to its default value
        # still overrides the config.  Re-parse with all-None defaults
        # so abbreviations and --flag=value forms are detected too.
        argv_actual = list(sys.argv[1:] if argv is None else argv)
        probe = _build_parser()
        probe.set_defaults(**{a.dest: None for a in probe._actions
                              if a.dest != "help"})
        given_ns = probe.parse_args(argv_actual)
        cli_given = {d for d, v in vars(given_ns).items()
                     if v is not None}
        for k, v in cfg.items():
            key = k.replace("-", "_")
            if key == "continue":       # argparse dest is continue_run
                key = "continue_run"
            if not hasattr(args, key):
                # match run_simulation's strict-kwargs behaviour: a
                # typo'd config key must not be silently ignored
                valid = sorted(d for d in vars(args) if d != "config")
                parser.error(
                    f"unknown config key {k!r} in {args.config} "
                    f"(valid keys: {', '.join(valid)})")
            if key not in cli_given:
                setattr(args, key, v)

    from . import Species, make_plummer_sphere, run_simulation

    if args.ic_file:
        if args.ic_file.endswith(".npz"):
            data = np.load(args.ic_file)
            xv = data["phase_space"]
            masses = data.get("mass_arr")
            if masses is None:
                masses = np.full(len(xv), args.mass / len(xv))
        else:
            xv = np.load(args.ic_file)
            masses = np.full(len(xv), args.mass / len(xv))
    else:
        xv, masses = make_plummer_sphere(
            args.n, M_total=args.mass, a=args.scale_radius, seed=args.seed)

    ext = None
    if args.external_potential:
        from .potentials import make_potential

        # the field is built on the device the run uses
        ext = make_potential(
            file=args.external_potential,
            device="cpu" if args.architecture == "cpu" else "cuda")

    # per-particle masses (e.g. loaded from a restart's mass_arr) pass
    # through intact; Species accepts an (N,) array
    mass_spec = (float(masses[0]) if np.all(masses == masses[0])
                 else np.asarray(masses, float))
    species = [Species.dark(N=len(xv), mass=mass_spec,
                            softening=args.softening)]
    result = run_simulation(
        xv, species, args.t_start, args.t_end, args.dt,
        architecture=args.architecture, method=args.method,
        external_potential=ext, output_dir=args.output_dir,
        save_snapshots=not args.no_snapshots, snapshots=args.snapshots,
        restart_interval=args.restart_interval,
        continue_run=args.continue_run, overwrite=args.overwrite,
        verbose=not args.quiet, debug_energy=args.debug_energy,
        kernel=args.kernel, precision=args.precision,
    )
    if not args.quiet:
        for name, arr in result.items():
            print(f"[{name}] final shape {arr.shape}")
    return 0


def build_native_main(argv=None):
    """Entry point for nbody-torch-build-native: compile the native host
    library (Morton sort + grid-hash kNN)."""
    from . import native

    return 0 if native.build(verbose=True) else 1


def bench_main(argv=None):
    """Entry point for nbody-torch-bench.

    With no arguments it runs :mod:`nbody_streams_tpu_torch.bench` (one
    JSON line on the card); with arguments it forwards them to the
    benchmark suite (e.g. ``nbody-torch-bench -N 262144``).
    """
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if not argv:
        from . import bench

        bench.main()
        return 0
    from . import bench_suite

    bench_suite.main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
