"""Readings of the check numbers over many seeds in one process: the
program as the configuration states it (the lower readings the limits are
set from) or with ``--precision float32`` (the control: float32 without
the Kahan compensations the configuration's float32_kahan keeps) or with
``--fault <name> ...`` (each fault in turn: one of ``faults.py``, planted
in the KDK step, or one of the cell's configuration module's ``FAULTS``,
such as a configuration's own control), on the card, at the cell's own
size and a short window.

    python3 portbench/control.py --workload <cell> --seconds 3 --seeds 1 2 3 [--precision float32] [--fault unchanged.late half.late]

One JSON line a seed.  The benchmark's own runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precision", default=None)
    p.add_argument("--fault", nargs="+", default=[None])
    args = p.parse_args(argv)

    from portbench import faults, harness

    for fault in args.fault:
        for seed in args.seeds:
            with faults.planted(fault, args.workload):
                line, numbers = harness.run(args.workload, seed,
                                            args.seconds, False,
                                            precision=args.precision)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "precision": args.precision or "as configured",
                              "fault": fault, "correct": line["correct"],
                              "numbers": numbers,
                              "metrics": line["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
