"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error give the same numbers.  Without the
cell's CUDA devices, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits with a code other than 0.
"""
import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import harness

    try:
        line, _ = harness.run(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_proc=T_PROC)
    except harness.NoDevice as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package is loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
