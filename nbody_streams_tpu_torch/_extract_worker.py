"""Standalone extract_orbits worker — run as a FILE, never imported.

``_extract_parallel`` launches this with ``subprocess.Popen([sys.executable,
<this file>])`` and a JSON job spec on stdin.  A plain subprocess (rather
than ``multiprocessing``) because this is a library API called from
arbitrary user code:

* ``fork`` of a multithreaded parent (torch's thread pools) is a
  documented deadlock;
* ``spawn``/``forkserver`` re-import the parent's ``__main__``, which
  re-executes unguarded user scripts (no ``if __name__ == '__main__'``)
  recursively — unacceptable for a library.

Running the file directly also skips the package import entirely: the
worker needs only numpy + h5py (~0.5 s startup), not torch.

Job spec (JSON file path in argv[1], or stdin if no argv):
    {"shm_name": str, "shape": [T, N, 6], "start": int, "stop": int,
     "jobs": [[dest_index, snap_number, h5_path], ...]}

Writes rows into the shared-memory array and exits 0; any exception
prints to stderr and exits nonzero (the parent falls back to serial).
"""
import json
import sys


def main() -> int:
    from multiprocessing import shared_memory

    import h5py
    import numpy as np

    if len(sys.argv) > 1:
        with open(sys.argv[1]) as f:
            spec = json.load(f)
    else:
        spec = json.load(sys.stdin)
    shm = shared_memory.SharedMemory(name=spec["shm_name"])
    # Attaching registers the segment with this process's resource
    # tracker (fixed upstream only in 3.13's track=False); without the
    # unregister the first worker to exit unlinks the segment out from
    # under the parent and its siblings.
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass
    try:
        out = np.ndarray(tuple(spec["shape"]), dtype=np.float64,
                         buffer=shm.buf)
        start, stop = spec["start"], spec["stop"]
        for dest, snap, path in spec["jobs"]:
            with h5py.File(path, "r") as f:
                out[dest] = f["snapshots"][f"snap.{snap:03d}"][start:stop]
    finally:
        shm.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
