"""Native host-runtime kernels (C++/OpenMP via ctypes).

``host_ops.cpp`` holds two host hot spots that sit off the card: the
Morton (Z-order) argsort and the grid-hash k-nearest-neighbour radius
behind the SPH smoothing lengths (``viz.sph``).  It is built with the
g++ on PATH at first use into ``build/nbody_torch_native/<hash of source, flags and
toolchain>/`` beside the package (``NBODY_TORCH_BUILD_DIR`` overrides the
root), with the compiler's output in ``build.log``; the package directory
is never written to.

``morton_argsort`` and ``knn_radius`` run the library and raise, with the
tail of ``build.log``, when it cannot be built or loaded: there is no
silent fallback.  ``morton_argsort_numpy`` and ``knn_radius_ckdtree`` are
the plain versions (the same results), for tests and for
``get_smoothing_lengths(method='ckdtree')``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["native_available", "build", "morton_argsort", "knn_radius",
           "morton_argsort_numpy", "knn_radius_ckdtree", "build_dir"]

_SRC = Path(__file__).resolve().parent / "host_ops.cpp"
_ROOT = Path(__file__).resolve().parents[2]
# no -march=native: a build/ directory copied to another host must not
# hold a library tuned for a CPU it lacks (it would die with SIGILL)
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17", "-Wall")
LIB_NAME = "libnbody_torch_host.so"

_lib = None


def build_dir() -> Path:
    root = os.environ.get("NBODY_TORCH_BUILD_DIR")
    return (Path(root) if root else _ROOT / "build") / "nbody_torch_native"


def _cxx() -> str:
    # g++ from PATH, not $CXX: a machine may point CXX at a compiler
    # without OpenMP's runtime (g++ then fails on libgomp.spec)
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found on PATH; the host library is "
                           f"built from {_SRC} at first use")
    return cxx


def _lib_path() -> Path:
    """Where the library of this source, these flags and this toolchain
    lives (the compiler's version and the C library are in the hash, so a
    tree carried to another machine builds its own)."""
    cxx = _cxx()
    version = subprocess.run([cxx, "-dumpfullversion", "-dumpmachine"],
                             capture_output=True, text=True).stdout
    digest = hashlib.sha256(" ".join((cxx, *CXX_FLAGS, version,
                                      *platform.libc_ver())).encode())
    digest.update(_SRC.read_bytes())
    return build_dir() / digest.hexdigest()[:16] / LIB_NAME


def _log_tail(out_dir: Path, lines: int = 40) -> str:
    log = out_dir / "build.log"
    if not log.exists():
        return "(no build.log)"
    return "\n".join(log.read_text().splitlines()[-lines:])


def _compile() -> Path:
    """Build the library if no build of this source exists; return its
    path.  The compiler's output goes to ``build.log`` beside it."""
    lib = _lib_path()
    if lib.exists():
        return lib
    out_dir = lib.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_cxx(), *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native host library failed (rc="
            f"{proc.returncode}); {out_dir / 'build.log'} ends:\n"
            + _log_tail(out_dir))
    os.replace(tmp, lib)   # atomic: a concurrent build never sees a torn file
    return lib


def _load() -> ctypes.CDLL:
    """The loaded library (built on the first call); raises if it cannot
    be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    path = _compile()
    try:
        lib = ctypes.CDLL(str(path))
        lib.morton_argsort.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.morton_argsort.restype = ctypes.c_int
        lib.knn_radius.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double)]
        lib.knn_radius.restype = ctypes.c_int
        lib.nbody_host_alive.argtypes = []
        lib.nbody_host_alive.restype = ctypes.c_int
    except (OSError, AttributeError) as exc:
        # AttributeError: a library missing a symbol (ctypes dlsym)
        raise RuntimeError(
            f"loading the native host library {path} failed: {exc}; "
            "build.log ends:\n" + _log_tail(path.parent)) from exc
    if lib.nbody_host_alive() != 1:
        raise RuntimeError(f"the native host library {path} is not alive")
    _lib = lib
    return lib


def native_available() -> bool:
    """True when the library builds (at the first call) and loads."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def build(verbose: bool = True) -> bool:
    """Compile and load the library; True on success.  With ``verbose``
    the outcome (and on failure the error with the tail of ``build.log``)
    is printed."""
    global _lib
    _lib = None
    try:
        _load()
    except RuntimeError as exc:
        if verbose:
            print(f"native build failed: {exc}")
        return False
    if verbose:
        print(f"native build: ok ({_lib_path()})")
    return True


def _check_pos3(pos) -> np.ndarray:
    """Validate/contiguate an (N, 3) position buffer before handing its
    raw pointer to the C library — a (N, 2) array would be read 3N
    doubles deep (out-of-bounds heap read / segfault)."""
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(
            f"positions must be (N, 3), got {pos.shape}; pad 2-D data "
            "with a zero column")
    return pos


def morton_argsort(pos) -> np.ndarray:
    """Z-order (Morton) spatial sort permutation for (N, 3) positions:
    OpenMP key construction + std::sort in the native library."""
    pos = _check_pos3(pos)
    lib = _load()
    out = np.empty(pos.shape[0], dtype=np.int64)
    lib.morton_argsort(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(pos.shape[0]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def morton_argsort_numpy(pos) -> np.ndarray:
    """The plain version of :func:`morton_argsort`: 21-bit interleaved
    keys in NumPy (ties may order differently from the library's)."""
    pos = _check_pos3(pos)
    lo = pos.min(0)
    span = np.maximum(pos.max(0) - lo, 1e-300)
    q = ((pos - lo) / span * ((1 << 21) - 1)).astype(np.uint64)

    def spread(v):
        v &= np.uint64(0x1FFFFF)
        v = (v | v << np.uint64(32)) & np.uint64(0x1F00000000FFFF)
        v = (v | v << np.uint64(16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | v << np.uint64(8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | v << np.uint64(4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | v << np.uint64(2)) & np.uint64(0x1249249249249249)
        return v

    keys = (spread(q[:, 0]) | spread(q[:, 1]) << np.uint64(1)
            | spread(q[:, 2]) << np.uint64(2))
    return np.argsort(keys, kind="stable")


def knn_radius(pos, k: int = 32) -> np.ndarray:
    """Distance to the k-th nearest neighbour (self excluded) for each
    (N, 3) point: the native library's OpenMP grid-hash search."""
    pos = _check_pos3(pos)
    lib = _load()
    out = np.empty(pos.shape[0], dtype=np.float64)
    lib.knn_radius(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(pos.shape[0]), ctypes.c_int(int(k)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def knn_radius_ckdtree(pos, k: int = 32) -> np.ndarray:
    """The plain version of :func:`knn_radius`: SciPy's cKDTree."""
    pos = _check_pos3(pos)
    n = pos.shape[0]
    if n <= 1:
        # no neighbours: the library's 0.0
        return np.zeros(n, dtype=np.float64)
    from scipy.spatial import cKDTree

    d, _ = cKDTree(pos).query(pos, k=min(k + 1, n))
    return d[:, -1]
