"""Build ``csrc/*.cu`` with nvcc at first use and bind it with ctypes.

The kernels have a plain C interface (no PyTorch headers), so one nvcc
call builds them in seconds.  The shared library goes to
``build/nbody_torch_kernels/<hash of sources and flags>/`` beside the
package (``NBODY_TORCH_BUILD_DIR`` overrides the root), so a changed source
never loads a stale build.  Nothing here runs at import: the CPU path never
needs nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["library", "build", "check"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_ROOT = Path(__file__).resolve().parents[2]
# no --use_fast_math: the Kahan sums and the h = 0 selects need IEEE FP32
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIB_NAME = "libnbody_torch_kernels.so"

_lib = None


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from "
                       f"{_CSRC} at first use")


def build_dir() -> Path:
    root = os.environ.get("NBODY_TORCH_BUILD_DIR")
    return (Path(root) if root else _ROOT / "build") / "nbody_torch_kernels"


def build() -> Path:
    """Compile the kernels if no build of these exact sources exists;
    return the library's path.  The compiler's report (registers, spills,
    shared memory per kernel) is kept in ``build.log`` beside it."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(_CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = build_dir() / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc={proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)   # atomic: a concurrent build never sees a torn file
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nbody_direct.argtypes = [i, i, i, i, p, i, p, i, p, i, i, i, f,
                                     p, p]
        lib.nbody_direct.restype = i
        lib.nbody_band.argtypes = [i, i, i, p, i, p, i, p, i, i, i, f, p, p]
        lib.nbody_band.restype = i
        lib.nbody_block_size.argtypes = []
        lib.nbody_block_size.restype = i
        for chain in (lib.nbody_fma_chain, lib.nbody_rsqrt_chain):
            chain.argtypes = [p, i, i, i, i, p, p]
            chain.restype = i
        lib.nbody_tile_sol.argtypes = [i, p, i, p, i, i, i, f, p, p]
        lib.nbody_tile_sol.restype = i
        lib.nbody_tile_sol_occupancy.argtypes = [i, ctypes.POINTER(i)]
        lib.nbody_tile_sol_occupancy.restype = i
        lib.nbody_error_string.argtypes = [i]
        lib.nbody_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().nbody_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
