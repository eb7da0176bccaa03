"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources are compiled by one ``nvcc`` call for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``.
The library goes to ``build/kinpoly_tpu_torch/`` at the repository root,
named by a hash of the sources and flags, so it is rebuilt whenever a source
changes and reused otherwise. Nothing is built or loaded at import time.

``LAUNCHES`` counts kernel launches by name (multi-RHS kernels by name and
width, ``name[R=r]``; the kinematics kernel with the dof frames as
``fk_tree[frames]``): each wrapper adds one where it launches its kernel,
and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kinpoly_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: argtypes (pointers, sizes, stream); every function returns the
    # launch's cudaGetLastError() as int
    "ltdl_factor": (_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P),
    "ltdl_solve": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "pgs_solve": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "chol_solve_only": (_P, _P, _P, _I, _I, _I, _P),
    "chol_factor_solve": (_P, _P, _P, _P, _I, _I, _I, _P),
    "chol_apply": (_P, _P, _P, _I, _I, _I, _P),
    "fk_tree": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libkinpoly_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels if this source state has no library yet.
    Returns (library path, seconds spent compiling; 0 when reused)."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, rc: int) -> None:
    """Raise on a refused launch; count the launch otherwise."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1
