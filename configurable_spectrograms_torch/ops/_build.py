"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

Every ``csrc/*.cu`` file is compiled by ONE ``nvcc`` call into a shared
library with a plain C interface for Hopper (``sm_90a``), which
:mod:`.kernels` loads with :mod:`ctypes`.  The library lands in
``build/cst_torch/`` at the checkout root, named by a hash of the sources
and flags, so an edited kernel never loads a stale build.  Nothing here
runs at import time: the first kernel launch builds.

Flags: ``-fmad=false`` keeps every product rounded the way numpy and XLA
round it, and there is no ``--use_fast_math`` (``log10f`` stays the
accurate libdevice function).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cst_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: What the last build did: ``seconds`` compiling (0.0 when the cached
#: library was loaded) and the compiler's ``log`` (ptxas register counts).
BUILD_INFO: dict[str, object] = {"seconds": 0.0, "log": "", "path": ""}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cst_collapse": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cst_fused_quantize": [_P] * 8 + [_I] + [_P] * 6 + [_I] * 4 + [_P],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcst_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build for these sources exists."""
    lib = library_path()
    if lib.exists():
        BUILD_INFO.update(seconds=0.0, path=str(lib))
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp-{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(CSRC))
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_INFO.update(seconds=seconds, log=proc.stdout + proc.stderr, path=str(lib))
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed signatures."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
