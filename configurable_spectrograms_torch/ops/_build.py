"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

Every ``csrc/*.cu`` file is compiled to an object by its own ``nvcc``
process, all started together, and one more ``nvcc`` links the objects
into a shared library with a plain C interface for Hopper (``sm_90a``),
which :mod:`.kernels` loads with :mod:`ctypes`.  The library lands in
``build/cst_torch/`` at the checkout root, named by a hash of the sources
and flags, so an edited kernel never loads a stale build.  Nothing here
runs at import time: the first kernel launch builds.

Flags: ``-fmad=false`` keeps every product rounded the way numpy and XLA
round it, and there is no ``--use_fast_math`` (``log10f`` stays the
accurate libdevice function).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cst_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: What the last build did: ``seconds`` compiling (0.0 when the cached
#: library was loaded) and the compiler's ``log`` (ptxas register counts).
BUILD_INFO: dict[str, object] = {"seconds": 0.0, "log": "", "path": ""}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cst_collapse": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cst_fused_quantize": [_P] * 8 + [_I] + [_P] * 7 + [_I] * 5 + [_P],
    "cst_stft_power": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P],
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


def _run_all(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Run the commands concurrently; (exit code, output) of each, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(CSRC))
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def build() -> Path:
    """Compile the library unless a build for these sources exists."""
    lib = library_path()
    if lib.exists():
        BUILD_INFO.update(seconds=0.0, path=str(lib))
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=f"{lib.stem}-", dir=BUILD_DIR) as work:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [os.path.join(work, f"{src.stem}.o") for src in srcs]
        results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)] for src, obj in zip(srcs, objs)])
        log = "".join(f"== {src.name}\n{out}" for src, (_, out) in zip(srcs, results))
        failed = [src.name for src, (rc, _) in zip(srcs, results) if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = os.path.join(work, lib.name)
        [(rc, out)] = _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        if rc != 0:
            raise RuntimeError(f"nvcc link failed ({rc}):\n{out}")
        os.replace(tmp, lib)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log, path=str(lib))
    return lib


_LIBRARY: list[ctypes.CDLL] = []  # the loaded library, once built
_LIBRARY_LOCK = threading.Lock()


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed signatures.

    The batch driver's worker threads can reach their first kernel
    together; the lock makes one of them build while the others wait, so
    the sources are compiled once per process.
    """
    with _LIBRARY_LOCK:
        if not _LIBRARY:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBRARY.append(lib)
        return _LIBRARY[0]
