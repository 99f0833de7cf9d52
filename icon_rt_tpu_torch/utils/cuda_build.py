"""nvcc build of the port's CUDA C++ kernels (csrc/*.cu) into shared
libraries with a plain C interface, loaded with ctypes.

Each source compiles on its first use for sm_90a into the package's
gitignored `_build/` directory, never at import: the CPU tests import
every module and this machine has no nvcc.  A library is rebuilt when its
source or a header of csrc/ is newer.  Builds of different sources may run
at the same time (chip_smoke.py starts them together): each nvcc writes a
private file and renames it into place.
"""
from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

#: name -> {"lib": ctypes.CDLL, "seconds": float, "log": str}
_BUILT: dict = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    return "nvcc"


def build(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu (once per process) and load it.

    Flags: -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
    -fmad=false (every operation rounds on its own, as in eager PyTorch, so
    a kernel can equal its plain version bit for bit) and -Xptxas=-v, whose
    register/spill report is kept in `info(name)["log"]`.  Raises on a
    failed build."""
    with _LOCK:
        if name in _BUILT:
            return _BUILT[name]["lib"]
    src = os.path.join(CSRC, f"{name}.cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    newest = max(os.path.getmtime(p) for p in
                 [src, *glob.glob(os.path.join(CSRC, "*.cuh"))])
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(so) or os.path.getmtime(so) < newest:
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
               "-Xcompiler", "-fPIC", "-I", CSRC, "-o", tmp, src]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc {name}.cu failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
        log = res.stderr
    lib = ctypes.CDLL(so)
    with _LOCK:
        _BUILT.setdefault(name, {"lib": lib,
                                 "seconds": time.perf_counter() - t0,
                                 "log": log})
        return _BUILT[name]["lib"]


def info(name: str) -> dict:
    """{'seconds': build+load time, 'log': nvcc/ptxas report} of a built
    library."""
    return {k: _BUILT[name][k] for k in ("seconds", "log")}


def check(fn: str, err: int):
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed (cudaError {err})")


def occupancy(name: str) -> dict:
    """{'blocks_per_sm', 'registers', 'local_bytes'} of the kernel of the
    built library csrc/<name>.cu, from its C entry point
    <name>_occupancy (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its
    launch's 128 threads, cudaFuncGetAttributes)."""
    out = (ctypes.c_int * 3)()
    fn = getattr(_BUILT[name]["lib"], f"{name}_occupancy")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    check(f"{name}_occupancy", fn(out))
    return {"blocks_per_sm": out[0], "registers": out[1],
            "local_bytes": out[2]}
