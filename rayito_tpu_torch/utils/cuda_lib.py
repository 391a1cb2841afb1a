"""Build and load the port's CUDA kernels (``rayito_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, ``build/rayito_tpu_torch/libkernels.so`` under the repo root,
for ``sm_90a`` (Hopper) without FMA contraction. It is rebuilt when the
sources' hash changes and loaded with ctypes at first use; nothing is
built or loaded when the package is imported. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "rayito_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libkernels.so")
# used when no nvcc is on PATH
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # every multiply and add rounds on its own, as in the reference
    "-fmad=false", "-prec-div=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "rt_cluster_masks": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "rt_traverse_blocks": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _F, _I, _I, _P],
    "rt_gather_rows_t": [_P, _P, _P, _I, _I, _I, _P],
}


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or DEFAULT_NVCC
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(verbose: bool = False) -> dict:
    """Compile the library if its sources changed. Returns {"built": bool,
    "seconds": float, "log": str} (the log holds ptxas register and
    shared-memory usage when ``verbose``)."""
    digest = sources_hash()
    stamp = LIB_PATH + ".sha256"
    if os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return {"built": False, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *[s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    with open(stamp, "w") as f:
        f.write(digest)
    return {"built": True, "seconds": seconds,
            "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    build()
    lib = ctypes.CDLL(LIB_PATH)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
