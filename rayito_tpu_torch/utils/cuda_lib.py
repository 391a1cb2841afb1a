"""Build and load the port's CUDA kernels (``rayito_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` to an object file, one process per
source, all started together, and links them into one shared library with
a plain C interface, ``build/rayito_tpu_torch/libkernels.so`` under the
repo root, for ``sm_90a`` (Hopper) without FMA contraction. It is rebuilt
when the sources' hash changes and loaded with ctypes at first use;
nothing is built or loaded when the package is imported. A failed build
raises.

Beside the build, what every kernel wrapper shares: the dispatch on the
tensors' device (``on_cpu``), the library and stream of a launch
(``launch_args``) and the launch counts: ``counted`` registers a wrapper
in ``KERNELS``, ``count_launch`` counts one launch (on the host, and with
tracing on in the ``launches.<kernel>`` counters of ``utils/tracing.py``),
``reset_launch_counts`` and ``launch_counts`` set and read them all.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import torch

from . import tracing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "rayito_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libkernels.so")
# used when no nvcc is on PATH
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # every multiply and add rounds on its own, as in the reference;
    # divisions and square roots are IEEE
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "rt_cluster_masks": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P,
                         _P],
    # masks, soat, tri, slices, n_live, run_if, best, list, t, prim,
    # counter, n_blocks, b, n_words, n_clusters, sb, n_steps, tmin, bw,
    # any_hit, stream
    "rt_traverse_blocks": [_P] * 11 + [_I] * 6 + [_F, _I, _I, _P],
    "rt_gather_rows_t": [_P, _P, _P, _I, _I, _I, _P],
    # items, n_steps, soab, tri, slices, skip, best, counter, t, prim,
    # slice counter, n_blocks, b, n_clusters, max_groups, w, tmin, bw, stream
    "rt_traverse_items": [_P] * 11 + [_I] * 5 + [_F, _I, _P],
    "rt_build_items": [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I,
                       _I, _I, _I, _P],
    "rt_cluster_pipeline": [_P] * 15 + [_I, _I, _I, _I, _I, _F, _P],
    # plan, px, py, si, out, n, stream
    "rt_cmj_draws": [_P, _P, _P, _P, _P, _I, _P],
    "rt_cmj_plan_bytes": [],
    # spec, 6 tables, 7 rays, time, tmin, 9 inputs, 6 outputs, n, stream
    "rt_fold_small": [_P] * 15 + [_F] + [_P] * 18 + [_I, _P],
    # spec, pointer array, resolve, n, stream
    "rt_shade": [_P, _P, _I, _I, _P],
    "rt_shade_spec_bytes": [],
    "rt_shade_ptrs": [],
    # log, cursor, capacity, code, stream
    "rt_trace_mark": [_P, _P, _I, _I, _P],
    # spec, pointer array, tmin, any_hit, 3 test counters, lane counter,
    # n, stream
    "rt_analytic_fold": [_P, _P, _F, _I] + [_P] * 4 + [_I, _P],
    "rt_analytic_fold_spec_bytes": [],
    "rt_analytic_fold_ptrs": [],
    # 7 ray planes, box, soa8, operand, live counter, chain slots, 5
    # transform tables, time, local ray, rotation, depth, k, n, n_tot,
    # c_pad, tmin, key, stream
    "rt_ray_pack": [_P] * 20 + [_I] * 5 + [_F, _I, _P],
    # soa8, vals, idx, soat, perm, n_live, n_tot, sb, stream
    "rt_ray_reorder": [_P] * 6 + [_I, _I, _P],
    # p_bn, t_bn, perm, prim, t, n, n_slots, hit_only, stream
    "rt_ray_unsort": [_P] * 5 + [_I, _I, _I, _P],
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
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    ptxas = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = [p.communicate()[0] for p in procs]
    failed = [(p.args[-1], log) for p, log in zip(procs, logs)
              if p.returncode != 0]
    tmp = f"{LIB_PATH}.{tag}"
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(("link", link.stdout + link.stderr))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name}:\n{log}" for name, log in failed))
    os.replace(tmp, LIB_PATH)
    with open(stamp, "w") as f:
        f.write(digest)
    return {"built": True, "seconds": seconds, "log": "".join(logs)}


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


def on_cpu(name, *tensors) -> bool:
    """True: run the plain version (CPU tensors). False: launch the CUDA
    kernel (CUDA tensors). Anything else raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors
                                  if t is not None}) == 1:
        return False
    raise ValueError(f"{name}: tensors must all be on the CPU or all on "
                     f"one CUDA device, got {sorted(kinds)}")


def launch_args(name, *tensors):
    """(the loaded library, the current stream's handle) for a launch on
    ``tensors``, which must be contiguous."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return library(), torch.cuda.current_stream(tensors[0].device).cuda_stream


KERNELS = []  # every kernel wrapper, as ``counted`` registered it


def counted(fn):
    """Register kernel wrapper ``fn`` for the launch counts: ``launches``
    counts its calls that launched, on the host (captures included)."""
    fn.launches = 0
    KERNELS.append(fn)
    return fn


def count_launch(fn, device) -> None:
    """One launch of ``fn``'s kernel on ``device``: its host count, and,
    with tracing on, the counter ``launches.<fn>`` (``utils/tracing.py``),
    which a pass graph's replays add to."""
    fn.launches += 1
    tracing.count("launches." + fn.__name__, 1, device)


def reset_launch_counts() -> None:
    """Set every kernel's host count and ``launches.*`` counter to 0."""
    for fn in KERNELS:
        fn.launches = 0
    tracing.reset_counts("launches.")


def launch_counts() -> dict:
    """{kernel: launches run since the last reset while tracing was on},
    graph replays included (reads the devices back). Raises when tracing
    is off: nothing is counted then."""
    if not tracing.enabled():
        raise RuntimeError("launch_counts: tracing is off, so no launch was "
                           "counted (utils/tracing.on())")
    c = tracing.counters()
    return {fn.__name__: c.get("launches." + fn.__name__, 0)
            for fn in KERNELS}
