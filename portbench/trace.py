"""The traced stretch of a window: ``torch.profiler`` around a callable,
its Chrome trace read back into plain lists, and what the benchmark takes
from it besides the per-layer metrics (busy time, the breakdown).

Every time here is in microseconds on the profiler's one clock, host and
device alike."""

from __future__ import annotations

import dataclasses
import json
import os
import re

from . import stats

STRETCH = "portbench.stretch"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch")


@dataclasses.dataclass
class Trace:
    lo: float  # the stretch's start and end
    hi: float
    kernels: list  # (name, start, duration), device kernels
    copies: list  # device copies and fills
    runtime: list  # host CUDA runtime calls
    host: list  # host operators and runtime calls of the rendering thread
    passes: int  # whole passes inside the stretch

    def device(self):
        return self.kernels + self.copies

    @property
    def busy_us(self) -> float:
        return stats.union_length(((s, s + d) for _, s, d in self.device()),
                                  self.lo, self.hi)

    @property
    def window_us(self) -> float:
        return self.hi - self.lo


def parse(events: list, passes: int) -> Trace:
    """A Trace of the Chrome-trace ``events`` of one profiled stretch."""
    mark = [e for e in events if e.get("name") == STRETCH
            and e.get("cat") == "user_annotation"]
    if not mark:
        raise RuntimeError("the trace holds no stretch annotation")
    lo, hi = mark[0]["ts"], mark[0]["ts"] + mark[0]["dur"]
    tid = mark[0].get("tid")

    def rows(cats, same_thread=False):
        return [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                for e in events if e.get("cat") in cats
                and e.get("ph") == "X"
                and (not same_thread or e.get("tid") == tid)
                and lo <= float(e["ts"]) < hi]

    return Trace(lo=lo, hi=hi, kernels=rows(("kernel",)),
                 copies=rows(("gpu_memcpy", "gpu_memset")),
                 runtime=rows(("cuda_runtime", "cuda_driver")),
                 host=rows(("cpu_op", "cuda_runtime", "cuda_driver"),
                           same_thread=True),
                 passes=passes)


def profile(fn, path: str):
    """(fn(), the raw event list) with ``fn`` run under the profiler,
    inside one ``portbench.stretch`` range. The trace goes through
    ``path``, which is removed again."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with tprofile(activities=acts) as prof:
        with record_function(STRETCH):
            out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return out, events


_ANON = "(anonymous namespace)::"


def kernel_id(name: str) -> str:
    """The bare function name of a demangled kernel name: no return type,
    namespace, template arguments or parameters."""
    n = name.replace(_ANON, "")
    if n.startswith("void "):
        n = n[5:]
    cut = [i for i in (n.find("("), n.find("<")) if i >= 0]
    n = n[:min(cut)] if cut else n
    return n.rsplit("::", 1)[-1].strip()


_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def hand_kernels(csrc: str) -> set:
    """The ``__global__`` functions of every CUDA source in ``csrc``."""
    names = set()
    for f in sorted(os.listdir(csrc)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, f)) as fh:
                names.update(_GLOBAL.findall(fh.read()))
    return names


def _short(name: str) -> str:
    n = name.replace(_ANON, "")
    return (n[5:] if n.startswith("void ") else n)[:96]


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device named by the innermost host operation that covers
    the gap's middle ("host: no torch op" where none does), in seconds."""
    by = {}
    for name, _, dur in tr.device():
        k = _short(name)
        by[k] = by.get(k, 0.0) + dur
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(stats.gaps(((s, s + d) for _, s, d in tr.device()),
                             tr.lo, tr.hi), key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in idle:
        mid = 0.5 * (s + e)
        cover = [(d, n) for n, hs, d in tr.host if hs <= mid < hs + d]
        named.append(["host: " + min(cover)[1] if cover
                       else "host: no torch op", (e - s) * 1e-6])
    return {"device_ops": [[k, v * 1e-6] for k, v in ops],
            "idle_gaps": named}
