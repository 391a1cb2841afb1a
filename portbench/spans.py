"""The span render of a ``--trace 1`` run: the program's own spans and
counters (``rayito_tpu_torch/utils/tracing.py``), read by the per-layer
metrics of the integrator's layers, the host stall and the traversal's
work.

``ensure(ctx)`` runs once per run, after the window, the reference and
every reader of the untraced render, so those read the same render as
before tracing existed. It builds the cell's scene anew on the card,
switches tracing on, renders once untimed (which captures the traced twins
of the pass graphs), then renders once more under the profiler, and hands
the readers:

  * ``ctx.spans``: the render's host and device spans on the profiler's
    clock (``tracing.on_trace``: the k-th marker kernel of the trace is
    the k-th entry of the device's log), microseconds;
  * ``ctx.span_trace``: that render's trace (``trace.parse``);
  * ``ctx.counters``: the counters of that render.

Where the program has no tracing module (a tree before it), or the run
has no card, the three are None and every reader of them returns None.

Device time is attributed to the innermost device span around a device
operation's start (operations of one stream run in order; the marker
kernels themselves are left out).
"""

from __future__ import annotations

import importlib
import json
import os
import sys

from . import stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STALL = ("band.readback", "band.host_add", "checkpoint", "progress")


def _seed(default: int = 0) -> int:
    """The run's ``--seed`` (the readers are handed no seed)."""
    argv = sys.argv
    for i, a in enumerate(argv):
        if a == "--seed" and i + 1 < len(argv):
            return int(argv[i + 1])
        if a.startswith("--seed="):
            return int(a.split("=", 1)[1])
    return default


def ensure(ctx) -> None:
    """Set ``ctx.spans``, ``ctx.span_trace`` and ``ctx.counters`` once."""
    if hasattr(ctx, "spans"):
        return
    ctx.spans = ctx.span_trace = ctx.counters = None
    tr = getattr(ctx, "trace", None)
    if tr is None or not tr.kernels:
        return  # no device: nothing to attribute
    try:
        tracing = importlib.import_module("rayito_tpu_torch.utils.tracing")
    except ImportError:
        return
    ctx.spans, ctx.span_trace, ctx.counters = _span_render(ctx, tracing)
    own = {}
    for chain, d in attributed(ctx):
        k = chain[-1] if chain else "(no span)"
        own[k] = own.get(k, 0.0) + d * 1e-3 / ctx.span_trace.passes
    print("[portbench] span render: device ms per pass by innermost span "
          + json.dumps(dict(sorted(own.items(), key=lambda kv: -kv[1])))
          + f"; inside a span {coverage(ctx)!r}; host stall ms per pass "
          f"{host_stall_ms(ctx)!r}; counters {json.dumps(ctx.counters)}",
          file=sys.stderr, flush=True)


def _span_render(ctx, tracing):
    import torch

    from rayito_tpu_torch.render.progressive import render_progressive
    from rayito_tpu_torch.utils import graphs

    from . import port_scene, run, standin
    from . import trace as ptrace

    obj_paths = {k: standin.cached(os.path.join(ROOT, run.CACHE), m)
                 for k, m in ctx.config.get("meshes", {}).items()}
    rc = run.render_config(ctx.traffic, _seed())
    camera = run.camera_of(ctx.config["camera"])
    scene = port_scene.build(ctx.config, obj_paths).compile(
        torch.device("cuda"))
    with tracing.on():
        render_progressive(scene, rc, camera)  # captures the traced graphs
        torch.cuda.synchronize()
        tracing.reset()
        _, events = ptrace.profile(
            lambda: render_progressive(scene, rc, camera),
            os.path.join(ROOT, run.CACHE, "span_trace.json"))
        snap = tracing.snapshot()
        tracing.reset()
    del scene
    graphs.clear()
    torch.cuda.empty_cache()
    spans = tracing.on_trace(snap, events)
    span_trace = ptrace.parse(events, rc.pixel_samples ** 2)
    return spans, span_trace, snap.counters


def _marker(name: str) -> bool:
    return "trace_mark_kernel" in name


def device_ms(ctx, select) -> float | None:
    """Device ms per pass of the span render's operations whose chain of
    enclosing device span names, innermost last, ``select(chain)``
    accepts; None where there are no spans to read."""
    ensure(ctx)
    if not ctx.spans or ctx.span_trace is None or not ctx.span_trace.passes:
        return None
    us = sum(d for chain, d in attributed(ctx) if select(chain))
    return us * 1e-3 / ctx.span_trace.passes


def attributed(ctx) -> list:
    """[(chain of enclosing device span names, duration µs)] for every
    device operation of the span render but the markers."""
    cached = getattr(ctx, "_attributed", None)
    if cached is not None:
        return cached
    spans = sorted((s for s in ctx.spans if s.kind == "device"),
                   key=lambda s: (s.start, -s.end))
    ops = sorted((s, d) for name, s, d in ctx.span_trace.device()
                 if not _marker(name))
    out, stack, k = [], [], 0
    for start, dur in ops:
        while k < len(spans) and spans[k].start <= start:
            while stack and stack[-1].end <= spans[k].start:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1].end <= start:
            stack.pop()
        out.append((tuple(s.name for s in stack), dur))
    ctx._attributed = out
    return out


def coverage(ctx) -> float | None:
    """The share of the span render's device ms inside some device
    span."""
    ensure(ctx)
    if not ctx.spans or ctx.span_trace is None:
        return None
    ops = attributed(ctx)
    total = sum(d for _, d in ops)
    return sum(d for chain, d in ops if chain) / total if total else None


def host_stall_ms(ctx) -> float | None:
    """Device-idle ms per pass of the span render inside the host spans
    of ``STALL``: the read-back, the host add, checkpoints, callbacks."""
    ensure(ctx)
    if not ctx.spans or ctx.span_trace is None or not ctx.span_trace.passes:
        return None
    tr = ctx.span_trace
    idle = stats.gaps(((s, s + d) for _, s, d in tr.device()), tr.lo, tr.hi)
    host = [(s.start, s.end) for s in ctx.spans
            if s.kind == "host" and s.name in STALL]
    inside = sum(stats.union_length(host, a, b) for a, b in idle)
    return inside * 1e-3 / tr.passes
