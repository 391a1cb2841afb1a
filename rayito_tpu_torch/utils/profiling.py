"""Device-time profiling helpers (counterpart of
``rayito_tpu/utils/profiling.py``): digest a finished ``torch.profiler``
trace into per-kernel device time, and the device spans of
``utils/tracing.py`` into per-layer device time, so the tools can answer
"where does the frame go" without reading thousands of trace events.
Which layer of the pass a kernel served is told by the spans, not by its
name.
"""

from __future__ import annotations


def collect_device_ops(prof):
    """{kernel name: (total µs, count)} over the device-side events of a
    finished ``torch.profiler.profile``. A host span's range
    (``utils/tracing.span``) also leaves a device-side annotation spanning
    its kernels, idle gaps included: that row is no kernel and is
    dropped."""
    from torch.autograd import DeviceType

    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)}


def span_table(snapshot, divisor: float = 1.0) -> dict:
    """{name: (ms, self ms, instances)} of the device spans of a
    ``utils/tracing.snapshot()``: each span's duration, and that less its
    child spans' (the time of its own work). ``divisor`` scales the times
    (e.g. the number of frames)."""
    spans = snapshot.device
    child = {}
    for s in spans:
        if s.parent is not None:
            child[s.parent] = child.get(s.parent, 0.0) + (s.end - s.start)
    rows = {}
    for s in spans:
        row = rows.setdefault(s.name, [0.0, 0.0, 0])
        row[0] += s.end - s.start
        row[1] += s.end - s.start - child.get(s.id, 0.0)
        row[2] += 1
    return {k: (t / 1e6 / divisor, own / 1e6 / divisor, n)
            for k, (t, own, n) in rows.items()}
