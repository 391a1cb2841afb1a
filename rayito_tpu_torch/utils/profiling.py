"""Device-time profiling helpers (counterpart of
``rayito_tpu/utils/profiling.py``): digest a finished ``torch.profiler``
trace into per-kernel and per-phase device time, so the tools can answer
"where does the frame go" without reading thousands of trace events.
"""

from __future__ import annotations

# Kernel-name substrings (matched in lower case) -> renderer phase, first
# match wins. The port's
# CUDA kernels are named by their __global__ symbols in csrc/; PyTorch's
# own kernels are bucketed by family.
_PHASES = (
    ("cluster_masks_kernel", "cluster-mask kernel (slab tests)"),
    ("blocks_", "block traversal kernels (traverse_blocks)"),
    ("build_items_kernel", "item-list kernel (build_items)"),
    ("items_", "item traversal kernels (traverse_items)"),
    ("gather_rows_t_kernel", "winner-row gather kernel"),
    ("cluster_pipeline_kernel", "two-level cluster pipeline kernel"),
    ("cmj_", "sample-stream kernels (cmj)"),
    ("fold_small_kernel", "tiny-mesh fold kernel"),
    ("bounce_prepare_kernel", "shading kernel before the queries"),
    ("bounce_resolve_kernel", "shading kernel after the queries"),
    ("trace_mark_kernel", "device span markers (utils/tracing.py)"),
    ("sort", "coherence sort / unsort"),
    ("elementwise", "PyTorch elementwise kernels"),
    ("reduce", "PyTorch reductions"),
)

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


def phase_table(prof, divisor: float = 1.0):
    """[(phase, ms, kernel count)] sorted by cost: the device kernels by
    name. ``divisor`` scales the totals (e.g. the number of profiled
    frames). Which layer of the pass a PyTorch kernel served is told by the
    device spans of ``utils/tracing.py``, not by its name."""
    rows = {}
    for name, (us, count) in collect_device_ops(prof).items():
        label = next((lab for key, lab in _PHASES if key in name.lower()),
                     "other device kernels")
        row = rows.setdefault(label, [0.0, 0])
        row[0] += us
        row[1] += count
    return sorted(((label, us / 1e3 / divisor, count)
                   for label, (us, count) in rows.items() if count),
                  key=lambda r: -r[1])



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
