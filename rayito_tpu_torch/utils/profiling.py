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
    ("sort", "coherence sort / unsort"),
    ("elementwise", "PyTorch elementwise kernels"),
    ("reduce", "PyTorch reductions"),
)

# Host-side ranges (``torch.profiler.record_function`` labels) whose
# kernels are mostly PyTorch's own, so no kernel name tells them apart
# (an eager pass records them; a graph replay does not): each is
# reported as a rollup of the device time of every kernel launched inside
# it, beside the phases above and not summed with them (the reference's
# bounce-loop "while" rollup is reported the same way). On the card a range
# also leaves a device-side annotation of its name spanning its kernels,
# idle gaps included: that row is not a kernel and is dropped.
_ROLLUPS = {
    "mesh_intersect_clusters":
        "two-level cluster pipeline, traversal='xla' (rollup)",
    # the regions of an eager pass (render/pathtracer.py, trace.py,
    # traverse.py, ops/transform.py); transforms nest inside the others
    "shading": "bounce shading, before and after the queries (rollup)",
    "analytic_folds": "analytic folds: planes, spheres, rects (rollup)",
    "traversal_plumbing":
        "traversal plumbing: packing, coherence sort, unsort (rollup)",
    "transforms": "keyed transforms and chains (rollup)",
}


def collect_device_ops(prof):
    """{kernel name: (total µs, count)} over the device-side events of a
    finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in _ROLLUPS}


def phase_table(prof, divisor: float = 1.0):
    """[(phase, ms, kernel or range count)] sorted by cost, the rollups of
    ``_ROLLUPS`` included (their kernels also count in the phases).
    ``divisor`` scales the totals (e.g. the number of profiled frames)."""
    from torch.autograd import DeviceType

    rows = {}
    for name, (us, count) in collect_device_ops(prof).items():
        label = next((lab for key, lab in _PHASES if key in name.lower()),
                     "other device kernels")
        row = rows.setdefault(label, [0.0, 0])
        row[0] += us
        row[1] += count
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key in _ROLLUPS:
            rows[_ROLLUPS[e.key]] = [e.device_time_total, e.count]
    return sorted(((label, us / 1e3 / divisor, count)
                   for label, (us, count) in rows.items() if count),
                  key=lambda r: -r[1])


def range_table(prof, divisor: float = 1.0):
    """{range: (device ms, device ops, instances)} of the ``_ROLLUPS``
    ranges an eager pass records: the kernels launched inside each
    instance, its nested calls included (a graph replay records none)."""
    from torch.autograd import DeviceType

    def ops(e):
        return len(e.kernels) + sum(ops(c) for c in e.cpu_children)

    rows = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in _ROLLUPS:
            row = rows.setdefault(e.name, [0.0, 0, 0])
            row[0] += e.device_time_total
            row[1] += ops(e)
            row[2] += 1
    return {k: (us / 1e3 / divisor, n / divisor, count)
            for k, (us, n, count) in rows.items()}
