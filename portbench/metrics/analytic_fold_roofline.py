"""The analytic fold's share of its roofline, in percent: the least time
for the work the program's ``analytic_fold.*`` counters count in the span
render (``rooflines/analytic_fold.py``: the row tests' lane instructions
at the issue rate or the lanes' bytes at the memory bandwidth, the larger)
over the device time of ``analytic_fold_kernel`` in the traced render of
the window. Both renders are one render of the same seeded frame, so they
do the same work; the counters' own cost (tracing on) stays out of the
time."""

from portbench import spans


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.kernels:
        return None
    roof = ctx.roofline("analytic_fold")
    us = sum(d for name, _, d in tr.kernels
             if ctx.kernel_id(name) == roof.KERNEL)
    if not us:
        return None
    spans.ensure(ctx)
    c = ctx.counters or {}
    if not (c.get("analytic_fold.lanes.closest")
            or c.get("analytic_fold.lanes.any")):
        return None
    least = roof.least_seconds(c, ctx.scene["motion"])
    return 100.0 * least / (us * 1e-6)
