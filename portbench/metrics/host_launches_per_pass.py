"""Host launches per pass in the traced stretch: the profiler's CUDA
runtime events that launch a kernel or a graph."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.passes or not tr.kernels:
        return None
    n = sum(1 for name, _, _ in tr.runtime if name in ctx.launch_calls)
    return n / tr.passes
