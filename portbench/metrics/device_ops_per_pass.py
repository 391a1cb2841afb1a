"""Device operations per pass in the traced stretch: every kernel, copy
and fill the device ran, the nodes of graph replays included."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.passes or not tr.kernels:
        return None
    return len(tr.device()) / tr.passes
