"""Device milliseconds per pass, in the traced stretch, of the kernels that
are not one of the program's own: every kernel whose function is not a
``__global__`` of ``rayito_tpu_torch/csrc`` (read from the sources at run
time, so a new hand kernel counts as the program's without an edit here).
These are the regions not yet written by hand: folds, transforms and the
traversal's plumbing, in PyTorch's kernels."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.passes or not tr.kernels:
        return None
    us = sum(d for name, _, d in tr.kernels
             if ctx.kernel_id(name) not in ctx.hand_kernels)
    return us * 1e-3 / tr.passes
