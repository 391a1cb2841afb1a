"""Device milliseconds per pass of the analytic folds and the tiny-mesh
fold, their keyed transforms left out: the operations inside the
program's ``analytic_folds`` and ``tiny_mesh_fold`` device spans and in
no ``transforms`` span below them, in the span render (``spans.py``)."""

from portbench import spans

FOLDS = ("analytic_folds", "tiny_mesh_fold")


def read(ctx):
    return spans.device_ms(ctx, lambda chain: "transforms" not in chain
                           and any(n in FOLDS for n in chain))
