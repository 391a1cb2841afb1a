"""Lane-triangle tests per lane entering the tiny-mesh fold: the program's
counters ``fold_small.tests.closest`` plus ``fold_small.tests.any`` (an
any-hit lane counted to its first hit) over ``fold_small.lanes.closest``
plus ``fold_small.lanes.any``, in the span render (``spans.py``). A
closest-hit lane tests every row of every tiny mesh; a bounds test per
mesh would cut it."""

from portbench import spans


def read(ctx):
    spans.ensure(ctx)
    c = ctx.counters or {}
    lanes = c.get("fold_small.lanes.closest", 0) + c.get(
        "fold_small.lanes.any", 0)
    if not lanes:
        return None
    return ((c.get("fold_small.tests.closest", 0)
             + c.get("fold_small.tests.any", 0)) / lanes)
