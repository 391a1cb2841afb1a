"""Analytic row tests per lane entering the analytic fold: the program's
counters ``analytic_fold.tests.plane`` + ``.sphere`` + ``.rect`` (an
any-hit lane counted to its first hit) over ``analytic_fold.lanes.closest``
+ ``analytic_fold.lanes.any`` (each query's lanes once), in the span render
(``spans.py``). A closest-hit lane tests every plane, sphere and rect of
the scene; a scene BVH or a cull over the rows would cut it. None on a
tree whose fold counts nothing."""

from portbench import spans

KINDS = ("plane", "sphere", "rect")


def read(ctx):
    spans.ensure(ctx)
    c = ctx.counters or {}
    lanes = c.get("analytic_fold.lanes.closest", 0) + c.get(
        "analytic_fold.lanes.any", 0)
    if not lanes:
        return None
    return sum(c.get(f"analytic_fold.tests.{k}", 0) for k in KINDS) / lanes
