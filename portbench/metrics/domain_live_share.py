"""The share of the lanes handed to the traversal domains that reach a
domain's root box, in percent: the program's counter
``traverse.live_rays`` over its counter ``traverse.lanes`` (the lanes of
every ``traverse()`` call), in the span render (``spans.py``). Every
other lane is packed, sorted and unsorted for nothing. None on a tree
whose program counts no lanes."""

from portbench import spans


def read(ctx):
    spans.ensure(ctx)
    c = ctx.counters
    if not c or not c.get("traverse.lanes") or "traverse.live_rays" not in c:
        return None
    return 100.0 * c["traverse.live_rays"] / c["traverse.lanes"]
