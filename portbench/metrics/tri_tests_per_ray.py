"""Ray-triangle tests per ray that reaches a traversal domain's root: the
program's counter ``traverse.pairs`` (the set bits of the cluster masks,
each a 128-ray block against a 128-triangle cluster, which the fold
walks) times 128 x 128, over its counter ``traverse.live_rays``, in the
span render (``spans.py``)."""

from portbench import spans

RAYS_PER_BLOCK = 128
TRIANGLES_PER_CLUSTER = 128


def read(ctx):
    spans.ensure(ctx)
    c = ctx.counters
    if not c or not c.get("traverse.live_rays"):
        return None
    return (c.get("traverse.pairs", 0) * RAYS_PER_BLOCK
            * TRIANGLES_PER_CLUSTER / c["traverse.live_rays"])
