"""Ray-triangle tests the mesh fold ran per ray that reaches a traversal
domain's root: the program's counter ``traverse.slices`` (the 32-lane
slices of a cluster that a warp of 32 rays ran, the others skipped by the
fold's slice cull) times 32 x 32, over its counter ``traverse.live_rays``,
in the span render (``spans.py``). None on a tree whose fold counts no
slices."""

from portbench import spans

RAYS_PER_WARP = 32
TRIANGLES_PER_SLICE = 32


def read(ctx):
    spans.ensure(ctx)
    c = ctx.counters
    if not c or not c.get("traverse.live_rays") or "traverse.slices" not in c:
        return None
    return (c["traverse.slices"] * RAYS_PER_WARP * TRIANGLES_PER_SLICE
            / c["traverse.live_rays"])
