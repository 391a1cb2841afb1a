"""Mesh intersection off the kernel route (counterpart of
``rayito_tpu/render/mesh_intersect.py``): the reference's two-level
cluster pipeline, and the dense fold of the tiny transformed meshes.

:func:`mesh_intersect_clusters` is the ``traversal='xla'`` route's whole
mesh query, with the reference's contract (``accel/clusters.py`` has the
tables):

  1. every ray against every supercluster box of the mesh, one dense
     [N, S] slab test;
  2. the rays with a candidate are compacted to the front of a slot order
     (lanes ascending), their count kept on the device;
  3. ``cluster_pipeline`` (``render/traverse.py``, the hand kernel on the
     card) runs the reference's loop body on every slot: each compacted
     ray keeps its nearest K1_SUPERS = 16 superclusters, tests their 16
     children's boxes from one ``sc_rows`` row each, keeps its nearest
     K2_CLUSTERS = 24 clusters, and tests their 48 triangles from
     ``tri_rows`` (Möller-Trumbore, the argmin in candidate order, ties to
     the first candidate); the results go back to lane order;
  4. the winner re-tested exactly from its ``tri_vert_rows`` row
     (``gather_rows_t``, the hand kernel on the card), which gives t and
     the barycentrics. Any-hit queries stop before it.

"Nearest K" is a stable ascending order of (t, index) cut after K: the
order of ``jax.lax.top_k`` on ties (lower index first), which decides
which boxes survive a truncation. ``overflow`` counts what the truncation
drops: per ray max(#superclusters entered - K1, 0) + max(#clusters entered
- K2, 0). The reference processes its compacted rays in blocks of R =
max(256, min(4096, N // 4)) slots in a ``while_loop`` that stops on the
device; when the last block runs, its pad slots hold lane 0 and add lane
0's count once each. Results per ray do not depend on the blocking, so the
kernel covers every slot in one launch (slots at or past the count return
at once) and that count is added explicitly. Nothing in a query reads the
device back, so a pass of the route is captured as a CUDA graph like any
other (``utils/graphs.py``).

The dense fold (:func:`mesh_fold_small`) serves the kernel route's tiny
transformed meshes (``SceneData.ktab_small``, at most 4 x 48 triangles),
which would pay a whole sort, mask and traversal launch of their own: one
[N, T] Möller-Trumbore over the mesh's rows of ``tri_vert_rows``
(``fold_small`` in ``render/traverse.py``, the hand kernel on the card). The
reference sends them down the pipeline, whose result is the fold's there:
at most four real clusters in one supercluster never truncate.
"""

from __future__ import annotations

import torch

from ..accel.clusters import CLUSTERS_PER_SUPER, TRI_PER_CLUSTER
from ..ops.intersect import INF, triangle_intersect
from ..ops.vec3 import V3
from .traverse import (K1_SUPERS, K2_CLUSTERS, box_slab, cluster_pipeline,
                       fold_small, gather_rows_t)

PAIR_CHUNKS = 4  # the reference's block: R = max(256, min(4096, N // 4))
BRUTE_FORCE_CLUSTERS = 4  # ktab_small: meshes of at most 4 x 48 triangles


def pipeline_inputs(scene, mi: int, o: V3, d: V3, tmin, tmax):
    """Phase 1 and the compaction of mesh ``mi``'s query for the
    local-space rays o, d (V3 of [N]) below tmax ([N] f32): (the keyword
    arguments of ``cluster_pipeline``, the slot of each lane [N] i32).
    The slot order puts the lanes with a candidate first, both parts in
    lane order (the reference's stable sort of ``where(has_cand, lane,
    2**31 - 1)``); their count ``n_active`` stays on the device."""
    sc0, n_sc = scene.mesh_sc_ranges[mi]
    cl0, n_cl = scene.mesh_cl_ranges[mi]
    n = o.x.shape[0]
    inv = V3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    sc_lo = scene.sc_min[sc0:sc0 + n_sc]
    sc_hi = scene.sc_max[sc0:sc0 + n_sc]
    box = lambda b: V3(b[None, :, 0], b[None, :, 1], b[None, :, 2])
    t_sc = box_slab(o, inv, tmin, tmax, box(sc_lo), box(sc_hi))  # [N, S]
    has_cand = torch.isfinite(t_sc).any(1)
    before = torch.cumsum(has_cand, 0, dtype=torch.int32)  # lane included
    dev = o.x.device
    n_active = (before[n - 1] if n else
                torch.zeros((), dtype=torch.int32, device=dev))
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    slot = torch.where(has_cand, before - 1, n_active + lane - before)
    ray_of_slot = torch.empty_like(lane).scatter_(0, slot.long(), lane)
    k1 = min(n_sc, K1_SUPERS)
    args = dict(ray_of_slot=ray_of_slot, n_active=n_active, o=o, d=d,
                tmax=tmax, tmin=tmin, t_sc=t_sc,
                sc_rows=scene.sc_rows[sc0:sc0 + n_sc],
                tri_rows=scene.tri_rows[cl0:cl0 + n_cl], k1=k1,
                k2=min(k1 * CLUSTERS_PER_SUPER, K2_CLUSTERS),
                tri0=scene.mesh_tri_ranges[mi][0])
    return args, slot


def mesh_intersect_clusters(scene, mi: int, o: V3, d: V3, tmin, tmax,
                            any_hit: bool = False):
    """Nearest hit of mesh ``mi`` for its local-space rays o, d (V3 of
    [N]) below ``tmax`` ([N] or scalar), through the two-level cluster
    pipeline. Returns (t [N], prim [N] global triangle id or -1, beta [N],
    gamma [N], overflow: an int64 scalar tensor on the rays' device). With
    ``any_hit`` beta and gamma are zeros and t is the pipeline's. In an
    eager pass a profiler range of this name spans the call
    (``utils/profiling.py`` rolls its kernels up)."""
    with torch.profiler.record_function("mesh_intersect_clusters"):
        return _mesh_intersect_clusters(scene, mi, o, d, tmin, tmax, any_hit)


def _mesh_intersect_clusters(scene, mi, o: V3, d: V3, tmin, tmax, any_hit):
    n = o.x.shape[0]
    dev = o.x.device
    if not torch.is_tensor(tmax):  # filled on the device: no copy to wait on
        tmax = torch.full((n,), float(tmax), device=dev)
    tmax = tmax.to(torch.float32).expand(n).contiguous()
    o, d = (V3(v.x.contiguous(), v.y.contiguous(), v.z.contiguous())
            for v in (o, d))

    args, slot = pipeline_inputs(scene, mi, o, d, tmin, tmax)
    t_slot, prim_slot, ovf_slot = cluster_pipeline(**args)
    t_best = t_slot.index_select(0, slot)  # back to lane order
    prim_best = prim_slot.index_select(0, slot)
    overflow = ovf_slot.sum()
    # the reference's pad slots: lane 0 once each, when its last block runs
    r = max(256, min(4096, n // PAIR_CHUNKS))
    max_blocks = -(-n // r)
    pad_slots = max_blocks * r - n
    if pad_slots:
        ovf_lane0 = ovf_slot.index_select(0, slot[:1])[0].long()
        overflow = overflow + torch.where(
            args["n_active"] > (max_blocks - 1) * r, pad_slots * ovf_lane0, 0)

    hit_mask = torch.isfinite(t_best) & (t_best < tmax) & (prim_best >= 0)
    if any_hit:
        zero = torch.zeros((n,), device=dev)
        return (torch.where(hit_mask, t_best, INF),
                torch.where(hit_mask, prim_best, -1), zero, zero, overflow)
    # the winner's barycentrics: one gathered, transposed vertex row
    vrow = gather_rows_t(scene.tri_vert_rows, torch.clamp_min(prim_best, 0))
    t_fin, h_fin, beta, gamma, _ = triangle_intersect(
        o, d, tmin, torch.full((n,), INF, device=dev),
        V3(vrow[0], vrow[1], vrow[2]), V3(vrow[3], vrow[4], vrow[5]),
        V3(vrow[6], vrow[7], vrow[8]))
    ok = hit_mask & h_fin
    return (torch.where(ok, t_fin, INF), torch.where(ok, prim_best, -1),
            beta, gamma, overflow)


def mesh_fold_small(scene, mi: int, o: V3, d: V3, tmin, tmax):
    """Nearest hit of tiny mesh ``mi`` (at most 4 x 48 triangles) for its
    local-space rays o, d (V3 of [N]) below ``tmax`` ([N] or scalar), by
    the dense fold (``fold_small``, the hand kernel on the card). Returns
    (t [N], prim [N] global triangle id or -1, beta [N], gamma [N]); ties
    go to the lowest triangle."""
    tri0, count = scene.mesh_tri_ranges[mi]
    n_cl = max(1, -(-count // TRI_PER_CLUSTER))
    if n_cl > BRUTE_FORCE_CLUSTERS:
        raise ValueError(f"mesh {mi}: {count} triangles; the dense fold "
                         "takes at most 192")
    rows = scene.tri_vert_rows[tri0:tri0 + n_cl * TRI_PER_CLUSTER]  # [T, 16]
    n = o.x.shape[0]
    if not torch.is_tensor(tmax):  # filled on the device: no copy to wait on
        tmax = torch.full((n,), float(tmax), device=o.x.device)
    tmax = tmax.to(torch.float32).expand(n).contiguous()
    o, d = (V3(v.x.contiguous(), v.y.contiguous(), v.z.contiguous())
            for v in (o, d))
    return fold_small(rows, tri0, o, d, tmin, tmax)
