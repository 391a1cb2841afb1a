"""Mesh intersection off the kernel route (counterpart of
``rayito_tpu/render/mesh_intersect.py``): the reference's two-level
cluster pipeline, and the dense fold of the tiny transformed meshes.

:func:`mesh_intersect_clusters` is the ``traversal='xla'`` route's whole
mesh query, with the reference's contract (``accel/clusters.py`` has the
tables):

  1. every ray against every supercluster box of the mesh, one dense
     [N, S] slab test;
  2. the rays with a candidate are compacted; each keeps its nearest
     K1_SUPERS = 16 superclusters, tests their 16 children's boxes from one
     gathered ``sc_rows`` row each, and keeps its nearest K2_CLUSTERS = 24
     clusters;
  3. one dense Möller-Trumbore over the [R, k2, 48] triangles of those
     clusters' ``tri_rows``, the argmin in candidate order (ties to the
     first candidate), and the winning triangle's global id;
  4. the winner re-tested exactly from its ``tri_vert_rows`` row
     (``gather_rows_t``, the hand kernel on the card), which gives t and
     the barycentrics. Any-hit queries stop before it.

"Nearest K" is a stable ascending sort of (t, index) cut after K: the
order of ``jax.lax.top_k`` on ties (lower index first), which decides
which boxes survive a truncation. ``overflow`` counts what the truncation
drops: per ray max(#superclusters entered - K1, 0) + max(#clusters entered
- K2, 0). The reference processes its compacted rays in blocks of R =
max(256, min(4096, N // 4)) slots; when the last block runs, its pad slots
hold lane 0 and add lane 0's count once each. Results per ray do not
depend on the blocking, so the port processes the compacted rays in
chunks of its own (RAY_CHUNK) and adds that count explicitly.

The compaction reads the number of rays with a candidate on the host: one
synchronisation per mesh query (the reference's loop stops on the
device). The kernel route never runs this module's pipeline.

The dense fold (:func:`mesh_fold_small`) serves the kernel route's tiny
transformed meshes (``SceneData.ktab_small``, at most 4 x 48 triangles),
which would pay a whole sort, mask and traversal launch of their own: one
[N, T] Möller-Trumbore over the mesh's rows of ``tri_vert_rows``. The
reference sends them down the pipeline, whose result is the fold's there:
at most four real clusters in one supercluster never truncate.
"""

from __future__ import annotations

import torch

from ..accel.clusters import CLUSTERS_PER_SUPER, TRI_PER_CLUSTER
from ..ops.intersect import INF, triangle_intersect
from ..ops.vec3 import V3
from .traverse import gather_rows_t

K1_SUPERS = 16  # superclusters kept per ray (nearest first)
K2_CLUSTERS = 24  # clusters kept per ray (nearest first)
PAIR_CHUNKS = 4  # the reference's block: R = max(256, min(4096, N // 4))
# compacted rays per chunk: the [chunk, 24, 512] f32 triangle gather is
# 805 MB on the card
RAY_CHUNK = 16384
BRUTE_FORCE_CLUSTERS = 4  # ktab_small: meshes of at most 4 x 48 triangles


def _slab6(ox, oy, oz, ix, iy, iz, tmin, tmax, bx0, by0, bz0, bx1, by1, bz1):
    """Component-wise slab test; entry t or INF. torch.maximum / minimum
    propagate the NaN of 0 * inf (an axis-parallel ray on a box plane),
    which then fails ``t0 <= t1`` as in the reference. ``tmin`` is a
    number or a 0-dim tensor."""
    tx0 = (bx0 - ox) * ix
    tx1 = (bx1 - ox) * ix
    ty0 = (by0 - oy) * iy
    ty1 = (by1 - oy) * iy
    tz0 = (bz0 - oz) * iz
    tz1 = (bz1 - oz) * iz
    near = torch.maximum(
        torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
        torch.minimum(tz0, tz1))
    far = torch.minimum(
        torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
        torch.maximum(tz0, tz1))
    t0 = torch.maximum(near, tmin)
    t1 = torch.minimum(far, tmax)
    return torch.where(t0 <= t1, t0, INF)


def nearest_k(t, k: int):
    """(t, index) of the k smallest entries of each row of t, ascending,
    ties to the lower index (``jax.lax.top_k(-t, k)``'s order)."""
    t_sorted, order = torch.sort(t, dim=1, stable=True)
    return t_sorted[:, :k], order[:, :k]


def _box_slab(o: V3, inv: V3, tmin, tmax, lo, hi):
    """_slab6 of rays [R] against boxes whose components are trailing
    dims of ``lo`` / ``hi`` V3s."""
    ex = (slice(None),) + (None,) * (lo.x.dim() - 1)
    if not torch.is_tensor(tmin):  # a CPU scalar: no copy to the card
        tmin = torch.tensor(tmin, dtype=torch.float32)
    return _slab6(o.x[ex], o.y[ex], o.z[ex], inv.x[ex], inv.y[ex], inv.z[ex],
                  tmin, tmax[ex], lo.x, lo.y, lo.z, hi.x, hi.y, hi.z)


def _chunk(scene, mi: int, t_sc, o: V3, d: V3, tmin, tmax, k1: int,
           k2: int):
    """Phases 2-3 for the compacted rays o, d [R] with their phase-1 rows
    t_sc [R, S]: (t [R], global prim [R], overflow per ray [R])."""
    sc0 = scene.mesh_sc_ranges[mi][0]
    cl0 = scene.mesh_cl_ranges[mi][0]
    tri0 = scene.mesh_tri_ranges[mi][0]
    n_r = t_sc.shape[0]
    inv = V3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    T = TRI_PER_CLUSTER

    # phase 2: the nearest k1 superclusters' children, from packed rows
    t1, sc_idx = nearest_k(t_sc, k1)
    ovf = torch.clamp_min(torch.isfinite(t_sc).sum(1) - k1, 0)
    rows = scene.sc_rows[sc0 + sc_idx]  # [R, k1, 128]
    col = lambda c: rows[:, :, c * 16:(c + 1) * 16]
    t_cl = _box_slab(o, inv, tmin, tmax, V3(col(0), col(1), col(2)),
                     V3(col(3), col(4), col(5)))
    t_cl = torch.where((t1 < INF)[:, :, None], t_cl, INF).reshape(
        n_r, k1 * CLUSTERS_PER_SUPER)
    ovf = ovf + torch.clamp_min((t_cl < INF).sum(1) - k2, 0)
    t2, cand = nearest_k(t_cl, k2)  # slots into k1 * 16
    sc_sel = sc_idx.gather(1, cand >> 4)
    cl_sel = sc_sel * CLUSTERS_PER_SUPER + (cand & 15)

    # phase 3: Möller-Trumbore over the candidates' 48-triangle rows, in
    # the reference's formulation
    trows = scene.tri_rows[cl0 + cl_sel]  # [R, k2, 512]
    comp = lambda b: trows[:, :, b * T:(b + 1) * T]  # [R, k2, 48]
    v0x, v0y, v0z = comp(0), comp(1), comp(2)
    v1x, v1y, v1z = comp(3), comp(4), comp(5)
    v2x, v2y, v2z = comp(6), comp(7), comp(8)
    ex = (slice(None), None, None)
    dx, dy, dz = d.x[ex], d.y[ex], d.z[ex]
    ox, oy, oz = o.x[ex], o.y[ex], o.z[ex]
    e1x, e1y, e1z = v1x - v0x, v1y - v0y, v1z - v0z
    e2x, e2y, e2z = v2x - v0x, v2y - v0y, v2z - v0z
    gnx = e1y * e2z - e1z * e2y
    gny = e1z * e2x - e1x * e2z
    gnz = e1x * e2y - e1y * e2x
    det = -(dx * gnx + dy * gny + dz * gnz)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    t0x, t0y, t0z = v0x - ox, v0y - oy, v0z - oz
    rcx = dy * t0z - dz * t0y
    rcy = dz * t0x - dx * t0z
    rcz = dx * t0y - dy * t0x
    t1x, t1y, t1z = v1x - ox, v1y - oy, v1z - oz
    gamma = -(t1x * rcx + t1y * rcy + t1z * rcz) * inv_det
    t2x, t2y, t2z = v2x - ox, v2y - oy, v2z - oz
    beta = (t2x * rcx + t2y * rcy + t2z * rcz) * inv_det
    t = -(t0x * gnx + t0y * gny + t0z * gnz) * inv_det
    hit = ((det != 0.0) & (gamma >= 0.0) & (gamma <= 1.0) & (beta >= 0.0)
           & (beta + gamma <= 1.0) & (t >= tmin) & (t < tmax[ex])
           & (t2 < INF)[:, :, None])
    t_tri = torch.where(hit, t, INF).reshape(n_r, k2 * T)
    arg = torch.argmin(t_tri, dim=1, keepdim=True)  # all-INF rows: 0
    cl_win = cl_sel.gather(1, arg // T)[:, 0]
    prim = (tri0 + cl_win * T + arg[:, 0] % T).to(torch.int32)
    return t_tri.gather(1, arg)[:, 0], prim, ovf


def mesh_intersect_clusters(scene, mi: int, o: V3, d: V3, tmin, tmax,
                            any_hit: bool = False):
    """Nearest hit of mesh ``mi`` for its local-space rays o, d (V3 of
    [N]) below ``tmax`` ([N] or scalar), through the two-level cluster
    pipeline. Returns (t [N], prim [N] global triangle id or -1, beta [N],
    gamma [N], overflow: an int64 scalar tensor on the rays' device). With
    ``any_hit`` beta and gamma are zeros and t is the pipeline's. A
    profiler range of this name spans the call (``utils/profiling.py``
    rolls its kernels up)."""
    with torch.profiler.record_function("mesh_intersect_clusters"):
        return _mesh_intersect_clusters(scene, mi, o, d, tmin, tmax, any_hit)


def _mesh_intersect_clusters(scene, mi, o: V3, d: V3, tmin, tmax, any_hit):
    sc0, n_sc = scene.mesh_sc_ranges[mi]
    n = o.x.shape[0]
    dev = o.x.device
    if not torch.is_tensor(tmax):  # filled on the device: no copy to wait on
        tmax = torch.full((n,), float(tmax), device=dev)
    tmax = tmax.to(torch.float32).expand(n)
    k1 = min(n_sc, K1_SUPERS)
    k2 = min(k1 * CLUSTERS_PER_SUPER, K2_CLUSTERS)

    # phase 1: every ray against every supercluster box
    inv = V3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    sc_lo = scene.sc_min[sc0:sc0 + n_sc]
    sc_hi = scene.sc_max[sc0:sc0 + n_sc]
    box = lambda b: V3(b[None, :, 0], b[None, :, 1], b[None, :, 2])
    t_sc = _box_slab(o, inv, tmin, tmax, box(sc_lo), box(sc_hi))  # [N, S]

    # compaction: the rays with a candidate, in lane order
    active = torch.nonzero(torch.isfinite(t_sc).any(1)).squeeze(1)
    n_active = active.shape[0]  # the host read
    t_best = torch.full((n,), INF, device=dev)
    prim_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    ovf_lane0 = None
    for c0 in range(0, n_active, RAY_CHUNK):
        lanes = active[c0:c0 + RAY_CHUNK]
        t_c, p_c, ovf = _chunk(scene, mi, t_sc[lanes], o[lanes], d[lanes],
                               tmin, tmax[lanes], k1, k2)
        t_best[lanes] = t_c
        prim_best[lanes] = p_c
        overflow = overflow + ovf.sum()
        if ovf_lane0 is None:  # lane 0 is the first active lane if active
            ovf_lane0 = torch.where(lanes[0] == 0, ovf[0], 0)
    # the reference's pad slots: lane 0 once each, when its last block runs
    r = max(256, min(4096, n // PAIR_CHUNKS))
    max_blocks = -(-n // r)
    pad_slots = max_blocks * r - n
    if pad_slots and (max_blocks - 1) * r < n_active:
        overflow = overflow + pad_slots * ovf_lane0

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
    one dense [N, T] Möller-Trumbore. Returns (t [N], prim [N] global
    triangle id or -1, beta [N], gamma [N]); ties go to the lowest
    triangle."""
    tri0, count = scene.mesh_tri_ranges[mi]
    n_cl = max(1, -(-count // TRI_PER_CLUSTER))
    if n_cl > BRUTE_FORCE_CLUSTERS:
        raise ValueError(f"mesh {mi}: {count} triangles; the dense fold "
                         "takes at most 192")
    rows = scene.tri_vert_rows[tri0:tri0 + n_cl * TRI_PER_CLUSTER]  # [T, 16]
    vert = lambda k: V3(rows[None, :, k], rows[None, :, k + 1],
                        rows[None, :, k + 2])
    n = o.x.shape[0]
    if not torch.is_tensor(tmax):  # filled on the device: no copy to wait on
        tmax = torch.full((n,), float(tmax), device=o.x.device)
    tmax = tmax.to(torch.float32).expand(n)
    t, _, beta, gamma, _ = triangle_intersect(
        o[:, None], d[:, None], tmin, tmax[:, None], vert(0), vert(3),
        vert(6))
    j = torch.argmin(t, dim=1, keepdim=True)  # the first of tied minima
    t_best = t.gather(1, j)[:, 0]
    prim = torch.where(torch.isfinite(t_best), tri0 + j[:, 0].to(torch.int32),
                       -1).to(torch.int32)
    return t_best, prim, beta.gather(1, j)[:, 0], gamma.gather(1, j)[:, 0]
