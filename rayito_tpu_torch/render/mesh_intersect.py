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

The kernel route's tiny transformed meshes (``SceneData.ktab_small``, at
most 4 x 48 triangles each), which would pay a whole sort, mask and
traversal launch of their own, fold densely instead: :func:`fold_small`
takes every one of them for one query in one launch (``csrc/fold_small.cu``
on the card), each lane evaluating each mesh's keyed transform chain at
its time, taking its ray to the mesh's local space and testing the mesh's
triangles below the nearest hit so far. Its plain twin,
:func:`fold_small_query_plain`, is the loop over the meshes in
``ktab_small`` order (the reference's ``rayito_tpu/render/trace.py:628-650``):
the chain by ``ops/transform.py``, then :func:`mesh_fold_small`, one [N, T]
Möller-Trumbore over the mesh's rows of ``tri_vert_rows``
(``fold_small_plain`` in ``render/traverse.py``). The reference sends these
meshes down the pipeline, whose result is the fold's there: at most four
real clusters in one supercluster never truncate.
"""

from __future__ import annotations

import ctypes

import torch

from ..accel.clusters import CLUSTERS_PER_SUPER, TRI_PER_CLUSTER
from ..ops import quaternion as quat
from ..ops import transform as xf
from ..ops.intersect import INF, triangle_intersect
from ..ops.vec3 import V3
from ..utils import cuda_lib, tracing
from .traverse import (K1_SUPERS, K2_CLUSTERS, box_slab, cluster_pipeline,
                       fold_small_plain, gather_rows_t)

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
    ``any_hit`` beta and gamma are zeros and t is the pipeline's."""
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


def mesh_fold_small(scene, mi: int, o: V3, d: V3, tmin, tmax,
                    first: bool = False):
    """Nearest hit of tiny mesh ``mi`` (at most 4 x 48 triangles) for its
    local-space rays o, d (V3 of [N]) below ``tmax`` ([N] or scalar), by
    the dense fold over its padded rows (``fold_small_plain``). Returns
    (t [N], prim [N] global triangle id or -1, beta [N], gamma [N]); ties
    go to the lowest triangle. With ``first``, also the row of each lane's
    first hit in row order ([N] int64, -1 on a miss): where an any-hit
    lane of the kernel stops."""
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
    return fold_small_plain(rows, tri0, o, d, tmin, tmax, first=first)


def fold_small_query_plain(scene, o: V3, d: V3, time, tmin, tmax,
                           best=None, occluded=None):
    """The tiny meshes of one query (``scene.ktab_small``), mesh by mesh in
    that order, for the world rays o, d (V3 of [N]) at the lanes' ``time``
    ([N], None for a static scene) below ``tmax`` ([N]).

    Closest hit, ``best`` = (t [N], prim [N] i32, beta [N], gamma [N],
    rot: the winner's world-from-local Quat of [N], or None for a static
    scene): each mesh is queried below min(t, tmax) in its local space and
    replaces the best where it hits (prim >= 0), the rotation with it.
    Returns the merged ``best``. Any hit, ``occluded`` [N] bool: each mesh
    is queried below tmax where the lane is not occluded yet (0 where it
    is). Returns ``occluded`` or'ed with the meshes' hits.

    With tracing on it adds what the kernel counts, keyed by the query's
    kind: ``fold_small.lanes.closest`` or ``.any`` (the lanes times the
    kernel's launches), ``fold_small.tests.closest`` (every real row of
    every mesh a lane) or ``.any`` (a lane's rows up to its first hit: the
    kernel's lane stops there), and ``fold_small.links`` (each lane's chain
    links, on an any-hit query only the meshes it reaches still open)."""
    counting = tracing.enabled()
    n = o.x.shape[0]
    if counting:
        tracing.count("fold_small.lanes."
                      + ("any" if occluded is not None else "closest"),
                      n * len(_launch_cuts(scene)), where=o.x)
    if occluded is not None:
        tests = links = 0
        for mi in scene.ktab_small:
            o_l, d_l, _ = xf.local_ray(scene, scene.mesh_xf_host[mi], o, d,
                                       time)
            tq = torch.where(occluded, 0.0, tmax)
            hit = mesh_fold_small(scene, mi, o_l, d_l, tmin, tq,
                                  first=counting)
            if counting:
                open_ = ~occluded
                count = scene.mesh_tri_ranges[mi][1]
                tests = tests + torch.where(
                    open_, torch.where(hit[4] >= 0, hit[4] + 1, count),
                    0).sum()
                links = links + open_.sum() * len(_chain(scene, mi))
            occluded = occluded | (hit[1] >= 0)
        if counting:
            tracing.count("fold_small.tests.any", tests)
            tracing.count("fold_small.links", links)
        return occluded
    if counting:
        tracing.count("fold_small.tests.closest", n * sum(
            scene.mesh_tri_ranges[mi][1] for mi in scene.ktab_small),
            where=o.x)
        tracing.count("fold_small.links", n * sum(
            len(_chain(scene, mi)) for mi in scene.ktab_small), where=o.x)
    t_best, prim_best, beta_best, gamma_best, rot_best = best
    for mi in scene.ktab_small:
        o_l, d_l, rot = xf.local_ray(scene, scene.mesh_xf_host[mi], o, d,
                                     time)
        cap = torch.minimum(t_best, tmax)
        t_m, prim_m, beta_m, gamma_m = mesh_fold_small(scene, mi, o_l, d_l,
                                                       tmin, cap)
        closer = prim_m >= 0
        t_best = torch.where(closer, t_m, t_best)
        prim_best = torch.where(closer, prim_m, prim_best)
        beta_best = torch.where(closer, beta_m, beta_best)
        gamma_best = torch.where(closer, gamma_m, gamma_best)
        if rot_best is not None:
            rot_best = quat.where(closer, rot or quat.IDENTITY, rot_best)
    return t_best, prim_best, beta_best, gamma_best, rot_best


# csrc/fold_small.cu's limits per launch: meshes, rows and chain links (a
# query with more launches again, each launch folding into the last one's
# result; a chain has at most FOLD_MAX_LINKS links)
FOLD_MAX_MESHES = 64
FOLD_MAX_ROWS = 1024
FOLD_MAX_LINKS = 512


class _FoldMesh(ctypes.Structure):
    """One tiny mesh of a launch: its first row of ``tri_vert_rows`` (its
    global triangle id 0), its real triangles, and its transform chain,
    ``depth`` slots of the spec's ``slots`` from ``link0``, outermost first
    (depth 0: no transform)."""
    _fields_ = [("row0", ctypes.c_int32), ("count", ctypes.c_int32),
                ("link0", ctypes.c_int32), ("depth", ctypes.c_int32)]


class _FoldSpec(ctypes.Structure):
    """A launch's meshes, in fold order, and their chains' slots, passed
    to the kernel by value."""
    _fields_ = [("n_mesh", ctypes.c_int32), ("rows", ctypes.c_int32),
                ("k", ctypes.c_int32), ("n_link", ctypes.c_int32),
                ("mesh", _FoldMesh * FOLD_MAX_MESHES),
                ("slots", ctypes.c_int32 * FOLD_MAX_LINKS)]


def _chain(scene, mi: int) -> list:
    """Mesh ``mi``'s transform slots, outermost first ([] where nothing
    moves)."""
    return xf.chain_slots(scene, scene.mesh_xf_host[mi])


def _launch_cuts(scene) -> list:
    """``scene.ktab_small`` cut into the kernel's launches: lists of mesh
    ids, at most FOLD_MAX_MESHES meshes, FOLD_MAX_ROWS rows and
    FOLD_MAX_LINKS chain links each. Refuses a mesh the kernel does not
    take: outside 1-192 triangles, or a chain past FOLD_MAX_LINKS."""
    cuts, rows, links = [], 0, 0
    for mi in scene.ktab_small:
        count = scene.mesh_tri_ranges[mi][1]
        depth = len(_chain(scene, mi))
        if (not 1 <= count <= BRUTE_FORCE_CLUSTERS * TRI_PER_CLUSTER
                or depth > FOLD_MAX_LINKS):
            raise ValueError(
                f"fold_small: mesh {mi} has {count} triangles and a chain "
                f"of {depth} transforms; the kernel takes 1-192 and at most "
                f"{FOLD_MAX_LINKS}")
        if (not cuts or len(cuts[-1]) == FOLD_MAX_MESHES
                or rows + count > FOLD_MAX_ROWS
                or links + depth > FOLD_MAX_LINKS):
            cuts.append([])
            rows = links = 0
        cuts[-1].append(mi)
        rows += count
        links += depth
    return cuts


def _fold_specs(scene) -> list:
    """The kernel's launches (``_launch_cuts``) as specs. Each mesh tests
    only its real triangles: the rows past them are all zero, so det = 0
    there and they never hit."""
    specs = []
    for cut in _launch_cuts(scene):
        spec = _FoldSpec(n_mesh=0, rows=0, k=int(scene.xf_times.shape[1]),
                         n_link=0)
        specs.append(spec)
        for mi in cut:
            row0, count = scene.mesh_tri_ranges[mi]
            chain = _chain(scene, mi)
            spec.mesh[spec.n_mesh] = _FoldMesh(row0, count, spec.n_link,
                                               len(chain))
            for j, s in enumerate(chain):
                spec.slots[spec.n_link + j] = s
            spec.n_mesh += 1
            spec.rows += count
            spec.n_link += len(chain)
    return specs


@cuda_lib.counted
def fold_small(scene, o: V3, d: V3, time, tmin, tmax, best=None,
               occluded=None):
    """Kernel wrapper of :func:`fold_small_query_plain` (same contract):
    every tiny mesh of the query in one launch (``csrc/fold_small.cu``),
    each lane's transform chains evaluated inside it. With tracing on the
    kernel adds the twin's counters on the device."""
    name = "fold_small"
    if (best is None) == (occluded is None):
        raise ValueError(f"{name}: give best (closest hit) or occluded "
                         "(any hit)")
    n = o.x.shape[0]
    motion = scene.has_motion
    rays = (o.x, o.y, o.z, d.x, d.y, d.z, tmax)
    if best is not None:
        t_b, p_b, b_b, g_b, rot = best
        state = (t_b, p_b, b_b, g_b)
        if (rot is None) == motion:
            raise ValueError(f"{name}: a rotation per lane where, and only "
                             "where, the scene moves")
        if rot is not None:
            state += (rot.w, rot.v.x, rot.v.y, rot.v.z)
    else:
        state = (occluded,)
    lanes = rays + state + ((time,) if motion else ())
    if any(t.shape != (n,) for t in lanes):
        raise ValueError(f"{name}: rays, tmax, time and the state must be "
                         "[N]")
    tensors = lanes + (scene.tri_vert_rows,)
    if cuda_lib.on_cpu(name, *tensors):
        return fold_small_query_plain(scene, o, d, time, tmin, tmax, best,
                                      occluded)
    if not isinstance(tmin, (int, float)):
        raise ValueError(f"{name}: tmin must be a Python number")
    dtypes = ([torch.float32] * 7 + ([torch.float32, torch.int32]
                                     + [torch.float32] * (len(state) - 2)
                                     if best is not None else [torch.bool])
              + [torch.float32] * motion)
    if any(t.dtype != dt for t, dt in zip(lanes, dtypes)):
        raise ValueError(f"{name}: f32 rays, tmax, time and t / beta / gamma "
                         "/ rotation, i32 prim, bool occluded expected")
    specs = _fold_specs(scene)
    lanes = tuple(t.contiguous() for t in lanes)
    tables = (scene.tri_vert_rows, scene.xf_times, scene.xf_translate,
              scene.xf_scale, scene.xf_rotate, scene.xf_nkeys)
    lib, stream = cuda_lib.launch_args(name, *lanes, *tables)
    dev = o.x.device
    f32 = dict(dtype=torch.float32, device=dev)
    rays, state = lanes[:7], lanes[7:7 + len(state)]
    t_lane = lanes[7 + len(state)].data_ptr() if motion else None
    kind = "closest" if best is not None else "any"
    counters = tuple(tracing.counter_ptr(c, dev) for c in (
        f"fold_small.tests.{kind}", "fold_small.links",
        f"fold_small.lanes.{kind}"))
    for spec in specs:
        if best is not None:
            rot_out = torch.empty((4, n), **f32) if motion else None
            outs = (torch.empty((n,), **f32),
                    torch.empty((n,), dtype=torch.int32, device=dev),
                    torch.empty((n,), **f32), torch.empty((n,), **f32),
                    *(rot_out if motion else ()))
            io = (*(t.data_ptr() for t in state),
                  *(None,) * (8 - len(state)), None,
                  *(t.data_ptr() for t in outs[:4]),
                  rot_out.data_ptr() if motion else None, None)
        else:
            outs = (torch.empty((n,), dtype=torch.bool, device=dev),)
            io = (None,) * 8 + (state[0].data_ptr(),) + (None,) * 5 + (
                outs[0].data_ptr(),)
        if n:
            cuda_lib.check(lib.rt_fold_small(
                ctypes.byref(spec), *(t.data_ptr() for t in tables),
                *(t.data_ptr() for t in rays), t_lane, float(tmin), *io,
                *counters, n, stream), name)
            cuda_lib.count_launch(fold_small, dev)
        state = outs
    if best is None:
        return state[0]
    rot = quat.Quat(state[4], V3(*state[5:8])) if motion else None
    return (*state[:4], rot)
