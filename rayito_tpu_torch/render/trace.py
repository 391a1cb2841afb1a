"""Wavefront scene intersection (counterpart of
``rayito_tpu/render/trace.py``).

The analytic shapes (planes, spheres, rects) fold kind by kind over the
whole wavefront. Triangle meshes take the scene's traversal:

  * ``'pallas'``: the kernel traversal (``render/traverse.py``), one
    launch per traversal domain, its transform chain evaluated per lane
    inside ``ray_pack``, whose winner is re-tested exactly and
    shaded from one gathered, transposed 32-column row (``gather_rows_t``).
    Tiny transformed meshes fold densely, all of a query's in one
    ``fold_small`` launch, their transforms inside it
    (``render/mesh_intersect.py``), and their winners shade from a gathered
    meta row. Nothing truncates: ``overflow`` is 0;
  * ``'xla'``: the two-level cluster pipeline
    (``render/mesh_intersect.py``), mesh by mesh in each mesh's local space
    at the lane's time, each capped at the nearest hit so far; the winner
    shades from a gathered meta row. ``overflow`` counts the candidates its
    K1/K2 truncation dropped; shadow rays take tmax as it is (the kernel
    route rounds it down one 128-ulp key bucket).

Keyed transforms (motion blur): every shape and every transformed domain
sees the ray in its local space at the lane's time; local t is world t.
Normals leave through the winner's world-from-local rotation. Scenes
without motion skip every transform step.

The analytic shapes of a query fold in one launch of ``analytic_fold``
(``csrc/analytic_fold.cu``), each keyed row's transform chain evaluated
per lane inside it. Its plain twin, which CPU tensors take, follows the
reference: the reference unrolls its fold shape by shape, and above 24
shapes of a kind rolls it into a loop over packed rows to keep its compile
time flat. The twin tests the rows of a kind that do not move in one
batched [rows, N] evaluation (``ROLL_CHUNK`` rows at a time) and a batch's
winner is the ``argmin`` over its rows: the nearest hit, ties to the
lowest row, as the unrolled fold's strict ``<`` in ascending order. A row
with a keyed transform is a batch of its own in its local space, in its
place in the row order. The kernel walks the same rows in the same order
under the same strict ``<``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..accel.kernel_tables import KTRI
from ..models.scene import SceneData
from ..ops import transform as xf
from ..ops.brdf import KIND_EMITTER
from ..ops.intersect import (
    INF,
    bullseye_ring,
    plane_intersect,
    rect_intersect,
    sphere_intersect,
    triangle_intersect,
)
from ..ops import quaternion as quat
from ..ops.quaternion import Quat, rotate_vector
from ..ops.vec3 import V3, from_aos, normalize, where as vwhere
from ..utils import cuda_lib, tracing
from .mesh_intersect import fold_small, mesh_intersect_clusters
from .traverse import Chain, gather_rows_t, traverse

# rows per batched [rows, N] evaluation (bounds the temporaries: 32 MB
# each at 131,072 lanes)
ROLL_CHUNK = 64



@dataclasses.dataclass(frozen=True)
class Hit:
    """SoA intersection record."""

    t: torch.Tensor  # [N] f32, inf where no hit
    valid: torch.Tensor  # [N] bool
    shape_id: torch.Tensor  # [N] i32 global shape id; -1 = miss
    mat: torch.Tensor  # [N] i32 material id; -1 = miss
    normal: V3
    color_mod: torch.Tensor  # [N] scalar modifier (bullseye texture)
    # candidates the 'xla' route's K1/K2 truncation dropped (an int64
    # device scalar there, the int 0 on the kernel route); nonzero means
    # a nearest hit MAY have been lost
    overflow: object = 0


def _full(n, value, dtype, device):
    return torch.full((n,), value, dtype=dtype, device=device)


def _lanes(value, n, device):
    """``value`` as [N] f32 on ``device``: a tensor is expanded; a Python
    number fills a new tensor (a tensor made from one would be a
    host-to-device copy, which waits on the device)."""
    if torch.is_tensor(value):
        return value.to(dtype=torch.float32, device=device).expand(n)
    return _full(n, float(value), torch.float32, device)


def _lane_time(scene: SceneData, time, n, device):
    """Per-lane times [N] f32 when the scene moves, else None."""
    if not scene.has_motion:
        return None
    return _lanes(time, n, device)


def _rotate_out(rot, n_local: V3) -> V3:
    return n_local if rot is None else rotate_vector(rot, n_local)


def _identity_rot(n, dev) -> Quat:
    """Per-lane identity rotations (the fold's starting winner)."""
    one = torch.ones((n,), dtype=torch.float32, device=dev)
    return Quat(one, _zeros3(n, dev))


def _zeros3(n, dev) -> V3:
    z = torch.zeros((n,), dtype=torch.float32, device=dev)
    return V3(z, z, z)


def _col(a) -> V3:
    """[R, 3] table rows -> V3 of [R, 1] columns (broadcast over lanes)."""
    return V3(a[:, 0:1], a[:, 1:2], a[:, 2:3])


def _row_batches(scene: SceneData, xf_host, o: V3, d: V3, time):
    """The rows of one kind as batches (r0, r1, o_l, d_l, rot) in ascending
    row order: each run of consecutive rows that do not move against the
    world ray, ``ROLL_CHUNK`` rows at a time; each row with a keyed
    transform alone in its local space (one transform evaluation per
    distinct slot)."""
    moving = [bool(slot) and scene.has_motion for slot in xf_host]
    local = {}
    r0, n_rows = 0, len(xf_host)
    while r0 < n_rows:
        if moving[r0]:
            slot = xf_host[r0]
            if slot not in local:
                local[slot] = xf.local_ray(scene, slot, o, d, time)
            yield (r0, r0 + 1, *local[slot])
            r0 += 1
            continue
        r1 = r0 + 1
        while r1 < min(n_rows, r0 + ROLL_CHUNK) and not moving[r1]:
            r1 += 1
        yield r0, r1, o, d, None
        r0 = r1


def _sphere_rows(scene: SceneData, r0, r1, o: V3, d: V3, tmin, tcur):
    """t [rows, N] of spheres r0..r1 (inf = miss)."""
    return sphere_intersect(o, d, tmin, tcur, _col(scene.sph_center[r0:r1]),
                            scene.sph_radius[r0:r1, None])[0]


def _rect_rows(scene: SceneData, r0, r1, o: V3, d: V3, tmin, tcur):
    """(t [rows, N], viewer-flipped local normal V3 of [rows, N])."""
    t, _, nrm = rect_intersect(
        o, d, tmin, tcur, _col(scene.rect_corner[r0:r1]),
        _col(scene.rect_side1[r0:r1]), _col(scene.rect_side2[r0:r1]))
    return t, nrm


class _RowFold:
    """Closest-hit fold over the row batches of one kind, in ascending row
    order. A batch's winner is its ``argmin`` over rows (the first of tied
    minima) and replaces the running winner only when strictly nearer, so
    ties go to the lowest row. Keeps the winner's row and, with motion, its
    local ray and rotation; ``extra`` V3s (the rect's flipped normal)
    travel with it."""

    def __init__(self, scene: SceneData, o: V3, d: V3, **extra):
        self.n, dev = o.x.shape[0], o.x.device
        self.t = _full(self.n, INF, torch.float32, dev)
        self.idx = torch.zeros((self.n,), dtype=torch.int64, device=dev)
        self.extra = extra
        self.motion = scene.has_motion
        self.o_w, self.d_w = o, d
        self.rot = _identity_rot(self.n, dev) if self.motion else None

    def take(self, r0, t_rows, o_l, d_l, rot, **extra_rows):
        if t_rows.shape[0] == 1:
            row = r0

            def pick(c):
                return c[0]
        else:
            j = torch.argmin(t_rows, dim=0, keepdim=True)
            row = j[0] + r0

            def pick(c):
                return c.gather(0, j)[0]

        t_c = pick(t_rows)
        closer = t_c < self.t
        self.t = torch.where(closer, t_c, self.t)
        self.idx = torch.where(closer, row, self.idx)
        for name, rows in extra_rows.items():
            win = V3(pick(rows.x), pick(rows.y), pick(rows.z))
            self.extra[name] = vwhere(closer, win, self.extra[name])
        if self.motion:
            self.o_w = vwhere(closer, o_l, self.o_w)
            self.d_w = vwhere(closer, d_l, self.d_w)
            self.rot = quat.where(closer, rot or quat.IDENTITY, self.rot)


def _plane_rows(scene: SceneData, r0, r1, o: V3, d: V3, tmin, tcur):
    """t [rows, N] of planes r0..r1 (inf = miss)."""
    return plane_intersect(o, d, tmin, tcur, _col(scene.pln_pos[r0:r1]),
                           _col(scene.pln_normal[r0:r1]))[0]


def _planes_candidate(scene: SceneData, o: V3, d: V3, time, tmin, tmax):
    f = _RowFold(scene, o, d)
    for r0, r1, o_l, d_l, rot in _row_batches(scene, scene.pln_xf_host, o, d,
                                              time):
        f.take(r0, _plane_rows(scene, r0, r1, o_l, d_l, tmin, tmax), o_l,
               d_l, rot)
    t = f.t
    valid = torch.isfinite(t)
    # the bullseye rings are measured at the local hit position
    ring = bullseye_ring(f.o_w + f.d_w * torch.where(valid, t, 0.0),
                         from_aos(scene.pln_pos[f.idx]))
    color_mod = torch.where(scene.pln_bullseye[f.idx] & ring & valid, 0.2,
                            1.0).to(torch.float32)
    return (t, f.idx.to(torch.int32), scene.pln_mat[f.idx],
            _rotate_out(f.rot, from_aos(scene.pln_normal[f.idx])), color_mod)


def _spheres_candidate(scene: SceneData, o: V3, d: V3, time, tmin, tmax):
    """The nearest sphere: its centre and material are gathered from the
    winner's row afterwards, and the normal is rebuilt from the centre."""
    f = _RowFold(scene, o, d)
    for r0, r1, o_l, d_l, rot in _row_batches(scene, scene.sph_xf_host, o, d,
                                              time):
        f.take(r0, _sphere_rows(scene, r0, r1, o_l, d_l, tmin, tmax), o_l,
               d_l, rot)
    t = f.t
    t_safe = torch.where(torch.isfinite(t), t, 0.0)
    normal = normalize(f.o_w + f.d_w * t_safe
                       - from_aos(scene.sph_center[f.idx]))
    return (t, scene.sphere_id0 + f.idx.to(torch.int32), scene.sph_mat[f.idx],
            _rotate_out(f.rot, normal), torch.ones_like(t))


def _rects_candidate(scene: SceneData, o: V3, d: V3, time, tmin, tmax):
    """The nearest rect: the viewer-flipped local normal is the winner's
    own."""
    f = _RowFold(scene, o, d, nrm=_zeros3(o.x.shape[0], o.x.device))
    for r0, r1, o_l, d_l, rot in _row_batches(scene, scene.rect_xf_host, o, d,
                                              time):
        t_rows, nrm_rows = _rect_rows(scene, r0, r1, o_l, d_l, tmin, tmax)
        f.take(r0, t_rows, o_l, d_l, rot, nrm=nrm_rows)
    return (f.t, scene.rect_id0 + f.idx.to(torch.int32),
            scene.rect_mat[f.idx], _rotate_out(f.rot, f.extra["nrm"]),
            torch.ones_like(f.t))


def _rows_occluded(scene: SceneData, xf_host, o: V3, d: V3, time, rows_t,
                   occluded, tests=None):
    """Any-hit over the row batches of one kind, for the lanes not yet
    ``occluded``; ``rows_t(r0, r1, o, d)`` gives t [rows, N]. Returns
    (occluded, tests): with ``tests`` ([N] i64) each open lane's row tests
    added, up to its first hit (the kernel's lane stops there)."""
    for r0, r1, o_l, d_l, _ in _row_batches(scene, xf_host, o, d, time):
        hit = torch.isfinite(rows_t(r0, r1, o_l, d_l))
        any_hit = hit.any(dim=0)
        if tests is not None:
            first = torch.argmax(hit.to(torch.int8), dim=0) + 1
            tests = tests + torch.where(
                occluded, 0, torch.where(any_hit, first, r1 - r0))
        occluded = occluded | any_hit
    return occluded, tests


def _mt_for(scene: SceneData, occlusion: bool) -> str:
    """Per-query triangle test: 'bw_closest' is Baldwin-Weber on closest
    hit (winners are re-tested exactly) and exact MT on occlusion."""
    m = scene.traverse_mt
    if m == "bw_closest":
        return "vpu" if occlusion else "bw"
    return m


def _domain_tri(scene: SceneData, di: int, mt: str):
    return scene.ktab_tri[di] if mt == "vpu" else scene.ktab_mxu[di]


def _launch(scene: SceneData, di: int, o: V3, d: V3, time, tmax, tmin,
            mt: str, sort_rays: bool, any_hit: bool, want_ray: bool = False,
            want_rot: bool = False):
    """Traversal domain ``di``'s ``traverse()`` call on world rays o, d:
    ``ray_pack`` takes each lane into the domain's space through its
    transform chain (``scene.ktab_chain[di]``; empty for a world-space
    domain or a static scene). Returns (prim, o_l, d_l, rot): the ray in
    the domain's space where ``want_ray`` asks (else None; the world ray
    where the domain has no chain) and its world-from-local rotation where
    ``want_rot`` asks (None without a chain)."""
    slots = scene.ktab_chain[di]
    chain = None
    if slots.shape[0]:
        chain = Chain((scene.xf_times, scene.xf_translate, scene.xf_scale,
                       scene.xf_rotate, scene.xf_nkeys), slots, time,
                      want_ray, want_rot)
    out = traverse(
        o, d, tmax, scene.ktab_box[di], _domain_tri(scene, di, mt), tmin,
        slices=scene.ktab_slice[di], chain=chain,
        sort_rays=sort_rays, want_t=False, mt_mode=mt, any_hit=any_hit,
        b=scene.traverse_b, sb=scene.traverse_sb,
        live_prefix=scene.live_prefix, items=scene.traverse_items,
        items_w=scene.items_w, items_max=scene.items_max,
        items_cap=scene.items_cap,
    )
    if chain is None:
        return out[1], o, d, None
    ray, rot = out[2]
    if ray is not None:
        o, d = V3(ray[0], ray[1], ray[2]), V3(ray[3], ray[4], ray[5])
    else:
        o = d = None
    if rot is not None:
        rot = Quat(rot[0], V3(rot[1], rot[2], rot[3]))
    return out[1], o, d, rot


def _winner_retest(scene: SceneData, di: int, o: V3, d: V3, p_d, tmin, tmax,
                   want_meta: bool = False):
    """Exact Möller-Trumbore re-test of the kernel's winner from one
    gathered, transposed row (o, d in the domain's space). Returns (t, ok,
    beta, gamma, g_d[, meta])."""
    found = p_d >= 0
    p_safe = torch.clamp_min(p_d, 0)
    cl = p_safe // KTRI
    g_d = scene.ktab_base[di][cl.long()] + (p_safe - cl * KTRI)
    idx = torch.where(found, g_d, 0).to(torch.int32)
    if want_meta:
        # The reference gathers lane-packed rows tri_vm_packed[idx >> 2]
        # and picks group idx & 3 above 96k triangles
        # (rayito_tpu/render/trace.py:529-543); the [T, 32] table holds the
        # same floats (scene_data_from_arrays rebuilds it from the packed
        # one), so one branch serves both.
        row_t = gather_rows_t(scene.tri_vm_rows, idx)  # [32, N]
        vrow, meta = row_t[:16], row_t[16:]
    else:
        vrow, meta = gather_rows_t(scene.tri_vert_rows, idx), None
    n = p_d.shape[0]
    t_fin, h_fin, beta, gamma, _ = triangle_intersect(
        o, d, tmin, _lanes(tmax, n, o.x.device),
        V3(vrow[0], vrow[1], vrow[2]),
        V3(vrow[3], vrow[4], vrow[5]),
        V3(vrow[6], vrow[7], vrow[8]),
    )
    if want_meta:
        return t_fin, found & h_fin, beta, gamma, g_d, meta
    return t_fin, found & h_fin, beta, gamma, g_d


def _mesh_shading(scene: SceneData, t_best, prim_best, beta, gamma, meta,
                  rot_best):
    """Winner shading from its transposed [16, N] meta rows (gathered here
    when ``meta`` is None): interpolated vertex normals when present, else
    the unit geometric normal, rotated out of the mesh's local space."""
    valid = prim_best >= 0
    if meta is None:
        meta = gather_rows_t(scene.tri_meta_rows,
                             torch.clamp_min(prim_best, 0).to(torch.int32))
    alpha = 1.0 - beta - gamma
    n0 = V3(meta[0], meta[1], meta[2])
    n1 = V3(meta[3], meta[4], meta[5])
    n2 = V3(meta[6], meta[7], meta[8])
    has_n = meta[9] > 0.5
    mesh_idx = meta[11].to(torch.int32)
    gnormal = V3(meta[12], meta[13], meta[14])
    n_interp = n0 * alpha + n1 * beta + n2 * gamma
    normal = _rotate_out(rot_best, vwhere(has_n, normalize(n_interp), gnormal))
    mesh_mat = scene.mesh_mat[mesh_idx.long()]
    return (
        torch.where(valid, t_best, INF),
        torch.where(valid, scene.mesh_id0 + mesh_idx, -1),
        torch.where(valid, mesh_mat, -1),
        normal,
        torch.ones_like(t_best),
    )


def _mesh_candidate(scene: SceneData, o: V3, d: V3, time, tmin, tmax):
    """Mesh intersection, then the shading; returns (candidate, overflow).
    The kernel route launches once per traversal domain, in the domain's
    space, and re-tests the winner exactly, then folds each tiny
    transformed mesh (ktab_small) densely; 'xla' runs every mesh through
    the two-level pipeline. Each mesh alone is queried in its local space
    at the lane's time, capped at the nearest hit so far. A domain's local
    ray, launch, re-test and merge run inside a ``domain`` device span, the
    re-test and the merge inside a ``domain_merge`` one."""
    n, dev = o.x.shape[0], o.x.device
    xla = scene.traversal == "xla"
    t_best = _full(n, INF, torch.float32, dev)
    prim_best = _full(n, -1, torch.int32, dev)
    beta_best = torch.zeros((n,), dtype=torch.float32, device=dev)
    gamma_best = torch.zeros_like(beta_best)
    meta_best = None
    rot_best = _identity_rot(n, dev) if scene.has_motion else None
    mt = _mt_for(scene, occlusion=False)
    for di in range(0 if xla else len(scene.ktab_xf)):
        with tracing.device_span("domain", dev):
            p_d, o_l, d_l, rot = _launch(
                scene, di, o, d, time, torch.minimum(t_best, tmax), tmin, mt,
                sort_rays=True, any_hit=False, want_ray=True, want_rot=True)
            with tracing.device_span("domain_merge", dev):
                t_fin, ok_fin, beta, gamma, g_d, meta = _winner_retest(
                    scene, di, o_l, d_l, p_d, tmin, INF, want_meta=True
                )
                closer = ok_fin & (t_fin < torch.minimum(t_best, tmax))
                t_best = torch.where(closer, t_fin, t_best)
                prim_best = torch.where(closer, g_d, prim_best)
                beta_best = torch.where(closer, beta, beta_best)
                gamma_best = torch.where(closer, gamma, gamma_best)
                meta_best = (meta if meta_best is None
                             else torch.where(closer[None, :], meta,
                                              meta_best))
                if rot_best is not None:
                    rot_best = quat.where(closer, rot or quat.IDENTITY,
                                          rot_best)
    # these winners carry no meta rows: with any such mesh the shading
    # gathers the meta rows of every winner
    overflow = 0
    if not xla and scene.ktab_small:
        meta_best = None
        with tracing.device_span("tiny_mesh_fold", dev):
            t_best, prim_best, beta_best, gamma_best, rot_best = fold_small(
                scene, o, d, time, tmin, tmax,
                best=(t_best, prim_best, beta_best, gamma_best, rot_best))
    for mi in range(scene.n_meshes) if xla else ():
        o_l, d_l, rot = xf.local_ray(scene, scene.mesh_xf_host[mi], o, d,
                                         time)
        t_m, prim_m, beta_m, gamma_m, ovf = mesh_intersect_clusters(
            scene, mi, o_l, d_l, tmin, torch.minimum(t_best, tmax))
        overflow = overflow + ovf
        closer = prim_m >= 0
        t_best = torch.where(closer, t_m, t_best)
        prim_best = torch.where(closer, prim_m, prim_best)
        beta_best = torch.where(closer, beta_m, beta_best)
        gamma_best = torch.where(closer, gamma_m, gamma_best)
        if rot_best is not None:
            rot_best = quat.where(closer, rot or quat.IDENTITY, rot_best)
    return _mesh_shading(scene, t_best, prim_best, beta_best, gamma_best,
                         meta_best, rot_best), overflow


def scene_intersect(scene: SceneData, o: V3, d: V3, time, tmin,
                    tmax) -> Hit:
    """Closest hit for a wavefront. o, d: V3 of [N]; time: [N] or scalar
    (read only when the scene moves); tmin: scalar; tmax: [N] or
    scalar."""
    n, dev = o.x.shape[0], o.x.device
    tmax = _lanes(tmax, n, dev)
    time = _lane_time(scene, time, n, dev)
    with tracing.device_span("analytic_folds", dev):
        best = analytic_fold(scene, o, d, time, tmin, tmax)
    overflow = 0
    if scene.n_meshes:
        with tracing.device_span("mesh", dev):
            # cap the mesh query at the analytic winner: it prunes clusters
            tmax_mesh = torch.minimum(tmax, best[0])
            cand, overflow = _mesh_candidate(scene, o, d, time, tmin,
                                             tmax_mesh)
        best = _fold_best(best, cand)

    t, shape_id, mat, normal, color_mod = best
    valid = torch.isfinite(t) & (t < tmax)
    return Hit(
        t=t,
        valid=valid,
        shape_id=torch.where(valid, shape_id, -1),
        mat=torch.where(valid, mat, -1),
        normal=normal,
        color_mod=torch.where(valid, color_mod, 1.0),
        overflow=overflow,
    )


def _analytic_occluded(scene: SceneData, o: V3, d: V3, time, tmin, tmax):
    """Any-hit against the analytic shapes (planes, spheres, rects), each
    in its local space. With tracing on it adds what the kernel counts:
    ``analytic_fold.lanes.any`` (the query's lanes) and
    ``analytic_fold.tests.<kind>`` (each lane's row tests of the kind, in
    the row order up to its first hit)."""
    n, dev = o.x.shape[0], o.x.device
    counting = tracing.enabled()
    occluded = torch.zeros((n,), dtype=torch.bool, device=dev)
    kinds = (
        (scene.pln_xf_host, lambda r0, r1, o_l, d_l: _plane_rows(
            scene, r0, r1, o_l, d_l, tmin, tmax)),
        (scene.sph_xf_host, lambda r0, r1, o_l, d_l: _sphere_rows(
            scene, r0, r1, o_l, d_l, tmin, tmax)),
        (scene.rect_xf_host, lambda r0, r1, o_l, d_l: _rect_rows(
            scene, r0, r1, o_l, d_l, tmin, tmax)[0]))
    if counting:
        tracing.count("analytic_fold.lanes.any", n, where=o.x)
    for kind, (xf_host, rows_t) in zip(AF_KINDS, kinds):
        tests = (torch.zeros((n,), dtype=torch.int64, device=dev)
                 if counting else None)
        if xf_host:
            occluded, tests = _rows_occluded(scene, xf_host, o, d, time,
                                             rows_t, occluded, tests)
        if counting:
            tracing.count(f"analytic_fold.tests.{kind}", tests.sum())
    return occluded


def _fold_best(best, cand):
    """A candidate (t, shape id, material, normal, color_mod) replaces the
    best where it is strictly nearer: ties keep the earlier kind."""
    t_b, id_b, mat_b, n_b, cm_b = best
    t_c, id_c, mat_c, n_c, cm_c = cand
    closer = t_c < t_b
    return (
        torch.where(closer, t_c, t_b),
        torch.where(closer, id_c.to(torch.int32), id_b),
        torch.where(closer, mat_c.to(torch.int32), mat_b),
        vwhere(closer, n_c, n_b),
        torch.where(closer, cm_c, cm_b),
    )


def analytic_fold_plain(scene: SceneData, o: V3, d: V3, time, tmin, tmax,
                        any_hit: bool = False):
    """The analytic shapes of one query, kind by kind: planes, spheres,
    rects. o, d: V3 of [N]; time: [N] where the scene moves, else None;
    tmax: [N]. Closest hit: (t [N] f32, shape id [N] i32, material [N]
    i32, world normal V3, color_mod [N] f32) of the nearest hit, ties to
    the earlier kind and the lower row, the fold's start where nothing
    hits. Any hit: occluded [N] bool.

    With tracing on it adds what the kernel counts, keyed by the query's
    kind: ``analytic_fold.lanes.closest`` or ``.any`` (the query's lanes)
    and ``analytic_fold.tests.plane``, ``.sphere`` and ``.rect`` (every row
    of the kind a lane on a closest-hit query; see
    :func:`_analytic_occluded` for an any-hit one)."""
    if any_hit:
        return _analytic_occluded(scene, o, d, time, tmin, tmax)
    n, dev = o.x.shape[0], o.x.device
    if tracing.enabled():
        tracing.count("analytic_fold.lanes.closest", n, where=o.x)
        for kind, rows in zip(AF_KINDS, (scene.n_planes, scene.n_spheres,
                                         scene.n_rects)):
            tracing.count(f"analytic_fold.tests.{kind}", n * rows,
                          where=o.x)
    best = (_full(n, INF, torch.float32, dev), _full(n, -1, torch.int32, dev),
            _full(n, -1, torch.int32, dev), _zeros3(n, dev),
            torch.ones((n,), dtype=torch.float32, device=dev))
    if scene.n_planes:
        best = _fold_best(best, _planes_candidate(scene, o, d, time, tmin,
                                                  tmax))
    if scene.n_spheres:
        best = _fold_best(best, _spheres_candidate(scene, o, d, time, tmin,
                                                   tmax))
    if scene.n_rects:
        best = _fold_best(best, _rects_candidate(scene, o, d, time, tmin,
                                                 tmax))
    return best


# the analytic kinds in their fold order (the kernel's test counters)
AF_KINDS = ("plane", "sphere", "rect")
# csrc/analytic_fold.cu's limits per launch: rows, distinct chains and
# chain slots (a query with more launches again, each launch folding into
# the last one's outputs; a chain has at most AF_MAX_SLOTS links)
AF_MAX_ROWS = 128
AF_MAX_CHAINS = 32
AF_MAX_SLOTS = 256


class _AfChain(ctypes.Structure):
    """A keyed slot's transform chain: ``depth`` slots of the spec's
    ``slots`` from ``start``, outermost first."""
    _fields_ = [("start", ctypes.c_int32), ("depth", ctypes.c_int32)]


class _AfSpec(ctypes.Structure):
    """A launch's rows, passed to the kernel by value: the counts of its
    planes, spheres and rects and the first table row of each, each row's
    chain (an index into ``chains``, -1 for the world ray), the chains'
    slots, and the scene's constants."""
    _fields_ = [("count", ctypes.c_int32 * 3), ("first", ctypes.c_int32 * 3),
                ("sphere_id0", ctypes.c_int32), ("rect_id0", ctypes.c_int32),
                ("k", ctypes.c_int32), ("motion", ctypes.c_int32),
                ("n_chain", ctypes.c_int32), ("n_slot", ctypes.c_int32),
                ("chain", ctypes.c_int8 * AF_MAX_ROWS),
                ("chains", _AfChain * AF_MAX_CHAINS),
                ("slots", ctypes.c_int32 * AF_MAX_SLOTS)]


def _af_specs(scene: SceneData) -> list:
    """The analytic rows of a query (every plane, then every sphere, then
    every rect, each kind in ascending row order) cut into launches of at
    most AF_MAX_ROWS rows, AF_MAX_CHAINS distinct chains and AF_MAX_SLOTS
    chain slots. A row with a keyed slot in a moving scene takes its
    slot's chain, outermost first (``xf.chain_slots``); every other row,
    and every row of a static scene, has none and tests the world ray."""
    specs, spec, index = [], None, {}
    kinds = (scene.pln_xf_host, scene.sph_xf_host, scene.rect_xf_host)
    for kind, xf_host in enumerate(kinds):
        for row, slot in enumerate(xf_host):
            chain = xf.chain_slots(scene, slot)
            if len(chain) > AF_MAX_SLOTS:
                raise ValueError(f"analytic_fold: a chain of {len(chain)} "
                                 f"transforms; the kernel takes at most "
                                 f"{AF_MAX_SLOTS}")
            rows = sum(spec.count) if spec is not None else 0
            new = bool(chain) and slot not in index
            if (spec is None or rows == AF_MAX_ROWS
                    or (new and (spec.n_chain == AF_MAX_CHAINS or spec.n_slot
                                 + len(chain) > AF_MAX_SLOTS))):
                spec = _AfSpec(sphere_id0=scene.sphere_id0,
                               rect_id0=scene.rect_id0,
                               k=int(scene.xf_times.shape[1]),
                               motion=int(scene.has_motion))
                specs.append(spec)
                rows, index = 0, {}
            if not spec.count[kind]:
                spec.first[kind] = row
            if chain and slot not in index:
                index[slot] = spec.n_chain
                spec.chains[spec.n_chain] = _AfChain(spec.n_slot, len(chain))
                for j, s in enumerate(chain):
                    spec.slots[spec.n_slot + j] = s
                spec.n_chain += 1
                spec.n_slot += len(chain)
            spec.chain[rows] = index[slot] if chain else -1
            spec.count[kind] += 1
    return specs


# pointer slots of a launch, in csrc/analytic_fold.cu's order: the scene's
# tables, the lanes, the state a chained launch folds into (s_*) and the
# outputs (o_*)
_AF_TABLES = ("pln_pos", "pln_normal", "pln_mat", "pln_bullseye",
              "sph_center", "sph_radius", "sph_mat", "rect_corner",
              "rect_side1", "rect_side2", "rect_mat", "xf_times",
              "xf_translate", "xf_scale", "xf_rotate", "xf_nkeys")
_AF_LANES = ("ox", "oy", "oz", "dx", "dy", "dz", "tmax", "time")
_AF_STATE = ("t", "id", "mat", "n", "cmod", "occ")
_AF_PTRS = (_AF_TABLES + _AF_LANES + tuple("s_" + k for k in _AF_STATE)
            + tuple("o_" + k for k in _AF_STATE))


@functools.lru_cache(maxsize=None)
def _check_af_layout() -> None:
    """The spec's ctypes layout and the pointer count are the kernel's
    (once per process)."""
    lib = cuda_lib.library()
    if lib.rt_analytic_fold_spec_bytes() != ctypes.sizeof(_AfSpec):
        raise RuntimeError("analytic_fold: AfSpec differs between "
                           "analytic_fold.cu and render/trace.py")
    if lib.rt_analytic_fold_ptrs() != len(_AF_PTRS):
        raise RuntimeError("analytic_fold: the pointer slots differ between "
                           "analytic_fold.cu and render/trace.py")


@cuda_lib.counted
def analytic_fold(scene: SceneData, o: V3, d: V3, time, tmin, tmax,
                  any_hit: bool = False):
    """Kernel wrapper of :func:`analytic_fold_plain` (same contract): the
    analytic shapes of one query in one launch (``csrc/analytic_fold.cu``;
    more past its limits, each folding into the last one's outputs), each
    lane's transform chains evaluated inside it. A scene without analytic
    shapes launches nothing. With tracing on the kernel adds the twin's
    counters on the device."""
    name = "analytic_fold"
    n = o.x.shape[0]
    motion = scene.has_motion
    if (time is None) == motion:
        raise ValueError(f"{name}: a time per lane where, and only where, "
                         "the scene moves")
    lanes = (o.x, o.y, o.z, d.x, d.y, d.z, tmax) + ((time,) if motion else ())
    if any(t.shape != (n,) for t in lanes):
        raise ValueError(f"{name}: rays, tmax and time must be [N]")
    if any(t.dtype != torch.float32 for t in lanes):
        raise ValueError(f"{name}: f32 rays, tmax and time expected")
    tables = tuple(getattr(scene, k) for k in _AF_TABLES)
    if cuda_lib.on_cpu(name, *lanes, *tables):
        return analytic_fold_plain(scene, o, d, time, tmin, tmax, any_hit)
    if not isinstance(tmin, (int, float)):
        raise ValueError(f"{name}: tmin must be a Python number")
    specs = _af_specs(scene)
    if not specs:  # nothing to fold: the fold's start
        return analytic_fold_plain(scene, o, d, time, tmin, tmax, any_hit)
    _check_af_layout()
    lanes = tuple(t.contiguous() for t in lanes)
    lib, stream = cuda_lib.launch_args(name, *lanes, *tables)
    dev = o.x.device
    ptrs = dict(zip(_AF_TABLES, tables))
    ptrs.update(zip(_AF_LANES, lanes))
    tests = tuple(tracing.counter_ptr(f"analytic_fold.tests.{k}", dev)
                  for k in AF_KINDS)
    lanes_ctr = tracing.counter_ptr(
        "analytic_fold.lanes." + ("any" if any_hit else "closest"), dev)
    for spec in specs:
        if any_hit:
            outs = {"occ": torch.empty((n,), dtype=torch.bool, device=dev)}
        else:
            f32, i32 = (dict(dtype=dt, device=dev)
                        for dt in (torch.float32, torch.int32))
            outs = {"t": torch.empty((n,), **f32),
                    "id": torch.empty((n,), **i32),
                    "mat": torch.empty((n,), **i32),
                    "n": torch.empty((3, n), **f32),
                    "cmod": torch.empty((n,), **f32)}
        ptrs.update(("o_" + k, v) for k, v in outs.items())
        arr = (ctypes.c_void_p * len(_AF_PTRS))(
            *(None if ptrs.get(k) is None else ptrs[k].data_ptr()
              for k in _AF_PTRS))
        if n:
            cuda_lib.check(lib.rt_analytic_fold(
                ctypes.byref(spec), arr, float(tmin), int(any_hit), *tests,
                lanes_ctr, n, stream), name)
            cuda_lib.count_launch(analytic_fold, dev)
        lanes_ctr = None  # the query's lanes, added by its first launch
        ptrs.update(("s_" + k, v) for k, v in outs.items())
    if any_hit:
        return outs["occ"]
    nrm = outs["n"]
    return (outs["t"], outs["id"], outs["mat"], V3(nrm[0], nrm[1], nrm[2]),
            outs["cmod"])


def _occl_tmax_down(occluded, tmax):
    """Shadow-launch tmax: zero already-occluded lanes and round the rest
    DOWN one full 128-ulp key bucket, so every hit the kernel reports
    satisfies t < tmax exactly (the packed key would otherwise accept hits
    up to 127 ulps beyond tmax). Local t is world t, so the world value
    serves every domain."""
    tq = torch.where(occluded, 0.0, tmax)
    bits = tq.view(torch.int32)
    bits_dn = torch.clamp_min((bits & ~(KTRI - 1)) - KTRI, 0)
    return bits_dn.view(torch.float32)


def scene_occluded(scene: SceneData, o: V3, d: V3, time, tmin, tmax):
    """Any-hit shadow query. Returns (occluded bool [N], overflow: see
    ``Hit.overflow``)."""
    n, dev = o.x.shape[0], o.x.device
    tmax = _lanes(tmax, n, dev)
    time = _lane_time(scene, time, n, dev)
    with tracing.device_span("analytic_folds", dev):
        occluded = analytic_fold(scene, o, d, time, tmin, tmax, any_hit=True)
    if not scene.n_meshes:
        return occluded, 0
    with tracing.device_span("mesh", dev):
        return _mesh_occluded(scene, o, d, time, tmin, tmax, occluded)


def _mesh_occluded(scene: SceneData, o: V3, d: V3, time, tmin, tmax,
                   occluded):
    """The mesh part of scene_occluded: lanes already ``occluded`` query
    with tmax 0. Each domain runs inside a ``domain`` device span, its
    re-test and the or into ``occluded`` inside a ``domain_merge`` one.
    Returns (occluded, overflow)."""
    xla = scene.traversal == "xla"
    if not xla:
        tq_dn = _occl_tmax_down(occluded, tmax)
        mt = _mt_for(scene, occlusion=True)
    for di in range(0 if xla else len(scene.ktab_xf)):
        with tracing.device_span("domain", o.x):
            p_d, o_l, d_l, _ = _launch(
                scene, di, o, d, time, torch.where(occluded, 0.0, tq_dn),
                tmin, mt, sort_rays=scene.sort_occl, any_hit=mt == "vpu",
                want_ray=mt != "vpu")
            with tracing.device_span("domain_merge", o.x):
                if mt != "vpu":
                    # approximate-t (BW) winners are re-tested exactly
                    occluded = occluded | _winner_retest(
                        scene, di, o_l, d_l, p_d, tmin,
                        torch.where(occluded, 0.0, tmax),
                    )[1]
                else:
                    occluded = occluded | (p_d >= 0)
    # mesh by mesh, tmax as it is (no launch key to round for); lanes
    # already occluded query with tmax 0
    overflow = 0
    if not xla and scene.ktab_small:
        with tracing.device_span("tiny_mesh_fold", o.x):
            occluded = fold_small(scene, o, d, time, tmin, tmax,
                                  occluded=occluded)
    for mi in range(scene.n_meshes) if xla else ():
        o_l, d_l, _ = xf.local_ray(scene, scene.mesh_xf_host[mi], o, d,
                                       time)
        _, prim_m, _, _, ovf = mesh_intersect_clusters(
            scene, mi, o_l, d_l, tmin, torch.where(occluded, 0.0, tmax),
            any_hit=True)
        overflow = overflow + ovf
        occluded = occluded | (prim_m >= 0)
    return occluded, overflow


def scene_occluded_pair(scene: SceneData, o: V3, d1: V3, tmax1, d2: V3,
                        tmax2, time, tmin, live):
    """The light- and BRDF-sampled NEE shadow queries of one bounce, as two
    independent scene_occluded calls (the reference's default branch; its
    shared-sort and fused-pair options are TPU schedules, not ported).
    ``live`` is accepted for the reference's signature. Returns (occ1,
    occ2, overflow summed over both)."""
    del live
    occ1, ovf1 = scene_occluded(scene, o, d1, time, tmin, tmax1)
    occ2, ovf2 = scene_occluded(scene, o, d2, time, tmin, tmax2)
    return occ1, occ2, ovf1 + ovf2


def material_row(scene: SceneData, mat_ids):
    """Per-lane material lookup: (kind [N] i32, color V3, param [N])."""
    ids = torch.clamp_min(mat_ids, 0).long()
    return (
        scene.mat_kind[ids],
        V3(scene.mat_color[ids, 0], scene.mat_color[ids, 1],
           scene.mat_color[ids, 2]),
        scene.mat_param[ids],
    )


def material_emittance(scene: SceneData, mat_ids):
    """color * power for emitters, black otherwise (mat_ids may be -1)."""
    kind, color, power = material_row(scene, mat_ids)
    is_emit = (kind == KIND_EMITTER) & (mat_ids >= 0)
    return color * torch.where(is_emit, power, 0.0)
