"""Wavefront scene intersection (counterpart of
``rayito_tpu/render/trace.py``).

The few analytic shapes (planes, spheres, rects) fold shape by shape over
the whole wavefront; triangle meshes go through the kernel traversal
(``render/traverse.py``), whose winner is re-tested exactly and shaded from
one gathered, transposed 32-column row (``gather_rows_t``).

Static scenes with at most ``ROLL_SHAPES`` spheres and rects each; the
rolled folds, transformed meshes and tiny-mesh folds come with later
slices.
"""

from __future__ import annotations

import dataclasses

import torch

from ..accel.kernel_tables import KTRI
from ..models.scene import SceneData
from ..ops.brdf import KIND_EMITTER
from ..ops.intersect import (
    INF,
    plane_intersect,
    rect_intersect,
    sphere_intersect,
    triangle_intersect,
)
from ..ops.vec3 import V3, from_aos, normalize, where as vwhere
from .traverse import gather_rows_t, traverse

# above this many shapes of one kind the reference rolls its fold into a
# loop over packed rows (not ported yet)
ROLL_SHAPES = 24


@dataclasses.dataclass(frozen=True)
class Hit:
    """SoA intersection record."""

    t: torch.Tensor  # [N] f32, inf where no hit
    valid: torch.Tensor  # [N] bool
    shape_id: torch.Tensor  # [N] i32 global shape id; -1 = miss
    mat: torch.Tensor  # [N] i32 material id; -1 = miss
    normal: V3
    color_mod: torch.Tensor  # [N] scalar modifier (bullseye texture)


def _check_unrolled(scene: SceneData):
    if scene.n_spheres > ROLL_SHAPES or scene.n_rects > ROLL_SHAPES:
        raise NotImplementedError(
            f"more than {ROLL_SHAPES} spheres or rects (the rolled folds) "
            "are not ported yet"
        )


def _full(n, value, dtype, device):
    return torch.full((n,), value, dtype=dtype, device=device)


def _planes_candidate(scene: SceneData, o: V3, d: V3, tmin, tmax):
    pos, nrm = from_aos(scene.pln_pos), from_aos(scene.pln_normal)
    n, dev = o.x.shape[0], o.x.device
    t = _full(n, INF, torch.float32, dev)
    idx = _full(n, 0, torch.int32, dev)
    mat = _full(n, 0, torch.int32, dev)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    pos_b, nrm_b = V3(zero, zero, zero), V3(zero, zero, zero)
    bulls = torch.zeros((n,), dtype=torch.bool, device=dev)
    for i in range(scene.n_planes):
        t_i, _ = plane_intersect(o, d, tmin, torch.minimum(t, tmax), pos[i],
                                 nrm[i])
        closer = t_i < t
        t = torch.where(closer, t_i, t)
        idx = torch.where(closer, i, idx)
        mat = torch.where(closer, scene.pln_mat[i], mat)
        pos_b = vwhere(closer, pos[i].broadcast_to((n,)), pos_b)
        nrm_b = vwhere(closer, nrm[i].broadcast_to((n,)), nrm_b)
        bulls = torch.where(closer, scene.pln_bullseye[i], bulls)
    valid = torch.isfinite(t)
    rel = o + d * torch.where(valid, t, 0.0) - pos_b
    dist = torch.sqrt(rel.x * rel.x + rel.y * rel.y + rel.z * rel.z)
    ring = torch.remainder(dist * 0.25, 1.0) > 0.5
    color_mod = torch.where(bulls & ring & valid, 0.2, 1.0).to(torch.float32)
    return t, idx, mat, nrm_b, color_mod


def _spheres_candidate(scene: SceneData, o: V3, d: V3, tmin, tmax):
    center = from_aos(scene.sph_center)
    n, dev = o.x.shape[0], o.x.device
    t = _full(n, INF, torch.float32, dev)
    idx = _full(n, 0, torch.int32, dev)
    mat = _full(n, 0, torch.int32, dev)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    c_b = V3(zero, zero, zero)
    for i in range(scene.n_spheres):
        t_i, _ = sphere_intersect(o, d, tmin, torch.minimum(t, tmax),
                                  center[i], scene.sph_radius[i])
        closer = t_i < t
        t = torch.where(closer, t_i, t)
        idx = torch.where(closer, i, idx)
        mat = torch.where(closer, scene.sph_mat[i], mat)
        c_b = vwhere(closer, center[i].broadcast_to((n,)), c_b)
    t_safe = torch.where(torch.isfinite(t), t, 0.0)
    normal = normalize(o + d * t_safe - c_b)
    return t, scene.sphere_id0 + idx, mat, normal, torch.ones_like(t)


def _rects_candidate(scene: SceneData, o: V3, d: V3, tmin, tmax):
    corner = from_aos(scene.rect_corner)
    s1, s2 = from_aos(scene.rect_side1), from_aos(scene.rect_side2)
    n, dev = o.x.shape[0], o.x.device
    t = _full(n, INF, torch.float32, dev)
    idx = _full(n, 0, torch.int32, dev)
    mat = _full(n, 0, torch.int32, dev)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    nrm_b = V3(zero, zero, zero)
    for i in range(scene.n_rects):
        t_i, _, nrm_i = rect_intersect(o, d, tmin, torch.minimum(t, tmax),
                                       corner[i], s1[i], s2[i])
        closer = t_i < t
        t = torch.where(closer, t_i, t)
        idx = torch.where(closer, i, idx)
        mat = torch.where(closer, scene.rect_mat[i], mat)
        nrm_b = vwhere(closer, nrm_i, nrm_b)
    return t, scene.rect_id0 + idx, mat, nrm_b, torch.ones_like(t)


def _mt_for(scene: SceneData, occlusion: bool) -> str:
    """Per-query triangle test: 'bw_closest' is Baldwin-Weber on closest
    hit (winners are re-tested exactly) and exact MT on occlusion."""
    m = scene.traverse_mt
    if m == "bw_closest":
        return "vpu" if occlusion else "bw"
    return m


def _domain_tri(scene: SceneData, di: int, mt: str):
    return scene.ktab_tri[di] if mt == "vpu" else scene.ktab_mxu[di]


def _launch(scene: SceneData, di: int, o: V3, d: V3, tmax, tmin, mt: str,
            sort_rays: bool, any_hit: bool):
    return traverse(
        o, d, tmax, scene.ktab_box[di], _domain_tri(scene, di, mt), tmin,
        sort_rays=sort_rays, want_t=False, mt_mode=mt, any_hit=any_hit,
        b=scene.traverse_b, sb=scene.traverse_sb,
        live_prefix=scene.live_prefix,
    )[1]


def _winner_retest(scene: SceneData, di: int, o: V3, d: V3, p_d, tmin, tmax,
                   want_meta: bool = False):
    """Exact Möller-Trumbore re-test of the kernel's winner from one
    gathered, transposed row. Returns (t, ok, beta, gamma, g_d[, meta])."""
    found = p_d >= 0
    p_safe = torch.clamp_min(p_d, 0)
    cl = p_safe // KTRI
    g_d = scene.ktab_base[di][cl.long()] + (p_safe - cl * KTRI)
    idx = torch.where(found, g_d, 0).to(torch.int32)
    if want_meta:
        row_t = gather_rows_t(scene.tri_vm_rows, idx)  # [32, N]
        vrow, meta = row_t[:16], row_t[16:]
    else:
        vrow, meta = gather_rows_t(scene.tri_vert_rows, idx), None
    n = p_d.shape[0]
    t_fin, h_fin, beta, gamma, _ = triangle_intersect(
        o, d, tmin, torch.as_tensor(tmax, device=o.x.device).expand(n),
        V3(vrow[0], vrow[1], vrow[2]),
        V3(vrow[3], vrow[4], vrow[5]),
        V3(vrow[6], vrow[7], vrow[8]),
    )
    if want_meta:
        return t_fin, found & h_fin, beta, gamma, g_d, meta
    return t_fin, found & h_fin, beta, gamma, g_d


def _mesh_shading(scene: SceneData, t_best, prim_best, beta, gamma, meta):
    """Winner shading from its transposed [16, N] meta rows: interpolated
    vertex normals when present, else the unit geometric normal."""
    valid = prim_best >= 0
    alpha = 1.0 - beta - gamma
    n0 = V3(meta[0], meta[1], meta[2])
    n1 = V3(meta[3], meta[4], meta[5])
    n2 = V3(meta[6], meta[7], meta[8])
    has_n = meta[9] > 0.5
    mesh_idx = meta[11].to(torch.int32)
    gnormal = V3(meta[12], meta[13], meta[14])
    n_interp = n0 * alpha + n1 * beta + n2 * gamma
    normal = vwhere(has_n, normalize(n_interp), gnormal)
    mesh_mat = scene.mesh_mat[mesh_idx.long()]
    return (
        torch.where(valid, t_best, INF),
        torch.where(valid, scene.mesh_id0 + mesh_idx, -1),
        torch.where(valid, mesh_mat, -1),
        normal,
        torch.ones_like(t_best),
    )


def _mesh_candidate_pallas(scene: SceneData, o: V3, d: V3, tmin, tmax):
    """Mesh intersection through the kernels: one launch per traversal
    domain, then the exact winner re-test and shading."""
    n, dev = o.x.shape[0], o.x.device
    t_best = _full(n, INF, torch.float32, dev)
    prim_best = _full(n, -1, torch.int32, dev)
    beta_best = torch.zeros((n,), dtype=torch.float32, device=dev)
    gamma_best = torch.zeros_like(beta_best)
    meta_best = None
    mt = _mt_for(scene, occlusion=False)
    for di in range(len(scene.ktab_xf)):
        p_d = _launch(scene, di, o, d, torch.minimum(t_best, tmax), tmin, mt,
                      sort_rays=True, any_hit=False)
        t_fin, ok_fin, beta, gamma, g_d, meta = _winner_retest(
            scene, di, o, d, p_d, tmin, INF, want_meta=True
        )
        closer = ok_fin & (t_fin < torch.minimum(t_best, tmax))
        t_best = torch.where(closer, t_fin, t_best)
        prim_best = torch.where(closer, g_d, prim_best)
        beta_best = torch.where(closer, beta, beta_best)
        gamma_best = torch.where(closer, gamma, gamma_best)
        meta_best = (meta if meta_best is None
                     else torch.where(closer[None, :], meta, meta_best))
    return _mesh_shading(scene, t_best, prim_best, beta_best, gamma_best,
                         meta_best)


def scene_intersect(scene: SceneData, o: V3, d: V3, time, tmin,
                    tmax) -> Hit:
    """Closest hit for a wavefront. o, d: V3 of [N]; tmin: scalar; tmax:
    [N] or scalar. ``time`` only matters for motion (not ported yet)."""
    _check_unrolled(scene)
    n, dev = o.x.shape[0], o.x.device
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(n)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    best = (
        _full(n, INF, torch.float32, dev),
        _full(n, -1, torch.int32, dev),
        _full(n, -1, torch.int32, dev),
        V3(zero, zero, zero),
        torch.ones((n,), dtype=torch.float32, device=dev),
    )

    def fold(best, cand):
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

    if scene.n_planes:
        best = fold(best, _planes_candidate(scene, o, d, tmin, tmax))
    if scene.n_spheres:
        best = fold(best, _spheres_candidate(scene, o, d, tmin, tmax))
    if scene.n_rects:
        best = fold(best, _rects_candidate(scene, o, d, tmin, tmax))
    if scene.n_meshes:
        # cap the mesh query at the analytic winner: it prunes clusters
        tmax_mesh = torch.minimum(tmax, best[0])
        best = fold(best,
                    _mesh_candidate_pallas(scene, o, d, tmin, tmax_mesh))

    t, shape_id, mat, normal, color_mod = best
    valid = torch.isfinite(t) & (t < tmax)
    return Hit(
        t=t,
        valid=valid,
        shape_id=torch.where(valid, shape_id, -1),
        mat=torch.where(valid, mat, -1),
        normal=normal,
        color_mod=torch.where(valid, color_mod, 1.0),
    )


def _analytic_occluded(scene: SceneData, o: V3, d: V3, tmin, tmax):
    """Any-hit against the analytic shapes (planes, spheres, rects)."""
    occluded = torch.zeros((o.x.shape[0],), dtype=torch.bool,
                           device=o.x.device)
    pos, nrm = from_aos(scene.pln_pos), from_aos(scene.pln_normal)
    for i in range(scene.n_planes):
        occluded |= plane_intersect(o, d, tmin, tmax, pos[i], nrm[i])[1]
    center = from_aos(scene.sph_center)
    for i in range(scene.n_spheres):
        occluded |= sphere_intersect(o, d, tmin, tmax, center[i],
                                     scene.sph_radius[i])[1]
    corner = from_aos(scene.rect_corner)
    s1, s2 = from_aos(scene.rect_side1), from_aos(scene.rect_side2)
    for i in range(scene.n_rects):
        occluded |= rect_intersect(o, d, tmin, tmax, corner[i], s1[i],
                                   s2[i])[1]
    return occluded


def _occl_tmax_down(occluded, tmax):
    """Shadow-launch tmax: zero already-occluded lanes and round the rest
    DOWN one full 128-ulp key bucket, so every hit the kernel reports
    satisfies t < tmax exactly (the packed key would otherwise accept hits
    up to 127 ulps beyond tmax)."""
    tq = torch.where(occluded, 0.0, tmax)
    bits = tq.view(torch.int32)
    bits_dn = torch.clamp_min((bits & ~(KTRI - 1)) - KTRI, 0)
    return bits_dn.view(torch.float32)


def scene_occluded(scene: SceneData, o: V3, d: V3, time, tmin, tmax):
    """Any-hit shadow query. Returns (occluded bool [N], overflow 0 — the
    kernel traversal never truncates)."""
    _check_unrolled(scene)
    n, dev = o.x.shape[0], o.x.device
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(n)
    occluded = _analytic_occluded(scene, o, d, tmin, tmax)
    if scene.n_meshes:
        tq_dn = _occl_tmax_down(occluded, tmax)
        mt = _mt_for(scene, occlusion=True)
        for di in range(len(scene.ktab_xf)):
            p_d = _launch(scene, di, o, d, torch.where(occluded, 0.0, tq_dn),
                          tmin, mt, sort_rays=scene.sort_occl,
                          any_hit=mt == "vpu")
            if mt != "vpu":
                # approximate-t (BW) winners are re-tested exactly
                occluded = occluded | _winner_retest(
                    scene, di, o, d, p_d, tmin,
                    torch.where(occluded, 0.0, tmax),
                )[1]
            else:
                occluded = occluded | (p_d >= 0)
    return occluded, 0


def scene_occluded_pair(scene: SceneData, o: V3, d1: V3, tmax1, d2: V3,
                        tmax2, time, tmin, live):
    """The light- and BRDF-sampled NEE shadow queries of one bounce, as two
    independent scene_occluded calls (the reference's default branch; its
    shared-sort and fused-pair options are TPU schedules, not ported).
    ``live`` is accepted for the reference's signature. Returns (occ1,
    occ2, overflow)."""
    del live
    occ1, _ = scene_occluded(scene, o, d1, time, tmin, tmax1)
    occ2, _ = scene_occluded(scene, o, d2, time, tmin, tmax2)
    return occ1, occ2, 0


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
