"""Area-light sampling with pdfs for NEE/MIS (counterpart of
``rayito_tpu/render/lights.py``): the rectangle light, the sphere
ShapeLight and the mesh ShapeLight (triangle by area through the mesh's
CDF, then a uniform barycentric point).

The per-light functions take a host-static light index. The path tracer
uses the ``*_rolled`` functions, which evaluate each lane's chosen light
only, from per-lane gathers of its table row: one evaluation per kind
whatever the light count. (The reference evaluates every light and selects,
and above ``ROLL_LIGHTS`` = 8 all-analytic lights rolls a loop over the
light table to keep its compile time flat; what a light costs here is host
launches.)

Each light's keyed transform is evaluated per lane at the ray's time
(motion-blurred lights); lights of a static scene, and lights with the
identity slot, skip it.
"""

from __future__ import annotations

import torch

from ..accel.clusters import TRI_PER_CLUSTER
from ..models.scene import LIGHT_MESH, LIGHT_RECT, LIGHT_SPHERE, SceneData
from ..ops import transform as xfm
from ..ops.intersect import rect_intersect, sphere_intersect
from ..ops.vec3 import (
    PI,
    V3,
    cross,
    dot,
    from_local_frame,
    make_coordinate_space,
    normalize,
    sqrt_ieee,
    where as vwhere,
)
from ..ops.warps import (
    uniform_cone_pdf,
    uniform_to_barycentric_triangle,
    uniform_to_cone,
    uniform_to_sphere,
)

PDF_CLAMP = 1.0e10  # "really big PDFs blow up power-heuristic MIS"


def _row3(table, idx) -> V3:
    """Row ``idx`` of a [K, 3] table: a host int (0-dim components) or a
    long [N] of per-lane rows."""
    return V3(table[idx, 0], table[idx, 1], table[idx, 2])


def _xf_host(scene: SceneData, kind: int):
    return {LIGHT_RECT: scene.rect_xf_host, LIGHT_SPHERE: scene.sph_xf_host,
            LIGHT_MESH: scene.mesh_xf_host}[kind]


def _kind_index_links(scene: SceneData, li: int, time):
    """(kind, index within the kind, transform links) of light ``li``."""
    kind, idx = scene.light_kinds_host[li], scene.light_indices_host[li]
    if kind not in (LIGHT_RECT, LIGHT_SPHERE, LIGHT_MESH):
        raise NotImplementedError(f"unknown light kind {kind}")
    return kind, idx, xfm.lane_links(scene, _xf_host(scene, kind)[idx], time)


def _chain(fn, links, x: V3) -> V3:
    """``fn(links, x)``, or ``x`` where the light does not move."""
    return x if links is None else fn(links, x)


def _sample_rect(scene: SceneData, idx, links, ref_pos: V3, u1, u2):
    """``idx``: a host int, or per-lane rows (long [N])."""
    corner = _row3(scene.rect_corner, idx)
    s1 = _row3(scene.rect_side1, idx)
    s2 = _row3(scene.rect_side2, idx)
    pos = _chain(xfm.from_local_point_chain, links, corner + s1 * u1 + s2 * u2)
    outgoing = ref_pos - pos
    dist = sqrt_ieee(torch.clamp_min(dot(outgoing, outgoing), 1e-37))
    outgoing = outgoing / dist
    # out as a vector, so its length stays the (scaled) area
    nrm = _chain(xfm.from_local_vector_chain, links,
                 cross(s1, s2).broadcast_to(pos.shape))
    area = sqrt_ieee(torch.clamp_min(dot(nrm, nrm), 1e-37))
    nrm = nrm / area
    flip = dot(nrm, outgoing) < 0.0
    nrm = vwhere(flip, -nrm, nrm)
    pdf = dist * dist / torch.clamp_min(area * torch.abs(dot(nrm, outgoing)),
                                        1e-37)
    return pos, nrm, torch.where(pdf > PDF_CLAMP, 0.0, pdf)


def _sample_sphere(scene: SceneData, idx, links, ref_pos: V3, u1, u2,
                   tmin: float):
    center = _row3(scene.sph_center, idx)
    radius = scene.sph_radius[idx]
    local_ref = _chain(xfm.to_local_point_chain, links, ref_pos)
    to_center = center - local_ref
    dist2 = dot(to_center, to_center)
    inside = dist2 < radius * radius * 1.00001

    # inside: uniform over the sphere (with the reference's factor-3 pdf)
    n_in = uniform_to_sphere(u1, u2)
    n_in_w = _chain(xfm.from_local_normal_chain, links, n_in)
    pos_in = _chain(xfm.from_local_point_chain, links, n_in * radius + center)
    to_surf = ref_pos - pos_in
    sapdf = 3.0 / (4.0 * PI * radius * radius)
    pdf_in = dot(to_surf, to_surf) * sapdf / torch.clamp_min(
        torch.abs(dot(normalize(to_surf), n_in_w)), 1e-37
    )

    # outside: cone sampling plus the verification ray, in local space
    sin2 = radius * radius / torch.clamp_min(dist2, 1e-37)
    cos_theta_max = sqrt_ieee(torch.clamp_min(1.0 - sin2, 0.0))
    x, y, z = make_coordinate_space(to_center)
    cone = normalize(
        from_local_frame(uniform_to_cone(u1, u2, cos_theta_max), x, y, z)
    )
    t_hit, did_hit = sphere_intersect(
        local_ref, cone, tmin, torch.full_like(u1, 1.0e30),
        center.broadcast_to(u1.shape), radius,
    )
    t = torch.where(did_hit, t_hit, dot(to_center, cone))
    pos_out_local = local_ref + cone * t
    n_out = _chain(xfm.from_local_normal_chain, links,
                   normalize(pos_out_local - center))
    pos_out = _chain(xfm.from_local_point_chain, links, pos_out_local)
    pdf_out = uniform_cone_pdf(cos_theta_max)

    pos = vwhere(inside, pos_in, pos_out)
    nrm = vwhere(inside, n_in_w, n_out)
    pdf = torch.where(inside, pdf_in, pdf_out)
    # ShapeLight: discard samples whose normal faces away
    facing = dot(nrm, ref_pos - pos) >= 0.0
    return pos, nrm, torch.where(facing, pdf, 0.0)


def _sample_mesh_light(scene: SceneData, mi: int, links, ref_pos: V3, u1, u2,
                       u3):
    """Mesh ShapeLight sampling: triangle by area through the mesh's CDF
    (the first cumulative area above u3 * total), a uniform barycentric
    point, pdf = dist^2 / (total area * |cos|) with the LOCAL-space area (a
    scaled light keeps it: a quirk of the reference renderer). Samples
    that face away from the reference point are rejected.

    The search runs over the mesh's own 48-padded run of the CDF, which is
    sorted. The reference slices ``n_padded`` entries, its cluster count
    padded to a multiple of 16 times 48: that runs into the next mesh's
    CDF unless the light is the scene's last mesh, and a binary search of
    the unsorted slice is undefined. Wherever the reference's pick is
    defined this one equals it: u3 * total below the total picks a triangle
    of the mesh; a product that rounds up to the total passes the whole run
    and, as the reference's clamp to ``n_padded - 1`` does, lands on the
    run's last triangle when the run fills the padded count, else on an
    all-zero pad triangle (position at the local origin, zero normal)."""
    tri0, count = scene.mesh_tri_ranges[mi]
    n_padded = scene.mesh_cl_ranges[mi][1] * TRI_PER_CLUSTER
    own = max(1, -(-count // TRI_PER_CLUSTER)) * TRI_PER_CLUSTER
    total = scene.mesh_total_area[mi]
    tri_rel = torch.clamp_max(
        torch.searchsorted(scene.tri_area_cdf[tri0:tri0 + own], u3 * total,
                           right=True), n_padded - 1)
    if n_padded > own:
        in_run = tri_rel < own
        rows = scene.tri_vert_rows[tri0 + torch.where(in_run, tri_rel, 0)]
        rows = torch.where(in_run[:, None], rows, 0.0)
    else:
        rows = scene.tri_vert_rows[tri0 + tri_rel]
    # columns 0-8 of a vertex row are v0 v1 v2: the floats of the
    # reference's 48-wide cluster rows
    p0, p1, p2 = (V3(rows[:, k], rows[:, k + 1], rows[:, k + 2])
                  for k in (0, 3, 6))
    alpha, beta = uniform_to_barycentric_triangle(u1, u2)
    gamma = 1.0 - alpha - beta
    pos = _chain(xfm.from_local_point_chain, links,
                 p0 * alpha + p1 * beta + p2 * gamma)
    nrm = normalize(_chain(xfm.from_local_normal_chain, links,
                           cross(p1 - p0, p2 - p0)))
    to_surf = ref_pos - pos
    pdf = (dot(to_surf, to_surf) * (1.0 / torch.clamp_min(total, 1e-37))
           / torch.clamp_min(torch.abs(dot(normalize(to_surf), nrm)), 1e-37))
    return pos, nrm, torch.where(dot(nrm, to_surf) >= 0.0, pdf, 0.0)


def _sample_kind(scene: SceneData, kind, idx, links, ref_pos: V3, u1, u2, u3,
                 tmin: float):
    if kind == LIGHT_RECT:
        return _sample_rect(scene, idx, links, ref_pos, u1, u2)
    if kind == LIGHT_SPHERE:
        return _sample_sphere(scene, idx, links, ref_pos, u1, u2, tmin)
    return _sample_mesh_light(scene, idx, links, ref_pos, u1, u2, u3)


def sample_light(scene: SceneData, li: int, ref_pos: V3, ref_normal: V3,
                 time, u1, u2, u3, tmin: float):
    """sampleSurface for light ``li``. Returns (position V3, normal V3,
    pdf [N]); pdf == 0 marks a rejected sample."""
    kind, idx, links = _kind_index_links(scene, li, time)
    return _sample_kind(scene, kind, idx, links, ref_pos, u1, u2, u3, tmin)


def _rect_intersect_pdf(scene: SceneData, idx, links, ray_d: V3, t,
                        hit_normal: V3):
    s1, s2 = _row3(scene.rect_side1, idx), _row3(scene.rect_side2, idx)
    if links is not None:
        s1 = xfm.from_local_vector_chain(links, s1.broadcast_to(t.shape))
        s2 = xfm.from_local_vector_chain(links, s2.broadcast_to(t.shape))
    c = cross(s1, s2)
    area = sqrt_ieee(torch.clamp_min(dot(c, c), 1e-37))
    pdf = t * t / torch.clamp_min(
        torch.abs(dot(hit_normal, -ray_d)) * area, 1e-37
    )
    return torch.where(pdf > PDF_CLAMP, 0.0, pdf)


def _sphere_intersect_pdf(scene: SceneData, idx, links, ray_o: V3, ray_d: V3,
                          t, hit_normal: V3):
    center = _row3(scene.sph_center, idx)
    radius = scene.sph_radius[idx]
    to_center = center - _chain(xfm.to_local_point_chain, links, ray_o)
    dist2 = dot(to_center, to_center)
    inside = dist2 < radius * radius * 1.00001
    to_surf = ray_o - (ray_o + ray_d * t)
    sapdf = 3.0 / (4.0 * PI * radius * radius)
    pdf_in = dot(to_surf, to_surf) * sapdf / torch.clamp_min(
        torch.abs(dot(normalize(to_surf), hit_normal)), 1e-37
    )
    sin2 = radius * radius / torch.clamp_min(dist2, 1e-37)
    cos_theta_max = sqrt_ieee(torch.clamp_min(1.0 - sin2, 0.0))
    return torch.where(inside, pdf_in, uniform_cone_pdf(cos_theta_max))


def _mesh_intersect_pdf(scene: SceneData, idx, ray_o: V3, ray_d: V3, t,
                        hit_normal: V3):
    """dist^2 / (total local-space area * |cos|)."""
    to_surf = ray_o - (ray_o + ray_d * t)
    total = scene.mesh_total_area[idx]
    return (dot(to_surf, to_surf) / torch.clamp_min(total, 1e-37)
            / torch.clamp_min(torch.abs(dot(normalize(to_surf), hit_normal)),
                              1e-37))


def _intersect_pdf_kind(scene: SceneData, kind, idx, links, ray_o: V3,
                        ray_d: V3, t, hit_normal: V3):
    if kind == LIGHT_RECT:
        return _rect_intersect_pdf(scene, idx, links, ray_d, t, hit_normal)
    if kind == LIGHT_SPHERE:
        return _sphere_intersect_pdf(scene, idx, links, ray_o, ray_d, t,
                                     hit_normal)
    return _mesh_intersect_pdf(scene, idx, ray_o, ray_d, t, hit_normal)


def light_intersect_pdf(scene: SceneData, li: int, ray_o: V3, ray_d: V3, t,
                        hit_normal: V3, time):
    """MIS pdf of reaching light ``li`` by BRDF sampling (the caller has
    verified the hit is this light)."""
    kind, idx, links = _kind_index_links(scene, li, time)
    return _intersect_pdf_kind(scene, kind, idx, links, ray_o, ray_d, t,
                               hit_normal)


def light_emitted(scene: SceneData, li: int) -> V3:
    """emitted() = color * power (0-dim components)."""
    c = scene.light_color[li]
    p = scene.light_power[li]
    return V3(c[0] * p, c[1] * p, c[2] * p)


def _hit_analytic_kind(scene: SceneData, kind, idx, links, o: V3, d: V3,
                       tmin: float):
    n = o.x.shape[0]
    tmax = torch.full((n,), 1.0e30, dtype=torch.float32, device=o.x.device)
    o_l = _chain(xfm.to_local_point_chain, links, o)
    d_l = _chain(xfm.to_local_vector_chain, links, d)
    if kind == LIGHT_RECT:
        t, hit, nrm = rect_intersect(
            o_l, d_l, tmin, tmax,
            _row3(scene.rect_corner, idx).broadcast_to((n,)),
            _row3(scene.rect_side1, idx).broadcast_to((n,)),
            _row3(scene.rect_side2, idx).broadcast_to((n,)),
        )
    else:
        center = _row3(scene.sph_center, idx).broadcast_to((n,))
        t, hit = sphere_intersect(o_l, d_l, tmin, tmax, center,
                                  scene.sph_radius[idx])
        nrm = normalize(o_l + d_l * torch.where(hit, t, 0.0) - center)
    return t, _chain(xfm.from_local_normal_chain, links, nrm), hit


def light_hit_analytic(scene: SceneData, li: int, o: V3, d: V3, time,
                       tmin: float):
    """Direct ray-vs-light intersection in the light's local space at the
    lane's time. Returns (t [N], world normal V3, hit [N]), or None for a
    mesh light (the caller falls back to the full scene intersection)."""
    kind, idx, links = _kind_index_links(scene, li, time)
    if kind == LIGHT_MESH:
        return None
    return _hit_analytic_kind(scene, kind, idx, links, o, d, tmin)


# ---------------------------------------------------------------------------
# Each lane's chosen light
# ---------------------------------------------------------------------------


def _keep(mask, a, b):
    """Per-lane choice between two result tuples of tensors and V3s."""
    return tuple(vwhere(mask, x, y) if isinstance(x, V3)
                 else torch.where(mask, x, y) for x, y in zip(a, b))


def _for_chosen_light(scene: SceneData, light_idx, time, fn):
    """``fn(kind, idx, links)`` (a tuple of [N] results) for each lane's
    chosen light. The rect lights that do not move share one evaluation,
    ``idx`` being each lane's row of the rect table (lanes of another kind
    read row 0 and are discarded), and so do the sphere lights: an absent
    kind's table may be empty and is never touched. Evaluated alone, with a
    host index, and kept by the lanes that chose it: a mesh light (it
    slices its own CDF), a light with a keyed transform (evaluated at the
    lane's time), and the only light of its kind (a host index costs no
    gather)."""
    lidx = light_idx.long()
    lights = list(zip(scene.light_kinds_host, scene.light_indices_host))
    shared = {}
    for li, (kind, idx) in enumerate(lights):
        if kind != LIGHT_MESH and not (scene.has_motion
                                       and _xf_host(scene, kind)[idx]):
            shared.setdefault(kind, []).append(li)
    shared = {kind: lis for kind, lis in shared.items() if len(lis) > 1}
    out = None
    if shared:
        kind_l = scene.light_kind[lidx]
        idx_l = scene.light_index[lidx].long()
    for kind in sorted(shared):
        of_kind = kind_l == kind
        res = fn(kind, torch.where(of_kind, idx_l, 0), None)
        out = res if out is None else _keep(of_kind, res, out)
    for li, (kind, idx) in enumerate(lights):
        if li in shared.get(kind, ()):
            continue
        links = xfm.lane_links(scene, _xf_host(scene, kind)[idx], time)
        res = fn(kind, idx, links)
        out = res if out is None else _keep(lidx == li, res, out)
    return out


def sample_chosen_light_rolled(scene: SceneData, light_idx, ref_pos: V3,
                               time, u1, u2, u3, tmin: float):
    """sample_light of each lane's chosen light ``light_idx`` [N]."""
    return _for_chosen_light(
        scene, light_idx, time,
        lambda kind, idx, links: _sample_kind(scene, kind, idx, links,
                                              ref_pos, u1, u2, u3, tmin))


def light_hit_analytic_rolled(scene: SceneData, light_idx, o: V3, d: V3,
                              time, tmin: float):
    """light_hit_analytic of each lane's chosen light (rects and spheres
    only)."""
    if LIGHT_MESH in scene.light_kinds_host:
        raise ValueError("a mesh light has no analytic hit: the caller "
                         "intersects the whole scene")
    return _for_chosen_light(
        scene, light_idx, time,
        lambda kind, idx, links: _hit_analytic_kind(scene, kind, idx, links,
                                                    o, d, tmin))


def light_intersect_pdf_rolled(scene: SceneData, light_idx, ray_o: V3,
                               ray_d: V3, t, hit_normal: V3, time):
    """light_intersect_pdf of each lane's chosen light."""
    return _for_chosen_light(
        scene, light_idx, time,
        lambda kind, idx, links: (_intersect_pdf_kind(
            scene, kind, idx, links, ray_o, ray_d, t, hit_normal),))[0]


def light_emitted_rolled(scene: SceneData, light_idx) -> V3:
    """emitted() of each lane's chosen light, gathered from the light
    table."""
    lidx = light_idx.long()
    pw = scene.light_power[lidx]
    return V3(scene.light_color[lidx, 0] * pw, scene.light_color[lidx, 1] * pw,
              scene.light_color[lidx, 2] * pw)
