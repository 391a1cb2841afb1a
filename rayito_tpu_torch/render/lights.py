"""Area-light sampling with pdfs for NEE/MIS (counterpart of
``rayito_tpu/render/lights.py``) for the rectangle light and the sphere
ShapeLight. Light indices are host-static; per-lane light choice is made
by the caller.

Each light's keyed transform is evaluated per lane at the ray's time
(motion-blurred lights); lights of a static scene, and lights with the
identity slot, skip it. Mesh-light sampling raises NotImplementedError.
"""

from __future__ import annotations

import torch

from ..models.scene import LIGHT_RECT, LIGHT_SPHERE, SceneData
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
    where as vwhere,
)
from ..ops.warps import uniform_cone_pdf, uniform_to_cone, uniform_to_sphere
from .trace import lane_links

PDF_CLAMP = 1.0e10  # "really big PDFs blow up power-heuristic MIS"


def _row3(table, idx) -> V3:
    return V3(table[idx, 0], table[idx, 1], table[idx, 2])


def _kind_index(scene: SceneData, li: int):
    kind = scene.light_kinds_host[li]
    if kind not in (LIGHT_RECT, LIGHT_SPHERE):
        raise NotImplementedError("mesh lights are not ported yet")
    return kind, scene.light_indices_host[li]


def _chain(fn, links, x: V3) -> V3:
    """``fn(links, x)``, or ``x`` where the light does not move."""
    return x if links is None else fn(links, x)


def _sample_rect(scene: SceneData, idx, ref_pos: V3, time, u1, u2):
    links = lane_links(scene, scene.rect_xf_host[idx], time)
    corner = _row3(scene.rect_corner, idx)
    s1 = _row3(scene.rect_side1, idx)
    s2 = _row3(scene.rect_side2, idx)
    pos = _chain(xfm.from_local_point_chain, links, corner + s1 * u1 + s2 * u2)
    outgoing = ref_pos - pos
    dist = torch.sqrt(torch.clamp_min(dot(outgoing, outgoing), 1e-37))
    outgoing = outgoing / dist
    # out as a vector, so its length stays the (scaled) area
    nrm = _chain(xfm.from_local_vector_chain, links,
                 cross(s1, s2).broadcast_to(pos.shape))
    area = torch.sqrt(torch.clamp_min(dot(nrm, nrm), 1e-37))
    nrm = nrm / area
    flip = dot(nrm, outgoing) < 0.0
    nrm = vwhere(flip, -nrm, nrm)
    pdf = dist * dist / torch.clamp_min(area * torch.abs(dot(nrm, outgoing)),
                                        1e-37)
    return pos, nrm, torch.where(pdf > PDF_CLAMP, 0.0, pdf)


def _sample_sphere(scene: SceneData, idx, ref_pos: V3, time, u1, u2,
                   tmin: float):
    links = lane_links(scene, scene.sph_xf_host[idx], time)
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
    cos_theta_max = torch.sqrt(torch.clamp_min(1.0 - sin2, 0.0))
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


def sample_light(scene: SceneData, li: int, ref_pos: V3, ref_normal: V3,
                 time, u1, u2, u3, tmin: float):
    """sampleSurface for light ``li``. Returns (position V3, normal V3,
    pdf [N]); pdf == 0 marks a rejected sample."""
    kind, idx = _kind_index(scene, li)
    if kind == LIGHT_RECT:
        return _sample_rect(scene, idx, ref_pos, time, u1, u2)
    return _sample_sphere(scene, idx, ref_pos, time, u1, u2, tmin)


def light_intersect_pdf(scene: SceneData, li: int, ray_o: V3, ray_d: V3, t,
                        hit_normal: V3, time):
    """MIS pdf of reaching light ``li`` by BRDF sampling (the caller has
    verified the hit is this light)."""
    kind, idx = _kind_index(scene, li)
    if kind == LIGHT_RECT:
        links = lane_links(scene, scene.rect_xf_host[idx], time)
        s1, s2 = _row3(scene.rect_side1, idx), _row3(scene.rect_side2, idx)
        if links is not None:
            s1 = xfm.from_local_vector_chain(links, s1.broadcast_to(t.shape))
            s2 = xfm.from_local_vector_chain(links, s2.broadcast_to(t.shape))
        c = cross(s1, s2)
        area = torch.sqrt(torch.clamp_min(dot(c, c), 1e-37))
        pdf = t * t / torch.clamp_min(
            torch.abs(dot(hit_normal, -ray_d)) * area, 1e-37
        )
        return torch.where(pdf > PDF_CLAMP, 0.0, pdf)
    links = lane_links(scene, scene.sph_xf_host[idx], time)
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
    cos_theta_max = torch.sqrt(torch.clamp_min(1.0 - sin2, 0.0))
    return torch.where(inside, pdf_in, uniform_cone_pdf(cos_theta_max))


def light_emitted(scene: SceneData, li: int) -> V3:
    """emitted() = color * power (0-dim components)."""
    c = scene.light_color[li]
    p = scene.light_power[li]
    return V3(c[0] * p, c[1] * p, c[2] * p)


def light_hit_analytic(scene: SceneData, li: int, o: V3, d: V3, time,
                       tmin: float):
    """Direct ray-vs-light intersection in the light's local space at the
    lane's time. Returns (t [N], world normal V3, hit [N])."""
    kind, idx = _kind_index(scene, li)
    n = o.x.shape[0]
    tmax = torch.full((n,), 1.0e30, dtype=torch.float32, device=o.x.device)
    xf_ids = scene.rect_xf_host if kind == LIGHT_RECT else scene.sph_xf_host
    links = lane_links(scene, xf_ids[idx], time)
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
