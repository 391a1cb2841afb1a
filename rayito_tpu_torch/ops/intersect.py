"""Batched primitive intersectors over V3 wavefronts (counterpart of
``rayito_tpu/ops/intersect.py``).

All use a (tmin, tcur) validity window where ``tcur`` is the current
closest t; misses are t = +inf and callers min-reduce.
"""

from __future__ import annotations

import torch

from .vec3 import V3, cross, dot, normalize, sqrt_ieee

INF = float("inf")


def plane_intersect(o: V3, d: V3, tmin, tcur, pos: V3, normal: V3):
    """One-sided infinite plane (faces rays with n.d < 0). Returns (t, hit)."""
    n_dot_d = dot(normal, d)
    t = (dot(pos, normal) - dot(o, normal)) / torch.where(
        n_dot_d == 0.0, 1.0, n_dot_d
    )
    hit = (n_dot_d < 0.0) & (t < tcur) & (t >= tmin)
    return torch.where(hit, t, INF), hit


def sphere_intersect(o: V3, d: V3, tmin, tcur, center: V3, radius):
    """Stable-quadratic sphere test; nearest valid root. Returns (t, hit)."""
    oc = o - center
    a = dot(d, d)
    b = 2.0 * dot(d, oc)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    has_root = disc >= 0.0
    sq = sqrt_ieee(torch.clamp_min(disc, 0.0))
    q = torch.where(b < 0.0, -0.5 * (b - sq), -0.5 * (b + sq))
    t0 = q / a
    t1 = torch.where(q != 0.0, c / torch.where(q == 0.0, 1.0, q), tcur)
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    valid_window = (lo < tcur) & (hi >= tmin)
    use_lo = lo >= tmin
    use_hi = (~use_lo) & (hi < tcur)
    t = torch.where(use_lo, lo, hi)
    hit = has_root & valid_window & (use_lo | use_hi)
    return torch.where(hit, t, INF), hit


def rect_intersect(o: V3, d: V3, tmin, tcur, corner: V3, side1: V3,
                   side2: V3):
    """Double-sided parallelogram. Returns (t, hit, normal V3) with the
    normal flipped toward the viewer."""
    normal = normalize(cross(side1, side2))
    n_dot_d = dot(normal, d)
    nonparallel = n_dot_d != 0.0
    t = (dot(corner, normal) - dot(o, normal)) / torch.where(
        nonparallel, n_dot_d, 1.0
    )
    in_range = (t < tcur) & (t >= tmin)
    s1_len = sqrt_ieee(dot(side1, side1))
    s2_len = sqrt_ieee(dot(side2, side2))
    s1n = side1 / torch.clamp_min(s1_len, 1e-37)
    s2n = side2 / torch.clamp_min(s2_len, 1e-37)
    rel = o + d * t - corner
    lx = dot(rel, s1n)
    ly = dot(rel, s2n)
    inside = (lx >= 0.0) & (lx <= s1_len) & (ly >= 0.0) & (ly <= s2_len)
    hit = nonparallel & in_range & inside
    back = n_dot_d > 0.0
    flipped = V3(
        torch.where(back, -normal.x, normal.x),
        torch.where(back, -normal.y, normal.y),
        torch.where(back, -normal.z, normal.z),
    )
    return torch.where(hit, t, INF), hit, flipped


def triangle_intersect(o: V3, d: V3, tmin, tcur, v0: V3, v1: V3, v2: V3):
    """Exact Möller-Trumbore in the reference's formulation: det =
    -dot(d, gnormal), barycentrics from scalar triple products.

    Returns (t, hit, beta, gamma, gnormal V3); gnormal is unnormalized and
    alpha = 1 - beta - gamma."""
    e1 = v1 - v0
    e2 = v2 - v0
    gnormal = cross(e1, e2)
    det = -dot(d, gnormal)
    nonzero = det != 0.0
    inv_det = 1.0 / torch.where(nonzero, det, 1.0)
    to_v0 = v0 - o
    ray_vert_cross = cross(d, to_v0)
    gamma = -dot(v1 - o, ray_vert_cross) * inv_det
    beta = dot(v2 - o, ray_vert_cross) * inv_det
    t = -dot(to_v0, gnormal) * inv_det
    hit = (
        nonzero
        & (gamma >= 0.0)
        & (gamma <= 1.0)
        & (beta >= 0.0)
        & (beta + gamma <= 1.0)
        & (t >= tmin)
        & (t < tcur)
    )
    return torch.where(hit, t, INF), hit, beta, gamma, gnormal


def aabb_intersect(o: V3, inv_d: V3, t0, t1, bmin: V3, bmax: V3):
    """Slab test clipping (t0, t1) to the box (NaN from 0 * inf fails the
    test). Returns (hit, new_t0, new_t1)."""
    tx0 = (bmin.x - o.x) * inv_d.x
    tx1 = (bmax.x - o.x) * inv_d.x
    ty0 = (bmin.y - o.y) * inv_d.y
    ty1 = (bmax.y - o.y) * inv_d.y
    tz0 = (bmin.z - o.z) * inv_d.z
    tz1 = (bmax.z - o.z) * inv_d.z
    near = torch.maximum(
        torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
        torch.minimum(tz0, tz1))
    far = torch.minimum(
        torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
        torch.maximum(tz0, tz1))
    lanes = lambda v: v if torch.is_tensor(v) else torch.full_like(near, v)
    nt0 = torch.maximum(lanes(t0), near)
    nt1 = torch.minimum(lanes(t1), far)
    return nt0 <= nt1, nt0, nt1


def bullseye_ring(hit_pos: V3, plane_pos: V3):
    """The bullseye texture's dark rings: fmod(dist * 0.25, 1) > 0.5 of the
    distance from the plane's position."""
    rel = hit_pos - plane_pos
    return torch.remainder(sqrt_ieee(dot(rel, rel)) * 0.25, 1.0) > 0.5
