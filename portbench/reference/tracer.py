"""The plain reference path tracer: the Rayito stage-6/7 integrator for a
chosen set of pixels, in plain PyTorch on any device and in one float
type throughout (float32 as the configurations state; bfloat16 for the
control of ``portbench/compare.py``).

What it computes, for each pixel and each of its ``pixel_samples**2``
samples: a camera ray through a jittered point of the pixel at a shutter
time, then ``max_depth`` bounces of next-event estimation with one light
chosen uniformly per light sample, a light-sampled and a BRDF-sampled
shadow ray weighted by the power heuristic, emission seen directly or
through mirrors only, and a BRDF-sampled continuation (Lambert, the
isotropic Ashikhmin-Shirley glossy lobe, the perfect mirror). Shapes move
by their keyed transforms at the ray's time. Every random number comes
from ``cmj.py``. The pixel's value is the mean of its samples.

Intersection is brute force: every ray against every triangle of a mesh
(after one bounding-box test per mesh), nearest hit wins, ties to the
first triangle in file order. No acceleration structure, no kernel, no
code of the renderer under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cmj
from .scene import LIGHT_RECT, FlatScene

PI = 3.14159265358979
TMAX = 1.0e30
INF = float("inf")
LAMBERT, GLOSSY, MIRROR, EMITTER, PHONG = 0, 1, 2, 3, 4
FLT_MIN = 1.1754943508222875e-38
PDF_CLAMP = 1.0e10


class V:
    """Three tensors of one shape: a vector per lane."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x, y, z):
        self.x, self.y, self.z = x, y, z

    def _op(self, o, f):
        if isinstance(o, V):
            return V(f(self.x, o.x), f(self.y, o.y), f(self.z, o.z))
        return V(f(self.x, o), f(self.y, o), f(self.z, o))

    def __add__(self, o):
        return self._op(o, lambda a, b: a + b)

    def __sub__(self, o):
        return self._op(o, lambda a, b: a - b)

    def __mul__(self, o):
        return self._op(o, lambda a, b: a * b)

    def __truediv__(self, o):
        return self._op(o, lambda a, b: a / b)

    def __neg__(self):
        return V(-self.x, -self.y, -self.z)

    def sel(self, idx):
        return V(self.x[idx], self.y[idx], self.z[idx])


def sqrt(x):
    """The correctly rounded root: the CPU's float32 root is not, so there
    float32 goes through float64."""
    if x.is_cuda or x.dtype != torch.float32:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def div(x, s: float):
    """x / s rounded once (a Python divisor becomes a reciprocal multiply
    on the card)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def dot(a, b):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a, b):
    return V(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
             a.x * b.y - a.y * b.x)


def vwhere(m, a, b):
    return V(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y),
             torch.where(m, a.z, b.z))


def normalize(v):
    len2 = dot(v, v)
    inv = torch.where(len2 > 0.0, 1.0 / sqrt(torch.clamp_min(
        len2, 1e-37)), 1.0)
    return v * inv


def frame(n):
    """Orthonormal frame (x, y, z) with z the unit ``n``; the up vector is
    +Y unless ``n`` lies on the Y axis, then +X."""
    z = normalize(n)
    not_y = (z.x != 0.0) | (z.z != 0.0)
    zero = torch.zeros_like(z.x)
    up = V(torch.where(not_y, 0.0, 1.0).to(z.x.dtype),
           torch.where(not_y, 1.0, 0.0).to(z.x.dtype), zero)
    x = normalize(cross(up, z))
    return x, cross(z, x), z


def from_frame(v, x, y, z):
    return x * v.x + y * v.y + z * v.z


class Ctx:
    """Device, float type and the scene's tables as tensors."""

    def __init__(self, scene: FlatScene, device, dtype):
        self.s, self.dev, self.dt = scene, device, dtype

    def c(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.dev
                               ).to(self.dt)

    def cv(self, a):
        t = self.c(a)
        return V(t[..., 0], t[..., 1], t[..., 2])

    def full(self, n, v):
        return torch.full((n,), v, dtype=self.dt, device=self.dev)


# --------------------------------------------------------------------------
# keyed transforms
# --------------------------------------------------------------------------


class Q:
    __slots__ = ("w", "v")

    def __init__(self, w, v):
        self.w, self.v = w, v


def qmul_vec(q, v):
    """q v q*: t = 2 (q.v x v); v + w t + q.v x t."""
    t = cross(q.v, v) * 2.0
    return v + t * q.w + cross(q.v, t)


def qconj(q):
    return Q(q.w, -q.v)


class Xf:
    """A shape's transform evaluated at each lane's time: translation,
    scale, rotation (nlerp between the lane's two keys)."""

    def __init__(self, ctx: Ctx, keys, time):
        k = keys.times.shape[0]
        times = ctx.c(keys.times)
        before = (times[None, :] <= time[:, None]).sum(dim=1)
        i0 = torch.clamp(before - 1, 0, k - 1)
        i1 = torch.clamp_max(i0 + 1, k - 1)
        t0, t1 = times[i0], times[i1]
        den = t1 - t0
        frac = torch.where(den > 0.0, (time - t0) / torch.where(
            den == 0.0, 1.0, den), 0.0)
        frac = torch.clamp(frac, 0.0, 1.0)
        tr, sc, ro = ctx.c(keys.translate), ctx.c(keys.scale), ctx.c(
            keys.rotate)

        def lerp(tab):
            a = V(tab[i0, 0], tab[i0, 1], tab[i0, 2])
            b = V(tab[i1, 0], tab[i1, 1], tab[i1, 2])
            return a + (b - a) * frac

        self.t, self.s = lerp(tr), lerp(sc)
        w = ro[i0, 0] * (1.0 - frac) + ro[i1, 0] * frac
        qv = (V(ro[i0, 1], ro[i0, 2], ro[i0, 3]) * (1.0 - frac)
              + V(ro[i1, 1], ro[i1, 2], ro[i1, 3]) * frac)
        inv = 1.0 / sqrt(torch.clamp_min(w * w + dot(qv, qv), 1e-37))
        self.r = Q(w * inv, qv * inv)

    def sel(self, idx):
        out = Xf.__new__(Xf)
        out.t, out.s = self.t.sel(idx), self.s.sel(idx)
        out.r = Q(self.r.w[idx], self.r.v.sel(idx))
        return out

    def to_point(self, p):
        return qmul_vec(qconj(self.r), p - self.t) / self.s

    def to_vector(self, v):
        return qmul_vec(qconj(self.r), v) / self.s

    def from_point(self, p):
        return qmul_vec(self.r, p * self.s) + self.t

    def from_vector(self, v):
        return qmul_vec(self.r, v * self.s)

    def from_normal(self, n):
        return qmul_vec(self.r, n)


def _xf(ctx, keys, time):
    return None if keys is None else Xf(ctx, keys, time)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------


def plane_t(o, d, tmin, tcur, pos, nrm):
    ndd = dot(nrm, d)
    t = (dot(pos, nrm) - dot(o, nrm)) / torch.where(ndd == 0.0, 1.0, ndd)
    hit = (ndd < 0.0) & (t < tcur) & (t >= tmin)
    return torch.where(hit, t, INF), hit


def sphere_t(o, d, tmin, tcur, center, radius):
    oc = o - center
    a = dot(d, d)
    b = 2.0 * dot(d, oc)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    has_root = disc >= 0.0
    sq = sqrt(torch.clamp_min(disc, 0.0))
    q = torch.where(b < 0.0, -0.5 * (b - sq), -0.5 * (b + sq))
    t0 = q / a
    t1 = torch.where(q != 0.0, c / torch.where(q == 0.0, 1.0, q), tcur)
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    window = (lo < tcur) & (hi >= tmin)
    use_lo = lo >= tmin
    use_hi = (~use_lo) & (hi < tcur)
    t = torch.where(use_lo, lo, hi)
    hit = has_root & window & (use_lo | use_hi)
    return torch.where(hit, t, INF), hit


def rect_t(o, d, tmin, tcur, corner, s1, s2):
    nrm = normalize(cross(s1, s2))
    ndd = dot(nrm, d)
    ok = ndd != 0.0
    t = (dot(corner, nrm) - dot(o, nrm)) / torch.where(ok, ndd, 1.0)
    in_range = (t < tcur) & (t >= tmin)
    l1, l2 = sqrt(dot(s1, s1)), sqrt(dot(s2, s2))
    u1 = s1 / torch.clamp_min(l1, 1e-37)
    u2 = s2 / torch.clamp_min(l2, 1e-37)
    rel = o + d * t - corner
    lx, ly = dot(rel, u1), dot(rel, u2)
    inside = (lx >= 0.0) & (lx <= l1) & (ly >= 0.0) & (ly <= l2)
    hit = ok & in_range & inside
    back = ndd > 0.0
    return torch.where(hit, t, INF), hit, vwhere(back, -nrm, nrm)


class MeshT:
    """A mesh's triangles on the device, and its bounding box widened by a
    little more than rounding can move a hit."""

    def __init__(self, ctx: Ctx, m):
        self.m = m
        self.v0, self.v1, self.v2 = (ctx.cv(a) for a in (m.v0, m.v1, m.v2))
        self.e1 = self.v1 - self.v0
        self.e2 = self.v2 - self.v0
        self.gn = cross(self.e1, self.e2)
        pts = np.concatenate([m.v0, m.v1, m.v2], 0).astype(np.float64)
        lo, hi = pts.min(0), pts.max(0)
        pad = 1e-3 * (1.0 + np.abs(pts).max())
        self.lo, self.hi = (ctx.cv(lo - pad)), ctx.cv(hi + pad)
        self.t = m.v0.shape[0]

    def candidates(self, o, d, tmin, tmax):
        """Lanes whose ray can meet the box within [tmin, tmax)."""
        def slab(lo, hi, oc, dc):
            dc = torch.where(dc == 0.0, 1e-30, dc)
            a, b = (lo - oc) / dc, (hi - oc) / dc
            return torch.minimum(a, b), torch.maximum(a, b)
        ax, bx = slab(self.lo.x, self.hi.x, o.x, d.x)
        ay, by = slab(self.lo.y, self.hi.y, o.y, d.y)
        az, bz = slab(self.lo.z, self.hi.z, o.z, d.z)
        near = torch.maximum(torch.maximum(ax, ay), az)
        far = torch.minimum(torch.minimum(bx, by), bz)
        return ((near <= far) & (far >= 0.0) & (near <= tmax)
                & (tmax > 0.0))

    def test(self, o, d, tmin, tcur, rows: int, any_hit: bool):
        """Möller-Trumbore of lanes ``o, d`` [R] (tcur [R]) against every
        triangle, ``rows`` lanes at a time. Returns (t, triangle, beta,
        gamma) of the nearest hit (t inf, triangle -1 where none), or the
        any-hit bits."""
        n = o.x.shape[0]
        out_t, out_i, out_b, out_g, out_any = [], [], [], [], []
        col = lambda v: V(v.x[None, :], v.y[None, :], v.z[None, :])  # noqa
        v0, v1, v2, gn = col(self.v0), col(self.v1), col(self.v2), col(
            self.gn)
        for r0 in range(0, n, rows):
            sl = slice(r0, r0 + rows)
            oo = V(o.x[sl, None], o.y[sl, None], o.z[sl, None])
            dd = V(d.x[sl, None], d.y[sl, None], d.z[sl, None])
            tc = tcur[sl, None]
            det = -dot(dd, gn)
            nz = det != 0.0
            inv = 1.0 / torch.where(nz, det, 1.0)
            to_v0 = v0 - oo
            rvc = cross(dd, to_v0)
            gamma = -dot(v1 - oo, rvc) * inv
            beta = dot(v2 - oo, rvc) * inv
            t = -dot(to_v0, gn) * inv
            hit = (nz & (gamma >= 0.0) & (gamma <= 1.0) & (beta >= 0.0)
                   & (beta + gamma <= 1.0) & (t >= tmin) & (t < tc))
            if any_hit:
                out_any.append(hit.any(dim=1))
                continue
            th = torch.where(hit, t, INF)
            j = torch.argmin(th, dim=1, keepdim=True)
            tj = th.gather(1, j)[:, 0]
            found = torch.isfinite(tj)
            out_t.append(tj)
            out_i.append(torch.where(found, j[:, 0], -1))
            out_b.append(beta.gather(1, j)[:, 0])
            out_g.append(gamma.gather(1, j)[:, 0])
        if any_hit:
            return torch.cat(out_any) if out_any else torch.zeros(
                (0,), dtype=torch.bool, device=o.x.device)
        return tuple(torch.cat(x) for x in (out_t, out_i, out_b, out_g))


# --------------------------------------------------------------------------
# the scene
# --------------------------------------------------------------------------


class Hit:
    def __init__(self, t, valid, kind_id, mat, normal, cmod):
        self.t, self.valid, self.id = t, valid, kind_id
        self.mat, self.normal, self.cmod = mat, normal, cmod


class SceneT:
    """The flat scene on the device with its query functions. ``mats``
    lists every shape's material in shape order (planes, spheres, rects,
    meshes); a hit carries the index into it."""

    def __init__(self, ctx: Ctx, rows: int):
        self.ctx, self.rows = ctx, rows
        s = ctx.s
        self.mats = ([p["material"] for p in s.planes]
                     + [p["material"] for p in s.spheres]
                     + [p["material"] for p in s.rects]
                     + [m.material for m in s.meshes])
        self.mat_kind = torch.as_tensor([m.kind for m in self.mats],
                                        dtype=torch.int64, device=ctx.dev)
        self.mat_color = ctx.c(np.stack([m.color for m in self.mats]))
        self.mat_param = ctx.c(np.asarray([m.param for m in self.mats],
                                          np.float32))
        self.meshes = [MeshT(ctx, m) for m in s.meshes]
        self.sph0 = len(s.planes)
        self.rect0 = self.sph0 + len(s.spheres)
        self.mesh0 = self.rect0 + len(s.rects)

    def _local(self, keys, o, d, time, cache):
        if keys is None:
            return o, d, None
        key = id(keys)
        if key not in cache:
            x = Xf(self.ctx, keys, time)
            cache[key] = (x.to_point(o), x.to_vector(d), x)
        return cache[key]

    def intersect(self, o, d, time, tmin, tmax) -> Hit:
        """Closest hit: planes, spheres, rects, then meshes (capped at the
        nearest analytic hit), each kind in its listed order, a later shape
        winning only when strictly nearer."""
        ctx, s = self.ctx, self.ctx.s
        n = o.x.shape[0]
        best_t = ctx.full(n, INF)
        best_id = torch.full((n,), -1, dtype=torch.int64, device=ctx.dev)
        zero = ctx.full(n, 0.0)
        best_n = V(zero, zero, zero)
        best_cm = ctx.full(n, 1.0)
        cache = {}

        def take(t, sid, nrm, cm):
            nonlocal best_t, best_id, best_n, best_cm
            closer = t < best_t
            best_t = torch.where(closer, t, best_t)
            best_id = torch.where(closer, sid, best_id)
            best_n = vwhere(closer, nrm, best_n)
            best_cm = torch.where(closer, cm, best_cm)

        one = ctx.full(n, 1.0)
        for i, p in enumerate(s.planes):
            ol, dl, x = self._local(p["keys"], o, d, time, cache)
            pos, nrm = ctx.cv(p["pos"]), ctx.cv(p["normal"])
            t, hit = plane_t(ol, dl, tmin, tmax, pos, nrm)
            cm = one
            if p["bullseye"]:
                rel = ol + dl * torch.where(hit, t, 0.0) - pos
                ring = torch.remainder(sqrt(dot(rel, rel)) * 0.25,
                                       1.0) > 0.5
                cm = torch.where(ring & hit, 0.2, 1.0).to(ctx.dt)
            wn = nrm if x is None else x.from_normal(
                V(nrm.x.expand(n), nrm.y.expand(n), nrm.z.expand(n)))
            take(t, i, wn, cm)
        for i, p in enumerate(s.spheres):
            ol, dl, x = self._local(p["keys"], o, d, time, cache)
            c = ctx.cv(p["center"])
            r = ctx.c(p["radius"])
            t, hit = sphere_t(ol, dl, tmin, tmax, c, r)
            nrm = normalize(ol + dl * torch.where(hit, t, 0.0) - c)
            take(t, self.sph0 + i, nrm if x is None else x.from_normal(nrm),
                 one)
        for i, p in enumerate(s.rects):
            ol, dl, x = self._local(p["keys"], o, d, time, cache)
            t, hit, nrm = rect_t(ol, dl, tmin, tmax, ctx.cv(p["corner"]),
                                 ctx.cv(p["side1"]), ctx.cv(p["side2"]))
            nrm = V(nrm.x.expand(n), nrm.y.expand(n), nrm.z.expand(n))
            take(t, self.rect0 + i, nrm if x is None else x.from_normal(nrm),
                 one)
        cap = torch.minimum(tmax, best_t)
        for i, mt in enumerate(self.meshes):
            ol, dl, x = self._local(mt.m.keys, o, d, time, cache)
            lanes = torch.nonzero(mt.candidates(ol, dl, tmin, cap))[:, 0]
            if lanes.numel() == 0:
                continue
            t, tri, beta, gamma = mt.test(ol.sel(lanes), dl.sel(lanes), tmin,
                                          cap[lanes], self.rows, False)
            found = tri >= 0
            tri = torch.clamp_min(tri, 0)
            m = mt.m
            n0, n1, n2 = (ctx.cv(a[tri.cpu().numpy()])
                          for a in (m.n0, m.n1, m.n2))
            has_n = torch.as_tensor(m.has_n[tri.cpu().numpy()],
                                    device=ctx.dev)
            gn = ctx.cv(m.gnormal[tri.cpu().numpy()])
            alpha = 1.0 - beta - gamma
            nrm = vwhere(has_n, normalize(n0 * alpha + n1 * beta
                                          + n2 * gamma), gn)
            if x is not None:
                nrm = x.sel(lanes).from_normal(nrm)
            full_t = ctx.full(n, INF)
            full_t[lanes] = torch.where(found, t, INF)
            full_n = V(zero.clone(), zero.clone(), zero.clone())
            full_n.x[lanes], full_n.y[lanes], full_n.z[lanes] = (
                nrm.x, nrm.y, nrm.z)
            take(full_t, self.mesh0 + i, full_n, one)
            cap = torch.minimum(tmax, best_t)
        valid = torch.isfinite(best_t) & (best_t < tmax)
        return Hit(best_t, valid, torch.where(valid, best_id, -1),
                   torch.where(valid, best_id, -1), best_n,
                   torch.where(valid, best_cm, 1.0))

    def occluded(self, o, d, time, tmin, tmax):
        """Any hit in [tmin, tmax)."""
        ctx, s = self.ctx, self.ctx.s
        n = o.x.shape[0]
        occ = torch.zeros((n,), dtype=torch.bool, device=ctx.dev)
        cache = {}
        for p in s.planes:
            ol, dl, _ = self._local(p["keys"], o, d, time, cache)
            occ |= plane_t(ol, dl, tmin, tmax, ctx.cv(p["pos"]),
                           ctx.cv(p["normal"]))[1]
        for p in s.spheres:
            ol, dl, _ = self._local(p["keys"], o, d, time, cache)
            occ |= sphere_t(ol, dl, tmin, tmax, ctx.cv(p["center"]),
                            ctx.c(p["radius"]))[1]
        for p in s.rects:
            ol, dl, _ = self._local(p["keys"], o, d, time, cache)
            occ |= rect_t(ol, dl, tmin, tmax, ctx.cv(p["corner"]),
                          ctx.cv(p["side1"]), ctx.cv(p["side2"]))[1]
        for mt in self.meshes:
            ol, dl, _ = self._local(mt.m.keys, o, d, time, cache)
            live = mt.candidates(ol, dl, tmin, torch.where(occ, 0.0, tmax))
            lanes = torch.nonzero(live)[:, 0]
            if lanes.numel() == 0:
                continue
            occ[lanes] |= mt.test(ol.sel(lanes), dl.sel(lanes), tmin,
                                  tmax[lanes], self.rows, True)
        return occ


# --------------------------------------------------------------------------
# lights
# --------------------------------------------------------------------------


def _cone(u1, u2, cos_max):
    ct = u1 * (cos_max - 1.0) + 1.0
    st = sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    phi = 2.0 * PI * u2
    return V(torch.cos(phi) * st, torch.sin(phi) * st, ct)


def _cone_pdf(cos_max):
    return torch.where(cos_max >= 1.0, 0.0, 1.0 / (
        2.0 * PI * torch.clamp_min(1.0 - cos_max, 1e-37)))


def _sphere_dir(u1, u2):
    z = 1.0 - 2.0 * u1
    r = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u2
    return V(r * torch.cos(phi), r * torch.sin(phi), z)


class Light:
    """One light of the scene, its transform at the lanes' times."""

    def __init__(self, ctx: Ctx, light: dict, time):
        s = ctx.s
        self.ctx, self.kind = ctx, light["kind"]
        self.emit = ctx.cv(light["color"] * light["power"])
        shape = (s.rects if self.kind == LIGHT_RECT else s.spheres)[
            light["index"]]
        self.x = _xf(ctx, shape["keys"], time)
        if self.kind == LIGHT_RECT:
            self.corner = ctx.cv(shape["corner"])
            self.s1, self.s2 = ctx.cv(shape["side1"]), ctx.cv(shape["side2"])
        else:
            self.center = ctx.cv(shape["center"])
            self.radius = ctx.c(shape["radius"])

    def _out(self, fn, v):
        return v if self.x is None else getattr(self.x, fn)(v)

    def sample(self, ref, u1, u2, tmin):
        """(position, normal, pdf) of a point on the light seen from
        ``ref``; pdf 0 rejects the sample."""
        n = ref.x.shape[0]
        if self.kind == LIGHT_RECT:
            pos = self._out("from_point",
                            self.corner + self.s1 * u1 + self.s2 * u2)
            out = ref - pos
            dist = sqrt(torch.clamp_min(dot(out, out), 1e-37))
            out = out / dist
            c = cross(self.s1, self.s2)
            nrm = self._out("from_vector", V(c.x.expand(n), c.y.expand(n),
                                             c.z.expand(n)))
            area = sqrt(torch.clamp_min(dot(nrm, nrm), 1e-37))
            nrm = nrm / area
            nrm = vwhere(dot(nrm, out) < 0.0, -nrm, nrm)
            pdf = dist * dist / torch.clamp_min(
                area * torch.abs(dot(nrm, out)), 1e-37)
            return pos, nrm, torch.where(pdf > PDF_CLAMP, 0.0, pdf)
        c, r = self.center, self.radius
        local_ref = self._out("to_point", ref)
        to_c = c - local_ref
        dist2 = dot(to_c, to_c)
        inside = dist2 < r * r * 1.00001
        n_in = _sphere_dir(u1, u2)
        n_in_w = self._out("from_normal", n_in)
        pos_in = self._out("from_point", n_in * r + c)
        ts = ref - pos_in
        sapdf = 3.0 / (4.0 * PI * r * r)
        pdf_in = dot(ts, ts) * sapdf / torch.clamp_min(
            torch.abs(dot(normalize(ts), n_in_w)), 1e-37)
        sin2 = r * r / torch.clamp_min(dist2, 1e-37)
        cos_max = sqrt(torch.clamp_min(1.0 - sin2, 0.0))
        fx, fy, fz = frame(to_c)
        cone = normalize(from_frame(_cone(u1, u2, cos_max), fx, fy, fz))
        t_hit, did = sphere_t(local_ref, cone, tmin,
                              torch.full_like(u1, TMAX), c, r)
        t = torch.where(did, t_hit, dot(to_c, cone))
        pl = local_ref + cone * t
        n_out = self._out("from_normal", normalize(pl - c))
        pos_out = self._out("from_point", pl)
        pos = vwhere(inside, pos_in, pos_out)
        nrm = vwhere(inside, n_in_w, n_out)
        pdf = torch.where(inside, pdf_in, _cone_pdf(cos_max))
        facing = dot(nrm, ref - pos) >= 0.0
        return pos, nrm, torch.where(facing, pdf, 0.0)

    def hit(self, o, d, tmin):
        """(t, world normal, hit) of the ray against this light alone."""
        n = o.x.shape[0]
        tmax = torch.full((n,), TMAX, dtype=o.x.dtype, device=o.x.device)
        ol = self._out("to_point", o)
        dl = self._out("to_vector", d)
        if self.kind == LIGHT_RECT:
            t, hit, nrm = rect_t(ol, dl, tmin, tmax, self.corner, self.s1,
                                 self.s2)
            nrm = V(nrm.x.expand(n), nrm.y.expand(n), nrm.z.expand(n))
        else:
            t, hit = sphere_t(ol, dl, tmin, tmax, self.center, self.radius)
            nrm = normalize(ol + dl * torch.where(hit, t, 0.0) - self.center)
        return t, self._out("from_normal", nrm), hit

    def pdf(self, ray_o, ray_d, t, hit_n):
        """Solid-angle pdf of reaching the light along the ray at t."""
        n = t.shape[0]
        if self.kind == LIGHT_RECT:
            s1, s2 = self.s1, self.s2
            if self.x is not None:
                s1 = self.x.from_vector(V(s1.x.expand(n), s1.y.expand(n),
                                          s1.z.expand(n)))
                s2 = self.x.from_vector(V(s2.x.expand(n), s2.y.expand(n),
                                          s2.z.expand(n)))
            c = cross(s1, s2)
            area = sqrt(torch.clamp_min(dot(c, c), 1e-37))
            pdf = t * t / torch.clamp_min(torch.abs(dot(hit_n, -ray_d))
                                          * area, 1e-37)
            return torch.where(pdf > PDF_CLAMP, 0.0, pdf)
        c, r = self.center, self.radius
        to_c = c - self._out("to_point", ray_o)
        dist2 = dot(to_c, to_c)
        inside = dist2 < r * r * 1.00001
        ts = ray_o - (ray_o + ray_d * t)
        sapdf = 3.0 / (4.0 * PI * r * r)
        pdf_in = dot(ts, ts) * sapdf / torch.clamp_min(
            torch.abs(dot(normalize(ts), hit_n)), 1e-37)
        sin2 = r * r / torch.clamp_min(dist2, 1e-37)
        cos_max = sqrt(torch.clamp_min(1.0 - sin2, 0.0))
        return torch.where(inside, pdf_in, _cone_pdf(cos_max))


def _chosen(lights, idx, fn):
    """``fn(light)`` (a tuple of per-lane results) kept where the lane
    chose that light."""
    out = None
    for li, light in enumerate(lights):
        res = fn(light)
        if out is None:
            out = res
            continue
        m = idx == li
        out = tuple(vwhere(m, a, b) if isinstance(a, V) else
                    torch.where(m, a, b) for a, b in zip(res, out))
    return out


# --------------------------------------------------------------------------
# BRDFs: incoming points toward the surface, outgoing away
# --------------------------------------------------------------------------


def _flush(x):
    return torch.where(torch.abs(x) < FLT_MIN, 0.0, x)


def _opposite_rejected(ni, no):
    return ((ni > 0.0) & (no > 0.0)) | ((ni < 0.0) & (no < 0.0))


def brdf_eval(kind, exponent, wi, wo, n):
    ni, no = dot(wi, n), dot(wo, n)
    rej = _opposite_rejected(ni, no)
    f_l = torch.where(rej, 0.0, 1.0 / PI).to(ni.dtype)
    p_l = torch.where(rej, 0.0, div(torch.abs(ni), PI))
    near = dot(wo, wi) > 0.999
    h = vwhere(near, n, normalize(wo - wi))
    ndh = torch.abs(dot(n, h))
    lobe = _flush(torch.pow(torch.clamp_min(ndh, 0.0), exponent))
    dd = _flush(div((exponent + 1.0) * lobe, 2.0 * PI))
    den = 4.0 * torch.abs(no + (-ni) - no * (-ni))
    f_g = _flush(dd / torch.clamp_min(den, 1e-37))
    p_g = _flush(dd / torch.clamp_min(4.0 * torch.abs(dot(wo, h)), 1e-37))
    f_g, p_g = torch.where(rej, 0.0, f_g), torch.where(rej, 0.0, p_g)
    is_l, is_g = kind == LAMBERT, kind == GLOSSY
    f = torch.where(is_l, f_l, torch.where(is_g, f_g, 0.0))
    pdf = torch.where(is_l, p_l, torch.where(is_g, p_g, 0.0))
    return f, pdf


def _disk(u1, u2):
    sx, sy = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0

    def safe(a, b):
        return a / torch.where(b == 0.0, 1.0, b)

    ca, cb, cc = sx >= -sy, sx > sy, sx <= sy
    th1 = torch.where(sy > 0.0, safe(sy, sx), 8.0 + safe(sy, sx))
    r = torch.where(ca, torch.where(cb, sx, sy), torch.where(cc, -sx, -sy))
    th = torch.where(ca, torch.where(cb, th1, 2.0 - safe(sx, sy)),
                     torch.where(cc, 4.0 - safe(sy, -sx),
                                 6.0 + safe(sx, -sy)))
    th = th * (PI / 4.0)
    dx, dy = r * torch.cos(th), r * torch.sin(th)
    deg = (sx == 0.0) & (sy == 0.0)
    return torch.where(deg, 0.0, dx), torch.where(deg, 0.0, dy)


def brdf_sample(kind, exponent, wo, n, u1, u2):
    """(incoming, f, pdf) sampled by the lane's BRDF."""
    fx, fy, fz = frame(n)
    flip = dot(wo, n) < 0.0
    # Lambert: cosine hemisphere
    dx, dy = _disk(u1, u2)
    z = sqrt(torch.clamp_min(1.0 - dx * dx - dy * dy, 0.0))
    i_l = from_frame(-V(dx, dy, z), fx, fy, fz)
    i_l = vwhere(flip, -i_l, i_l)
    p_l = div(torch.abs(dot(-i_l, n)), PI)
    f_l = torch.full_like(p_l, 1.0 / PI)
    # glossy: the half vector about the normal
    phi = 2.0 * PI * u1
    ct = torch.pow(torch.clamp_min(1.0 - u2, 0.0), 1.0 / (exponent + 1.0))
    st = sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    h = from_frame(V(st * torch.cos(phi), st * torch.sin(phi), ct),
                   fx, fy, fz)
    h = vwhere(flip, -h, h)
    i_g = wo - h * (2.0 * dot(wo, h))
    f_g, p_g = brdf_eval(torch.full_like(kind, GLOSSY), exponent, i_g, wo, n)
    # mirror
    ndo = dot(n, wo)
    sgn = torch.where(ndo < 0.0, 1.0, -1.0).to(ndo.dtype)
    i_r = wo + n * (2.0 * ndo * sgn)
    p_r = torch.abs(dot(-i_r, n))
    is_g, is_r = kind == GLOSSY, kind == MIRROR
    wi = vwhere(is_r, i_r, vwhere(is_g, i_g, i_l))
    f = torch.where(is_r, 1.0, torch.where(is_g, f_g, f_l))
    pdf = torch.where(is_r, p_r, torch.where(is_g, p_g, p_l))
    none = (kind == EMITTER) | (kind == PHONG)
    return wi, torch.where(none, 0.0, f), torch.where(none, 0.0, pdf)


def power_heuristic(p1, p2):
    return (p1 * p1) / torch.clamp_min(p1 * p1 + p2 * p2, 1e-37)


# --------------------------------------------------------------------------
# samples and the camera
# --------------------------------------------------------------------------


def _draws(px, py, si, purpose, extra, seed, nx, ny=0, mul=1, add=0):
    p = cmj.hash_combine(px, py, purpose, *extra, seed)
    if ny:
        return cmj.sample_2d(si, nx, ny, p, mul, add)
    return (cmj.sample_1d(si, nx, p, mul, add),)


def camera_rays(ctx, cam, rc, px, py, si):
    """(origin, direction, time) of lanes (px, py, si)."""
    ps, seed = rc["pixel_samples"], rc["seed"]
    jx, jy = _draws(px, py, si, cmj.SUBPIXEL, (), seed, ps, ps)
    time_u, = _draws(px, py, si, cmj.TIME, (), seed, ps * ps)
    w, h = np.float32(rc["width"]), np.float32(rc["height"])
    xu = (px.astype(np.float32) + jx) / w
    yu = np.float32(1.0) - (py.astype(np.float32) + jy) / h
    aspect = np.float32(w / h)
    xu = (xu - np.float32(0.5)) * aspect + np.float32(0.5)
    xu, yu, time_u = (ctx.c(a) for a in (xu, yu, time_u))
    f = torch.float32
    t = lambda v: torch.tensor(v, dtype=f)  # noqa: E731
    o = V(*(t(c) for c in cam["origin"]))
    target = V(*(t(c) for c in cam["target"]))
    up = V(*(t(c) for c in cam["up"]))
    fwd = normalize(target - o)
    right = cross(fwd, up)
    cup = cross(right, fwd)
    tan_fov = float(t(math.tan(cam["fov_degrees"] * PI / 180.0)))
    cv = lambda v: V(*(float(c) for c in (v.x, v.y, v.z)))  # noqa: E731
    fwd, right, cup = cv(fwd), cv(right), cv(cup)
    sx = (xu - 0.5) * tan_fov
    sy = (yu - 0.5) * tan_fov
    d = normalize(V(fwd.x + right.x * sx + cup.x * sy,
                    fwd.y + right.y * sx + cup.y * sy,
                    fwd.z + right.z * sx + cup.z * sy))
    if cam.get("lens_radius", 0.0) > 0.0:
        raise NotImplementedError("the reference renders pinhole cameras")
    n = xu.shape[0]
    org = V(*(ctx.full(n, float(c)) for c in cam["origin"]))
    s0, s1 = cam.get("shutter", (0.0, 0.0))
    time = float(t(s0)) + (float(t(s1)) - float(t(s0))) * time_u
    return org, d, time


def trace_lanes(sc: SceneT, cam, rc, px, py, si):
    """Radiance [N, 3] of lanes (px, py, si) (numpy int arrays)."""
    ctx, s = sc.ctx, sc.ctx.s
    ps, ls, seed = rc["pixel_samples"], rc["light_samples"], rc["seed"]
    tmin = rc.get("ray_tmin", 1e-4)
    n_lights = len(s.lights)
    nls = ls * ls if n_lights else 0
    o, d, time = camera_rays(ctx, cam, rc, px, py, si)
    n = px.shape[0]
    zero = ctx.full(n, 0.0)
    result = V(zero, zero, zero)
    tp = V(ctx.full(n, 1.0), ctx.full(n, 1.0), ctx.full(n, 1.0))
    alive = torch.ones((n,), dtype=torch.bool, device=ctx.dev)
    n_dirac = torch.zeros((n,), dtype=torch.int64, device=ctx.dev)
    lights = [Light(ctx, li, time) for li in s.lights]
    scale = float(np.float32(n_lights) / np.float32(max(nls, 1)))
    for bounce in range(rc["max_depth"]):
        hit = sc.intersect(o, d, time, tmin,
                           torch.where(alive, ctx.full(n, TMAX), 0.0))
        mid = torch.clamp_min(hit.mat, 0)
        kind = sc.mat_kind[mid]
        mc = sc.mat_color[mid]
        mcol = V(mc[:, 0], mc[:, 1], mc[:, 2])
        param = sc.mat_param[mid]
        exponent = torch.where(kind == GLOSSY, 1.0 / torch.clamp_min(
            param * param, 1e-12), 1.0)
        lane = alive & hit.valid
        gate = lane & ((bounce == 0) | (n_dirac == bounce))
        emit = mcol * torch.where((kind == EMITTER) & (hit.mat >= 0), param,
                                  0.0)
        result = result + vwhere(gate, tp * emit, V(zero, zero, zero))
        lane = lane & (kind != EMITTER)
        is_dirac = (kind == MIRROR) & lane
        n_dirac = n_dirac + is_dirac.to(torch.int64)
        pos = o + d * hit.t
        wo = -d
        nrm = hit.normal
        cmod = mcol * hit.cmod
        nee = lane & ~is_dirac
        key = (bounce,)
        acc = V(zero, zero, zero)
        for lsi in range(nls):
            fs = dict(mul=nls, add=lsi)
            liu, = _draws(px, py, si, cmj.LIGHT_SELECT, key, seed,
                          (ps * ls) ** 2, **fs)
            lsu, lsv = _draws(px, py, si, cmj.LIGHT, key, seed, ps * ls,
                              ps * ls, **fs)
            bsu, bsv = _draws(px, py, si, cmj.BRDF, key, seed, ps * ls,
                              ps * ls, **fs)
            lidx = np.minimum((liu * np.float32(n_lights)).astype(np.int64),
                              n_lights - 1)
            lidx = torch.as_tensor(lidx, device=ctx.dev)
            lsu, lsv, bsu, bsv = (ctx.c(a) for a in (lsu, lsv, bsu, bsv))
            lp, _, lpdf = _chosen(lights, lidx,
                                  lambda L: L.sample(pos, lsu, lsv, tmin))
            li = pos - lp
            dist = sqrt(torch.clamp_min(dot(li, li), 1e-37))
            li = li / dist
            f_l, p_l = brdf_eval(kind, exponent, li, wo, nrm)
            ok_l = nee & (lpdf > 0.0) & (f_l > 0.0) & (p_l > 0.0)
            tmax_l = torch.where(ok_l, dist - tmin, 0.0)
            b_in, f_b, p_b = brdf_sample(kind, exponent, wo, nrm, bsu, bsv)
            ok_b = nee & (p_b > 0.0) & (f_b > 0.0)
            t_l, n_l, l_hit = _chosen(lights, lidx,
                                      lambda L: L.hit(pos, -b_in, tmin))
            ok_b = ok_b & l_hit
            tmax_b = torch.where(ok_b, torch.where(l_hit, t_l, 0.0) - tmin,
                                 0.0)
            occ = sc.occluded(pos, -li, time, tmin, tmax_l)
            blk = sc.occluded(pos, -b_in, time, tmin, tmax_b)
            emitted = _chosen(lights, lidx, lambda L: (
                V(L.emit.x.expand(n), L.emit.y.expand(n),
                  L.emit.z.expand(n)),))[0]
            ok_l = ok_l & ~occ
            w_l = power_heuristic(lpdf, p_l)
            gain_l = torch.where(ok_l, f_l * torch.abs(dot(-li, nrm)) * w_l
                                 / torch.clamp_min(lpdf, 1e-37), 0.0)
            acc = acc + emitted * cmod * gain_l
            wb = -b_in
            lpdf_b, = _chosen(lights, lidx, lambda L: (
                L.pdf(pos, wb, t_l, n_l),))
            ok_b = ok_b & ~blk & (lpdf_b > 0.0)
            w_b = power_heuristic(p_b, lpdf_b)
            gain_b = torch.where(ok_b, f_b * torch.abs(dot(wb, nrm)) * w_b
                                 / torch.clamp_min(p_b, 1e-37), 0.0)
            acc = acc + emitted * cmod * gain_b
        if nls:
            result = result + tp * acc * scale
        bu, bv = _draws(px, py, si, cmj.BOUNCE, key, seed, ps, ps)
        wc_in, f_c, p_c = brdf_sample(kind, exponent, wo, nrm, ctx.c(bu),
                                      ctx.c(bv))
        cont = lane & (p_c > 0.0)
        wc = -wc_in
        gain_c = torch.where(cont, f_c * torch.abs(dot(wc, nrm))
                             / torch.clamp_min(p_c, 1e-37), 1.0)
        tp = vwhere(cont, tp * cmod * gain_c, tp)
        o = vwhere(cont, pos, o)
        d = vwhere(cont, wc, d)
        alive = cont
    return torch.stack([result.x, result.y, result.z], dim=-1)


def render_pixels(scene: FlatScene, cam: dict, rc: dict, pix, device,
                  dtype=torch.float32, lanes_per_block: int = 32768,
                  rows: int = 512) -> np.ndarray:
    """Mean radiance [K, 3] (float32) of the flat pixel indices ``pix``
    (row-major, ``rc['width']`` wide): every sample of each pixel, summed
    in sample order and divided by the sample count."""
    pix = np.asarray(pix, np.int64)
    ctx = Ctx(scene, torch.device(device), dtype)
    sc = SceneT(ctx, rows)
    spp = rc["pixel_samples"] ** 2
    px = (pix % rc["width"]).astype(np.int64)
    py = (pix // rc["width"]).astype(np.int64)
    acc = torch.zeros((pix.shape[0], 3), dtype=dtype, device=ctx.dev)
    per = max(1, lanes_per_block)
    for k0 in range(0, pix.shape[0], per):
        k1 = min(k0 + per, pix.shape[0])
        for si in range(spp):
            s_arr = np.full(k1 - k0, si, np.int64)
            acc[k0:k1] += trace_lanes(sc, cam, rc, px[k0:k1], py[k0:k1],
                                      s_arr)
    return (acc / float(spp)).float().cpu().numpy()
