"""Keyed Scale-Rotate-Translate transforms (motion blur), SoA (counterpart
of ``rayito_tpu/ops/transform.py``).

A scene's transforms live in padded tables: ``xf_times [X, K]``,
``xf_translate [X, K, 3]``, ``xf_scale [X, K, 3]``, ``xf_rotate [X, K, 4]``
(w, x, y, z) and ``xf_nkeys [X]``; keys past a slot's count repeat its last
key. Evaluation picks each lane's key pair at its time and interpolates:

  * times outside the key range peg to the first or last key;
  * translation and scale lerp, rotation nlerp (not slerp);
  * to local: (~R)(p - T)/S for points, (~R)v/S for vectors, (~R)n for
    normals, with no inverse-scale correction of normals (a documented
    quirk of the reference renderer).

Directions scale by the same 1/S as points, so local t equals world t.

Nested groups chain transforms: a slot's parent pointer (``xf_parent``,
-1 = root) names the enclosing group's slot. Rays enter local space
outermost link first; points, vectors and normals leave innermost first.
"""

from __future__ import annotations

import torch

from ..utils import tracing
from . import quaternion as quat
from .vec3 import V3, lerp


def eval_transform(xf_times, xf_translate, xf_scale, xf_rotate, xf_nkeys,
                   xf_id, time):
    """Evaluate TRS tracks at per-lane times ``time`` [...] f32.

    ``xf_id``: one slot for every lane (a host int, as every renderer call
    site passes) or an int tensor of per-lane slots. Returns (translation
    V3, scaling V3, rotation Quat) of time's shape."""
    if torch.is_tensor(xf_id) and xf_id.dim():
        return _eval_transform_lanes(xf_times, xf_translate, xf_scale,
                                     xf_rotate, xf_nkeys, xf_id, time)
    xid = int(xf_id)
    k = xf_times.shape[-1]
    row_t, row_s, row_r = xf_translate[xid], xf_scale[xid], xf_rotate[xid]
    if k == 1:
        sh = time.shape
        c = lambda a: a.expand(sh)
        return (V3(c(row_t[0, 0]), c(row_t[0, 1]), c(row_t[0, 2])),
                V3(c(row_s[0, 0]), c(row_s[0, 1]), c(row_s[0, 2])),
                quat.Quat(c(row_r[0, 0]), V3(c(row_r[0, 1]), c(row_r[0, 2]),
                                             c(row_r[0, 3]))))
    times = xf_times[xid]
    pair = torch.stack(_key_pair(times, xf_nkeys[xid], time))  # [2, ...]
    # one indexing op per track, component-major [C, 2, ...]: every
    # component of both keys is a contiguous row (gathering [..., 4]
    # rotation rows took ~80 us per 131,072-lane call on an H100,
    # tools/frame_profile_torch.py, and left strided components)
    tk, t2, s2, r2 = (row.t()[:, pair] for row in
                      (times[:, None], row_t, row_s, row_r))
    frac = _frac(tk[0, 0], tk[0, 1], time)
    v3 = lambda a, j: V3(a[0, j], a[1, j], a[2, j])
    q = lambda j: quat.Quat(r2[0, j], v3(r2[1:], j))
    return (lerp(v3(t2, 0), v3(t2, 1), frac),
            lerp(v3(s2, 0), v3(s2, 1), frac),
            quat.nlerp(q(0), q(1), frac))


def _key_pair(times, nkeys, time):
    """(idx, idx_next) long [...]: the lane's key at or before ``time``
    among the slot's ``nkeys`` valid keys, pegged to the ends."""
    k = times.shape[-1]
    key_valid = torch.arange(k, device=times.device) < nkeys[..., None]
    before = (times <= time[..., None]) & key_valid
    idx = torch.clamp_min(before.sum(dim=-1) - 1, 0)
    last = torch.clamp_min(nkeys.long() - 1, 0)
    idx = torch.minimum(idx, last)
    return idx, torch.minimum(idx + 1, last)


def _frac(t0, t1, time):
    denom = t1 - t0
    frac = torch.where(
        denom > 0.0, (time - t0) / torch.where(denom == 0.0, 1.0, denom), 0.0
    )
    return torch.clamp(frac, 0.0, 1.0)


def _eval_transform_lanes(xf_times, xf_translate, xf_scale, xf_rotate,
                          xf_nkeys, xf_id, time):
    """Per-lane transform ids (an API path; the renderer passes one id)."""
    k = xf_times.shape[-1]
    xid = xf_id.long().expand(time.shape)

    def key_v3(track, i):
        r = track[xid, i]
        return V3(r[..., 0], r[..., 1], r[..., 2])

    def key_quat(i):
        r = xf_rotate[xid, i]
        return quat.Quat(r[..., 0], V3(r[..., 1], r[..., 2], r[..., 3]))

    if k == 1:
        zero = torch.zeros_like(xid)
        return (key_v3(xf_translate, zero), key_v3(xf_scale, zero),
                key_quat(zero))
    times = xf_times[xid]  # [..., K]
    idx, idx_next = _key_pair(times, xf_nkeys[xid], time)
    frac = _frac(times.gather(-1, idx[..., None])[..., 0],
                 times.gather(-1, idx_next[..., None])[..., 0], time)
    return (lerp(key_v3(xf_translate, idx), key_v3(xf_translate, idx_next),
                    frac),
            lerp(key_v3(xf_scale, idx), key_v3(xf_scale, idx_next), frac),
            quat.nlerp(key_quat(idx), key_quat(idx_next), frac))


# ---------------------------------------------------------------------------
# Transform chains (nested groups)
# ---------------------------------------------------------------------------


def eval_chain(xf_times, xf_translate, xf_scale, xf_rotate, xf_nkeys,
               xf_parent, xf_id: int, time):
    """The links (translation, scaling, rotation) of slot ``xf_id`` and
    its ancestors at per-lane ``time``, child first. ``xf_parent`` is the
    host sequence of parent slots (-1 = root). The reference walks a
    static number of links and masks those past the root; the walk here
    stops at the root, which gives the same values."""
    links = []
    s = int(xf_id)
    with tracing.device_span("transforms", xf_times):
        while s >= 0:
            links.append(eval_transform(xf_times, xf_translate, xf_scale,
                                        xf_rotate, xf_nkeys, s, time))
            s = int(xf_parent[s])
    return links


def lane_links(scene, xf_id: int, time):
    """The transform chain of ``scene``'s slot ``xf_id`` at per-lane
    ``time``, child first, or None where nothing moves (a static scene, or
    slot 0: the identity)."""
    if not scene.has_motion or xf_id == 0:
        return None
    if not torch.is_tensor(time):
        time = torch.full((1,), float(time), dtype=torch.float32,
                          device=scene.device)
    return eval_chain(scene.xf_times, scene.xf_translate, scene.xf_scale,
                      scene.xf_rotate, scene.xf_nkeys, scene.xf_parent_host,
                      xf_id, time)


def chain_slots(scene, xf_id: int) -> list:
    """The slots of ``lane_links``' chain, outermost first, for a kernel
    that evaluates the links itself ([] where ``lane_links`` is None)."""
    if not scene.has_motion or xf_id == 0:
        return []
    chain = []
    s = int(xf_id)
    while s >= 0:
        chain.append(s)
        s = int(scene.xf_parent_host[s])
    return chain[::-1]


def local_ray(scene, xf_id: int, o: V3, d: V3, time):
    """The ray in the local space of ``scene``'s transform slot ``xf_id``:
    (o, d, world-from-local rotation, None for the identity)."""
    links = lane_links(scene, xf_id, time)
    if links is None:
        return o, d, None
    return ray_to_local_chain(links, o, d)


def ray_to_local_chain(links, o: V3, d: V3):
    """A ray through the chain, outermost link first. Returns (o_local,
    d_local, rot): ``rot`` is the composed world-from-local rotation
    (outermost * ... * innermost), for rotating normals back out."""
    with tracing.device_span("transforms", o.x):
        return ray_to_local(links, o, d)


def ray_to_local(links, o: V3, d: V3):
    """:func:`ray_to_local_chain` outside a ``transforms`` span, for a
    caller whose own span times it (``render/traverse.py``
    ``ray_pack_plain``)."""
    rot = None
    for tr, sc, ro in reversed(links):
        o = to_local_point(o, tr, sc, ro)
        d = to_local_vector(d, tr, sc, ro)
        rot = ro if rot is None else quat.multiply(rot, ro)
    return o, d, rot


def _apply_chain(links, x, one_link, innermost_first: bool):
    with tracing.device_span("transforms", x.x):
        for tr, sc, ro in (links if innermost_first else reversed(links)):
            x = one_link(x, tr, sc, ro)
    return x


def from_local_point_chain(links, p: V3) -> V3:
    """local -> world: innermost link first."""
    return _apply_chain(links, p, from_local_point, innermost_first=True)


def from_local_vector_chain(links, v: V3) -> V3:
    return _apply_chain(links, v, from_local_vector, innermost_first=True)


def from_local_normal_chain(links, n: V3) -> V3:
    return _apply_chain(links, n, from_local_normal, innermost_first=True)


def to_local_point_chain(links, p: V3) -> V3:
    """world -> local: outermost link first."""
    return _apply_chain(links, p, to_local_point, innermost_first=False)


def to_local_vector_chain(links, v: V3) -> V3:
    return _apply_chain(links, v, to_local_vector, innermost_first=False)


def to_local_point(p: V3, translation: V3, scaling: V3, rotation) -> V3:
    return quat.rotate_vector(quat.conjugate(rotation),
                              p - translation) / scaling


def from_local_point(p: V3, translation: V3, scaling: V3, rotation) -> V3:
    return quat.rotate_vector(rotation, p * scaling) + translation


def to_local_vector(v: V3, translation: V3, scaling: V3, rotation) -> V3:
    return quat.rotate_vector(quat.conjugate(rotation), v) / scaling


def from_local_vector(v: V3, translation: V3, scaling: V3, rotation) -> V3:
    return quat.rotate_vector(rotation, v * scaling)


def to_local_normal(n: V3, translation: V3, scaling: V3, rotation) -> V3:
    return quat.rotate_vector(quat.conjugate(rotation), n)


def from_local_normal(n: V3, translation: V3, scaling: V3, rotation) -> V3:
    return quat.rotate_vector(rotation, n)
