"""Batched quaternion operations, component-SoA (counterpart of
``rayito_tpu/ops/quaternion.py``).

A quaternion wavefront is a :class:`Quat`: a scalar part ``w`` and a
:class:`~.vec3.V3` vector part, each component an ``[N]`` tensor (or a
0-dim one that broadcasts). ``multiply`` is the correct Hamilton product;
``multiply_buggy`` reproduces the reference renderer's aliasing-bugged
member ``operator*=`` for oracle comparisons only.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .vec3 import V3, cross, dot, normalize as vnormalize, sqrt_ieee
from .vec3 import where as vwhere


@dataclasses.dataclass(frozen=True)
class Quat:
    w: Any
    v: V3


# the identity rotation, as scalars that broadcast in torch.where
IDENTITY = Quat(1.0, V3(0.0, 0.0, 0.0))


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def quat(w, x, y, z) -> Quat:
    return Quat(_f32(w), V3(_f32(x), _f32(y), _f32(z)))


def identity() -> Quat:
    return quat(1.0, 0.0, 0.0, 0.0)


def from_axis_angle(axis: V3, angle) -> Quat:
    """Rotation of ``angle`` radians about ``axis`` (normalised here)."""
    axis = vnormalize(axis)
    half = _f32(angle) * 0.5
    return Quat(torch.cos(half), axis * torch.sin(half))


def from_euler_zyx(x_rot, y_rot, z_rot) -> Quat:
    """ZYX Euler angles to a quaternion."""
    x_rot, y_rot, z_rot = _f32(x_rot), _f32(y_rot), _f32(z_rot)
    cx, sx = torch.cos(x_rot * 0.5), torch.sin(x_rot * 0.5)
    cy, sy = torch.cos(y_rot * 0.5), torch.sin(y_rot * 0.5)
    cz, sz = torch.cos(z_rot * 0.5), torch.sin(z_rot * 0.5)
    return Quat(
        cz * cy * cx + sz * sy * sx,
        V3(
            cz * cy * sx - sz * sy * cx,
            cz * sy * cx + sz * cy * sx,
            sz * cy * cx - cz * sy * sx,
        ),
    )


def where(mask, a: Quat, b: Quat) -> Quat:
    return Quat(torch.where(mask, a.w, b.w), vwhere(mask, a.v, b.v))


def conjugate(q: Quat) -> Quat:
    return Quat(q.w, -q.v)


def norm2(q: Quat):
    return q.w * q.w + dot(q.v, q.v)


def normalize(q: Quat) -> Quat:
    """The correctly rounded square root (``sqrt_ieee``), as
    csrc/fold_small.cu takes it."""
    inv = 1.0 / sqrt_ieee(torch.clamp_min(norm2(q), 1e-37))
    return Quat(q.w * inv, q.v * inv)


def multiply(q1: Quat, q2: Quat) -> Quat:
    """Hamilton product q1 * q2."""
    return Quat(
        q1.w * q2.w - dot(q1.v, q2.v),
        q2.v * q1.w + q1.v * q2.w + cross(q1.v, q2.v),
    )


def rotate_vector(q: Quat, v: V3) -> V3:
    """q v q* in the form t = 2 qv x v; v' = v + w t + qv x t."""
    t = cross(q.v, v) * 2.0
    return v + t * q.w + cross(q.v, t)


def nlerp(q1: Quat, q2: Quat, t) -> Quat:
    """Normalised linear blend: the reference's quaternion interpolation."""
    t = _f32(t)
    return normalize(Quat(q1.w * (1.0 - t) + q2.w * t,
                          q1.v * (1.0 - t) + q2.v * t))


def slerp(q1: Quat, q2: Quat, t) -> Quat:
    """Shortest-arc slerp, falling back to nlerp when |dot| > 0.95."""
    d = q1.w * q2.w + dot(q1.v, q2.v)
    neg = d < 0.0
    q2a = Quat(torch.where(neg, -q2.w, q2.w), vwhere(neg, -q2.v, q2.v))
    d = torch.abs(d)
    use_lerp = d > 0.95
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    safe_sin = torch.where(sin_theta == 0.0, 1.0, sin_theta)
    t = _f32(t)
    w1 = torch.sin((1.0 - t) * theta) / safe_sin
    w2 = torch.sin(t * theta) / safe_sin
    slerped = Quat(q1.w * w1 + q2a.w * w2, q1.v * w1 + q2a.v * w2)
    nl = nlerp(q1, q2a, t)
    return Quat(torch.where(use_lerp, nl.w, slerped.w),
                vwhere(use_lerp, nl.v, slerped.v))


def to_axis_angle(q: Quat):
    """Inverse of from_axis_angle. Returns (axis V3, angle)."""
    qn = normalize(q)
    w = torch.clamp(qn.w, -1.0, 1.0)
    angle = 2.0 * torch.arccos(w)
    s = sqrt_ieee(torch.clamp_min(1.0 - w * w, 0.0))
    small = s < 1e-6
    inv = 1.0 / torch.where(small, 1.0, s)
    axis = vwhere(small,
                  V3(torch.ones_like(w), torch.zeros_like(w),
                     torch.zeros_like(w)),
                  qn.v * inv)
    return axis, angle


def multiply_buggy(q1: Quat, q2: Quat) -> Quat:
    """The reference renderer's member ``operator*=``: the scalar part is
    overwritten before the vector part is computed, so the vector part
    uses the NEW w. For oracle comparisons of stage-7 scene setup only."""
    new_w = q1.w * q2.w - dot(q1.v, q2.v)
    return Quat(new_w, q2.v * new_w + q1.v * q2.w + cross(q1.v, q2.v))
