"""Perspective camera with depth of field and shutter time (counterpart of
``rayito_tpu/models/camera.py``).

Reference quirks kept: ``tan_fov`` uses the FULL stated angle, right/up are
not normalized in the stage-5+ camera (the stage 1-4 camera,
``make_camera_ray_stage1``, normalizes them), and DOF is blended by mask.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.vec3 import PI, V3, cross, normalize, splat
from ..ops.warps import uniform_to_uniform_disk


def _look_basis(origin, target, up, normalize_all: bool):
    """(origin, forward, right, up) as 0-dim float32 tensors on the CPU."""
    o = splat(origin)
    fwd = normalize(splat(target) - o)
    right = cross(fwd, splat(up))
    if normalize_all:
        right = normalize(right)
    cam_up = cross(right, fwd)
    if normalize_all:
        cam_up = normalize(cam_up)
    return o, fwd, right, cam_up


def _to(v: V3, device) -> V3:
    return V3(v.x.to(device), v.y.to(device), v.z.to(device))


def _f32(v: float) -> float:
    """A Python float rounded to float32."""
    return float(torch.tensor(v, dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera:
    """Precomputed camera basis (0-dim float32 tensors on the CPU; they
    broadcast against wavefronts on any device)."""

    origin: V3
    forward: V3
    right: V3
    up: V3
    tan_fov: float
    focal_distance: float
    lens_radius: float
    shutter_open: float
    shutter_close: float

    @staticmethod
    def make(fov_degrees: float, origin, target, up,
             focal_distance: float = 16.0, lens_radius: float = 0.0,
             shutter_open: float = 0.0,
             shutter_close: float = 0.0) -> "PerspectiveCamera":
        o, fwd, right, cam_up = _look_basis(origin, target, up, False)
        return PerspectiveCamera(
            origin=o, forward=fwd, right=right, up=cam_up,
            tan_fov=_f32(math.tan(fov_degrees * PI / 180.0)),
            focal_distance=_f32(focal_distance),
            lens_radius=_f32(lens_radius),
            shutter_open=_f32(shutter_open),
            shutter_close=_f32(shutter_close),
        )

    def to(self, device) -> "PerspectiveCamera":
        return dataclasses.replace(
            self, origin=_to(self.origin, device),
            forward=_to(self.forward, device), right=_to(self.right, device),
            up=_to(self.up, device),
        )

    def time(self, time_u):
        return self.shutter_open + (
            self.shutter_close - self.shutter_open
        ) * time_u

    def make_rays(self, x_screen, y_screen, lens_u, lens_v, time_u):
        """Rays for screen positions in [0,1]^2. Returns (origin V3 [N],
        direction V3 [N], time [N]) on the device of ``x_screen``."""
        cam = self.to(x_screen.device)
        sx = (x_screen - 0.5) * cam.tan_fov
        sy = (y_screen - 0.5) * cam.tan_fov
        direction = normalize(cam.forward + cam.right * sx + cam.up * sy)
        origin = cam.origin.broadcast_to(sx.shape)
        t = cam.time(time_u).expand(sx.shape)
        if cam.lens_radius > 0.0:  # depth of field: uniform-disk lens
            hshift, vshift = uniform_to_uniform_disk(lens_u, lens_v)
            hshift = hshift * cam.lens_radius
            vshift = vshift * cam.lens_radius
            local_len = torch.sqrt(sx * sx + sy * sy + 1.0)
            focus = origin + direction * (cam.focal_distance * local_len)
            origin = origin + cam.right * hshift + cam.up * vshift
            direction = normalize(focus - origin)
        return origin, direction, t


def make_camera_ray_stage1(fov_degrees, origin, target, up, xu, yu):
    """The free-function camera of stages 1-4: the stage-5+ direction math
    on a normalized right/up basis. xu, yu: [N] float32 screen positions.
    Returns (origin V3 [N], direction V3 [N]) on the device of ``xu``. The
    basis enters as float32 values held in Python floats, so nothing is
    copied to the device."""
    o, fwd, right, cam_up = (
        V3(float(v.x), float(v.y), float(v.z))
        for v in _look_basis(origin, target, up, True))
    tan_fov = _f32(math.tan(fov_degrees * PI / 180.0))
    direction = normalize(fwd + right * ((xu - 0.5) * tan_fov)
                          + cam_up * ((yu - 0.5) * tan_fov))
    return V3(*(torch.full_like(xu, c) for c in (o.x, o.y, o.z))), direction
