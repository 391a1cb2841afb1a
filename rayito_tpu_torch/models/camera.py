"""Perspective camera with depth of field and shutter time (counterpart of
``rayito_tpu/models/camera.py``).

Reference quirks kept: ``tan_fov`` uses the FULL stated angle, right/up are
not normalized in the stage-5+ camera, and DOF is blended by mask.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.vec3 import PI, V3, cross, normalize, splat
from ..ops.warps import uniform_to_uniform_disk


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
        o = splat(origin)
        fwd = normalize(splat(target) - o)
        right = cross(fwd, splat(up))
        cam_up = cross(right, fwd)
        f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))
        return PerspectiveCamera(
            origin=o, forward=fwd, right=right, up=cam_up,
            tan_fov=f32(math.tan(fov_degrees * PI / 180.0)),
            focal_distance=f32(focal_distance),
            lens_radius=f32(lens_radius),
            shutter_open=f32(shutter_open),
            shutter_close=f32(shutter_close),
        )

    def to(self, device) -> "PerspectiveCamera":
        mv = lambda v: V3(v.x.to(device), v.y.to(device), v.z.to(device))
        return dataclasses.replace(
            self, origin=mv(self.origin), forward=mv(self.forward),
            right=mv(self.right), up=mv(self.up),
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
