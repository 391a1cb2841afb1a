"""Perspective camera with depth of field and shutter time (counterpart of
``rayito_tpu/models/camera.py``).

Reference quirks kept: ``tan_fov`` uses the FULL stated angle, right/up are
not normalized in the stage-5+ camera (the stage 1-4 camera,
``make_camera_ray_stage1``, normalizes them), and DOF is blended by mask.
Ray directions take the correctly rounded square root on every device
(``ops/vec3.sqrt_ieee``, as every root of the port does), so a card's
camera rays equal the CPU's bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.vec3 import PI, V3, cross, normalize, splat, sqrt_ieee
from ..ops.vec3 import where as vwhere
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


def _f32(v: float) -> float:
    """A Python float rounded to float32."""
    return float(torch.tensor(v, dtype=torch.float32))


_SCALARS = ("tan_fov", "focal_distance", "lens_radius", "shutter_open",
            "shutter_close")
_VECTORS = ("origin", "forward", "right", "up")


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera:
    """Precomputed camera basis and lens, as the reference's pytree: every
    field a 0-dim float32 tensor, on the CPU after ``make`` and on one
    device after ``to``. Rays are made on the camera's device; the render
    entry points move the camera once, so a pass copies nothing."""

    origin: V3
    forward: V3
    right: V3
    up: V3
    tan_fov: torch.Tensor
    focal_distance: torch.Tensor
    lens_radius: torch.Tensor
    shutter_open: torch.Tensor
    shutter_close: torch.Tensor

    @staticmethod
    def make(fov_degrees: float, origin, target, up,
             focal_distance: float = 16.0, lens_radius: float = 0.0,
             shutter_open: float = 0.0,
             shutter_close: float = 0.0) -> "PerspectiveCamera":
        o, fwd, right, cam_up = _look_basis(origin, target, up, False)
        f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
        return PerspectiveCamera(
            origin=o, forward=fwd, right=right, up=cam_up,
            tan_fov=f(math.tan(fov_degrees * PI / 180.0)),
            focal_distance=f(focal_distance), lens_radius=f(lens_radius),
            shutter_open=f(shutter_open), shutter_close=f(shutter_close),
        )

    def flat(self) -> torch.Tensor:
        """The 17 fields as one float32 [17] tensor on the camera's device
        (the order of ``from_flat``)."""
        vals = [c for k in _VECTORS
                for c in (getattr(self, k).x, getattr(self, k).y,
                          getattr(self, k).z)]
        return torch.stack(vals + [getattr(self, k) for k in _SCALARS])

    @staticmethod
    def from_flat(flat: torch.Tensor) -> "PerspectiveCamera":
        """The camera whose fields are views of ``flat`` [17]: writing
        ``flat`` moves the camera (the static input of a CUDA graph)."""
        vec = {k: V3(flat[3 * i], flat[3 * i + 1], flat[3 * i + 2])
               for i, k in enumerate(_VECTORS)}
        sca = {k: flat[12 + i] for i, k in enumerate(_SCALARS)}
        return PerspectiveCamera(**vec, **sca)

    @property
    def device(self) -> torch.device:
        return self.tan_fov.device

    def to(self, device) -> "PerspectiveCamera":
        """This camera on ``device`` (itself if it is there already), moved
        in one copy."""
        device = torch.device(device)
        if device == self.device:
            return self
        return PerspectiveCamera.from_flat(self.flat().to(device))

    def time(self, time_u):
        return self.shutter_open + (
            self.shutter_close - self.shutter_open
        ) * time_u

    def make_rays(self, x_screen, y_screen, lens_u, lens_v, time_u):
        """Rays for screen positions in [0,1]^2. Returns (origin V3 [N],
        direction V3 [N], time [N]). Depth of field is computed for every
        lane and blended in where ``lens_radius > 0``, as the reference
        does, so no Python branch reads the lens."""
        sx = (x_screen - 0.5) * self.tan_fov
        sy = (y_screen - 0.5) * self.tan_fov
        direction = normalize(self.forward + self.right * sx + self.up * sy)
        origin = self.origin.broadcast_to(sx.shape)
        t = self.time(time_u).expand(sx.shape)
        # depth of field: uniform-disk lens
        hshift, vshift = uniform_to_uniform_disk(lens_u, lens_v)
        hshift = hshift * self.lens_radius
        vshift = vshift * self.lens_radius
        local_len = sqrt_ieee(sx * sx + sy * sy + 1.0)
        focus = origin + direction * (self.focal_distance * local_len)
        lens_origin = origin + self.right * hshift + self.up * vshift
        lens_dir = normalize(focus - lens_origin)
        use_dof = self.lens_radius > 0.0
        return (vwhere(use_dof, lens_origin, origin),
                vwhere(use_dof, lens_dir, direction), t)


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
