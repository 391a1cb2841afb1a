"""Sample-space warps over [N] tensors (counterpart of
``rayito_tpu/ops/warps.py``). Each takes float32 u1, u2 in [0,1)."""

from __future__ import annotations

import torch

from .vec3 import PI, V3, sqrt_ieee


def concentric_sample_disk(u1, u2):
    """PBRT-style concentric square->disk map; (0,0) maps to (0,0)."""
    sx = 2.0 * u1 - 1.0
    sy = 2.0 * u2 - 1.0
    cond_a = sx >= -sy
    cond_b = sx > sy
    cond_c = sx <= sy

    def safe(num, den):
        return num / torch.where(den == 0.0, 1.0, den)

    r1 = sx
    theta1 = torch.where(sy > 0.0, safe(sy, sx), 8.0 + safe(sy, sx))
    r2 = sy
    theta2 = 2.0 - safe(sx, sy)
    r3 = -sx
    theta3 = 4.0 - safe(sy, -sx)
    r4 = -sy
    theta4 = 6.0 + safe(sx, -sy)

    r = torch.where(
        cond_a, torch.where(cond_b, r1, r2), torch.where(cond_c, r3, r4)
    )
    theta = torch.where(
        cond_a,
        torch.where(cond_b, theta1, theta2),
        torch.where(cond_c, theta3, theta4),
    )
    theta = theta * (PI / 4.0)
    dx = r * torch.cos(theta)
    dy = r * torch.sin(theta)
    degenerate = (sx == 0.0) & (sy == 0.0)
    return torch.where(degenerate, 0.0, dx), torch.where(degenerate, 0.0, dy)


def uniform_to_sphere(u1, u2) -> V3:
    """Uniform point on the unit sphere."""
    z = 1.0 - 2.0 * u1
    radius = sqrt_ieee(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u2
    return V3(radius * torch.cos(phi), radius * torch.sin(phi), z)


def uniform_to_uniform_disk(u1, u2):
    """sqrt-r disk warp."""
    radius = sqrt_ieee(u1)
    theta = 2.0 * PI * u2
    return radius * torch.cos(theta), radius * torch.sin(theta)


def uniform_to_hemisphere(u1, u2) -> V3:
    """Uniform hemisphere, +Z up."""
    radius = sqrt_ieee(torch.clamp_min(1.0 - u1 * u1, 0.0))
    phi = 2.0 * PI * u2
    return V3(radius * torch.cos(phi), radius * torch.sin(phi), u1)


def uniform_to_cosine_hemisphere(u1, u2) -> V3:
    """Cosine-weighted hemisphere via concentric disk projection."""
    dx, dy = concentric_sample_disk(u1, u2)
    z = sqrt_ieee(torch.clamp_min(1.0 - dx * dx - dy * dy, 0.0))
    return V3(dx, dy, z)


def uniform_to_cone(u1, u2, cos_theta_max) -> V3:
    """Uniform direction in a cone about +Z."""
    cos_theta = u1 * (cos_theta_max - 1.0) + 1.0
    sin_theta = sqrt_ieee(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * PI * u2
    return V3(torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta,
              cos_theta)


def uniform_cone_pdf(cos_theta_max):
    """Solid-angle pdf of uniform_to_cone."""
    return torch.where(
        cos_theta_max >= 1.0,
        0.0,
        1.0 / (2.0 * PI * torch.clamp_min(1.0 - cos_theta_max, 1e-37)),
    )


def uniform_to_barycentric_triangle(u1, u2):
    """Uniform barycentrics: (1 - sqrt(u1), u2 * sqrt(u1))."""
    s = sqrt_ieee(u1)
    return 1.0 - s, u2 * s
