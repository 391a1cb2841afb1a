"""Component-SoA 3-vectors of torch tensors.

Counterpart of ``rayito_tpu/ops/vec3.py``. A vector wavefront is a
:class:`V3`: three independent ``[N]`` component tensors. The port keeps
this layout at every public function so the parity tests compare like with
like; on the GPU it also keeps each component a dense, coalesced array.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

# Self-intersection epsilon & ray max (same values as the reference).
RAY_TMIN = 1.0e-4
RAY_TMIN_EARLY = 1.0e-5
RAY_TMAX = 1.0e30

PI = 3.14159265358979


@dataclasses.dataclass(frozen=True)
class V3:
    x: Any
    y: Any
    z: Any

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        if isinstance(o, V3):
            return V3(o.x - self.x, o.y - self.y, o.z - self.z)
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def __getitem__(self, idx):
        return V3(self.x[idx], self.y[idx], self.z[idx])

    @property
    def shape(self):
        return tuple(torch.as_tensor(self.x).shape)

    def broadcast_to(self, shape):
        return V3(
            torch.as_tensor(self.x).expand(shape),
            torch.as_tensor(self.y).expand(shape),
            torch.as_tensor(self.z).expand(shape),
        )


def div_scalar(x: torch.Tensor, s) -> torch.Tensor:
    """x / s for a Python number s, rounded as one IEEE division on every
    device. On a CUDA tensor PyTorch turns a division by a Python scalar
    into a multiply by its reciprocal, which rounds twice; a 0-d divisor
    on x's device does not (on the CPU both divide). See
    ``utils/div_audit.py``."""
    return x / torch.full((), float(s), dtype=torch.float32, device=x.device)


def sqrt_ieee(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device, the only
    float32 root the port takes (``utils/div_audit.py`` lists any other).
    PyTorch's float32 sqrt on the CPU is not correctly rounded (its AVX-512
    kernel took about 0.6% of seeded values in [0.01, 100] one ulp off), so
    there it is the float64 root rounded to float32 (53 >= 2 * 24 + 2 bits:
    the double rounding is exact); on the card ``torch.sqrt`` is correctly
    rounded and is taken as it is."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def splat(c, device=None) -> V3:
    """Constant vector (0-dim float32 tensors) from a length-3 sequence."""
    f = lambda v: torch.tensor(float(v), dtype=torch.float32, device=device)
    return V3(f(c[0]), f(c[1]), f(c[2]))


def from_aos(a) -> V3:
    """[..., 3] tensor -> V3 of [...] components."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def to_aos(v: V3):
    return torch.stack([v.x, v.y, v.z], dim=-1)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length2(v: V3):
    return dot(v, v)


def length(v: V3):
    return sqrt_ieee(length2(v))


def normalize(v: V3) -> V3:
    """Guards len > 0 like the reference; the root is ``sqrt_ieee``."""
    len2 = length2(v)
    inv = torch.where(
        len2 > 0.0, 1.0 / sqrt_ieee(torch.clamp_min(len2, 1e-37)), 1.0
    )
    return v * inv


def where(mask, a: V3, b: V3) -> V3:
    return V3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def reflect(v: V3, n: V3) -> V3:
    return n * (2.0 * dot(v, n)) - v


def lerp(a: V3, b: V3, t) -> V3:
    return a + (b - a) * t


def min_components(a: V3, b: V3) -> V3:
    return V3(torch.minimum(a.x, b.x), torch.minimum(a.y, b.y),
              torch.minimum(a.z, b.z))


def max_components(a: V3, b: V3) -> V3:
    return V3(torch.maximum(a.x, b.x), torch.maximum(a.y, b.y),
              torch.maximum(a.z, b.z))


def make_coordinate_space(normal: V3):
    """Orthonormal frame with Z = normal (the reference's up-vector rule):
    v2 = (0,1,0) unless the direction is exactly +/-Y, then (1,0,0)."""
    z = normalize(normal)
    not_y_axis = (z.x != 0.0) | (z.z != 0.0)
    zero = torch.zeros_like(z.x)
    up = V3(
        torch.where(not_y_axis, 0.0, 1.0).to(z.x.dtype),
        torch.where(not_y_axis, 1.0, 0.0).to(z.x.dtype),
        zero,
    )
    x = normalize(cross(up, z))
    y = cross(z, x)
    return x, y, z


def make_coordinate_space_tangent(normal: V3, tangent: V3):
    """Two-direction frame: Z = the unit normal, Y = normalize(tangent x
    Z), X = Z x Y (X as close to the tangent as the normal allows)."""
    z = normalize(normal)
    y = normalize(cross(tangent, z))
    return cross(z, y), y, z


def from_local_frame(v: V3, x: V3, y: V3, z: V3) -> V3:
    return x * v.x + y * v.y + z * v.z


def to_local_frame(v: V3, x: V3, y: V3, z: V3) -> V3:
    return V3(dot(v, x), dot(v, y), dot(v, z))
