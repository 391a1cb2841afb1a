"""BRDFs dispatched by material kind over V3 wavefronts (counterpart of
``rayito_tpu/ops/brdf.py``).

Direction conventions: incoming points TOWARD the surface, outgoing AWAY.
All functions return solid-angle f/pdf; f is a scalar per lane. The
perfect mirror is a Dirac: evaluate is 0 with pdf 0, sample returns f=1
with pdf |n.i|. Emitters have no BRDF.
"""

from __future__ import annotations

import torch

from .vec3 import (
    PI,
    V3,
    div_scalar,
    dot,
    from_local_frame,
    make_coordinate_space,
    normalize,
    sqrt_ieee,
    where as vwhere,
)
from .warps import uniform_to_cosine_hemisphere

KIND_LAMBERT = 0
KIND_GLOSSY = 1
KIND_REFLECTION = 2
KIND_EMITTER = 3
KIND_PHONG = 4


_FLT_MIN = 1.1754943508222875e-38  # smallest normal float32


def _flush(x):
    """Flush subnormal results to zero, as the reference's arithmetic does
    (XLA on the CPU and the TPU run with flush-to-zero). The glossy lobe's
    high power underflows into that range, and whether f and pdf are
    exactly 0 decides which NEE queries are issued."""
    return torch.where(torch.abs(x) < _FLT_MIN, 0.0, x)


def _same_hemisphere(n_dot_i, n_dot_o):
    """Reflection requires incoming and outgoing on opposite sides."""
    return ((n_dot_i > 0.0) & (n_dot_o > 0.0)) | (
        (n_dot_i < 0.0) & (n_dot_o < 0.0)
    )


def lambert_evaluate_sa(incoming: V3, outgoing: V3, normal: V3):
    n_dot_i = dot(incoming, normal)
    n_dot_o = dot(outgoing, normal)
    reject = _same_hemisphere(n_dot_i, n_dot_o)
    f = torch.where(reject, 0.0, 1.0 / PI).to(n_dot_i.dtype)
    pdf = torch.where(reject, 0.0, div_scalar(torch.abs(n_dot_i), PI))
    return f, pdf


def lambert_sample_sa(outgoing: V3, normal: V3, u1, u2):
    local_incoming = -uniform_to_cosine_hemisphere(u1, u2)
    x, y, z = make_coordinate_space(normal)
    incoming = from_local_frame(local_incoming, x, y, z)
    flip = dot(outgoing, normal) < 0.0
    incoming = vwhere(flip, -incoming, incoming)
    pdf = div_scalar(torch.abs(dot(-incoming, normal)), PI)
    f = torch.full_like(pdf, 1.0 / PI)
    return incoming, f, pdf


def _glossy_half(incoming: V3, outgoing: V3, normal: V3) -> V3:
    """Half-vector with the near-parallel guard."""
    near = dot(outgoing, incoming) > 0.999
    h = normalize(outgoing - incoming)
    return vwhere(near, normal, h)


def glossy_evaluate_sa(incoming: V3, outgoing: V3, normal: V3, exponent):
    """Isotropic Ashikhmin-Shirley with the D-BRDF denominator."""
    n_dot_i = dot(incoming, normal)
    n_dot_o = dot(outgoing, normal)
    reject = _same_hemisphere(n_dot_i, n_dot_o)
    half = _glossy_half(incoming, outgoing, normal)
    n_dot_h = torch.abs(dot(normal, half))
    lobe = _flush(torch.pow(torch.clamp_min(n_dot_h, 0.0), exponent))
    d = _flush(div_scalar((exponent + 1.0) * lobe, 2.0 * PI))
    denom = 4.0 * torch.abs(n_dot_o + (-n_dot_i) - n_dot_o * (-n_dot_i))
    f = _flush(d / torch.clamp_min(denom, 1e-37))
    o_dot_h = torch.abs(dot(outgoing, half))
    pdf = _flush(d / torch.clamp_min(4.0 * o_dot_h, 1e-37))
    return torch.where(reject, 0.0, f), torch.where(reject, 0.0, pdf)


def glossy_sample_sa(outgoing: V3, normal: V3, u1, u2, exponent):
    phi = 2.0 * PI * u1
    cos_theta = torch.pow(
        torch.clamp_min(1.0 - u2, 0.0), 1.0 / (exponent + 1.0)
    )
    sin_theta = sqrt_ieee(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    local_half = V3(
        sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta
    )
    x, y, z = make_coordinate_space(normal)
    half = from_local_frame(local_half, x, y, z)
    flip = dot(outgoing, normal) < 0.0
    half = vwhere(flip, -half, half)
    incoming = outgoing - half * (2.0 * dot(outgoing, half))
    f, pdf = glossy_evaluate_sa(incoming, outgoing, normal, exponent)
    return incoming, f, pdf


def reflection_sample_sa(outgoing: V3, normal: V3):
    n_dot_o = dot(normal, outgoing)
    sgn = torch.where(n_dot_o < 0.0, 1.0, -1.0).to(n_dot_o.dtype)
    incoming = outgoing + normal * (2.0 * n_dot_o * sgn)
    pdf = torch.abs(dot(-incoming, normal))
    return incoming, torch.ones_like(pdf), pdf


def phong_shade(normal: V3, in_direction: V3, light_direction: V3, exponent):
    """Stage-3/4 Phong lobe: max(0, h.n)^exponent, h the unit half vector
    between the light and the reversed view direction."""
    half = normalize(light_direction - in_direction)
    return torch.pow(torch.clamp_min(dot(half, normal), 0.0), exponent)


def lambert_shade(normal: V3, light_direction: V3):
    """Stage-3/4 Lambert term max(0, l.n)."""
    return torch.clamp_min(dot(light_direction, normal), 0.0)


def is_dirac(kind):
    return kind == KIND_REFLECTION


def evaluate_sa(kind, exponent, incoming: V3, outgoing: V3, normal: V3):
    """Mask-blended BRDF evaluation; emitters and mirrors give (0, 0)."""
    f_l, pdf_l = lambert_evaluate_sa(incoming, outgoing, normal)
    f_g, pdf_g = glossy_evaluate_sa(incoming, outgoing, normal, exponent)
    is_l = kind == KIND_LAMBERT
    is_g = kind == KIND_GLOSSY
    f = torch.where(is_l, f_l, torch.where(is_g, f_g, 0.0))
    pdf = torch.where(is_l, pdf_l, torch.where(is_g, pdf_g, 0.0))
    return f, pdf


def sample_sa(kind, exponent, outgoing: V3, normal: V3, u1, u2):
    """Mask-blended BRDF sampling. Returns (incoming V3, f, pdf)."""
    i_l, f_l, pdf_l = lambert_sample_sa(outgoing, normal, u1, u2)
    i_g, f_g, pdf_g = glossy_sample_sa(outgoing, normal, u1, u2, exponent)
    i_r, f_r, pdf_r = reflection_sample_sa(outgoing, normal)
    is_g = kind == KIND_GLOSSY
    is_r = kind == KIND_REFLECTION
    incoming = vwhere(is_r, i_r, vwhere(is_g, i_g, i_l))
    f = torch.where(is_r, f_r, torch.where(is_g, f_g, f_l))
    pdf = torch.where(is_r, pdf_r, torch.where(is_g, pdf_g, pdf_l))
    # emitters (and the direct-lighting-only Phong) terminate the path
    none = (kind == KIND_EMITTER) | (kind == KIND_PHONG)
    return incoming, torch.where(none, 0.0, f), torch.where(none, 0.0, pdf)


def pdf_sa(kind, exponent, incoming: V3, outgoing: V3, normal: V3):
    """Solid-angle pdf of the in/out/normal configuration."""
    return evaluate_sa(kind, exponent, incoming, outgoing, normal)[1]


# Projected-solid-angle forms: the solid-angle pdf over |n.i| (the mirror's
# sampled pdf becomes exactly 1); reflectance is unchanged. The renderer
# calls only the solid-angle forms.


def _to_psa(pdf, incoming: V3, normal: V3):
    return pdf / torch.clamp_min(torch.abs(dot(incoming, normal)), 1e-37)


def evaluate_psa(kind, exponent, incoming: V3, outgoing: V3, normal: V3):
    """(f, pdf with respect to projected solid angle)."""
    f, pdf = evaluate_sa(kind, exponent, incoming, outgoing, normal)
    return f, _to_psa(pdf, incoming, normal)


def sample_psa(kind, exponent, outgoing: V3, normal: V3, u1, u2):
    """(incoming, f, pdf with respect to projected solid angle)."""
    incoming, f, pdf = sample_sa(kind, exponent, outgoing, normal, u1, u2)
    return incoming, f, _to_psa(pdf, incoming, normal)


def pdf_psa(kind, exponent, incoming: V3, outgoing: V3, normal: V3):
    """The solid-angle pdf over |n.i|."""
    return _to_psa(pdf_sa(kind, exponent, incoming, outgoing, normal),
                   incoming, normal)
