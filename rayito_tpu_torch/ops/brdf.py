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
    dot,
    from_local_frame,
    make_coordinate_space,
    normalize,
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
    pdf = torch.where(reject, 0.0, torch.abs(n_dot_i) / PI)
    return f, pdf


def lambert_sample_sa(outgoing: V3, normal: V3, u1, u2):
    local_incoming = -uniform_to_cosine_hemisphere(u1, u2)
    x, y, z = make_coordinate_space(normal)
    incoming = from_local_frame(local_incoming, x, y, z)
    flip = dot(outgoing, normal) < 0.0
    incoming = vwhere(flip, -incoming, incoming)
    pdf = torch.abs(dot(-incoming, normal)) / PI
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
    d = _flush((exponent + 1.0) * lobe / (2.0 * PI))
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
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
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
