"""Integrators: stage-1 flat colour and stage-2/3/4 direct lighting
(counterpart of ``rayito_tpu/render/integrator.py``), and the screen-sample
generation every integrator shares.

One wavefront covers all pixels x a chunk of sample indices; the
reference's rolled loop over light samples is a Python loop here. Each
jitted pass of the reference is a CUDA graph on the card, captured once per
key and replayed (``utils/graphs.py``); the CPU runs it eagerly. The full
path tracer with NEE and MIS is ``render/pathtracer.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.camera import make_camera_ray_stage1
from ..models.scene import LIGHT_RECT, LIGHT_SPHERE, SceneData
from ..ops import rng as rngo
from ..ops.brdf import (KIND_EMITTER, KIND_LAMBERT, KIND_PHONG,
                        lambert_shade, phong_shade)
from ..ops.vec3 import (V3, cross, div_scalar, dot, from_aos, normalize,
                        sqrt_ieee, where as vwhere)
from ..ops.warps import uniform_to_sphere
from ..utils import graphs
from ..utils.config import RenderConfig
from .trace import material_emittance, material_row, scene_intersect


def _pixel_grid(width: int, height: int, device=None):
    """Row-major pixel coordinates (px, py), each [H * W] int32."""
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.int32, device=device),
        torch.arange(width, dtype=torch.int32, device=device),
        indexing="ij",
    )
    return px.reshape(-1), py.reshape(-1)


def screen_uv(config: RenderConfig, px, py, jx, jy):
    """Pixel indices + intra-pixel jitter -> [0,1]^2 screen coordinates
    (y flipped: image rows are top-down)."""
    div1 = config.pixel_div_minus_one
    w = float(config.width - 1 if div1 else config.width)
    h = float(config.height - 1 if div1 else config.height)
    xu = div_scalar(px.to(torch.float32) + jx, w)
    yu = 1.0 - div_scalar(py.to(torch.float32) + jy, h)
    if config.aspect_correction:
        aspect = float(torch.tensor(config.width, dtype=torch.float32)
                       / torch.tensor(config.height, dtype=torch.float32))
        xu = (xu - 0.5) * aspect + 0.5
    return xu, yu


def subpixel_draw(config: RenderConfig, spp_x: int, spp_y: int):
    """The stratified CMJ jitter in the pixel of the sample si, keyed by
    (pixel, purpose, seed): one ``Draw`` of a set."""
    return rngo.Draw(("px", "py", rngo.PURPOSE_SUBPIXEL, config.seed), spp_x,
                     spp_y)


def _subpixel_jitter(config: RenderConfig, px, py, si, spp_x: int,
                     spp_y: int):
    """(jx, jy): the subpixel jitter of the lanes, one draw set."""
    jx, jy = rngo.cmj_draws((subpixel_draw(config, spp_x, spp_y),), px, py,
                            si)
    return jx, jy


def direct_light_draws(config: RenderConfig, n_lights: int) -> tuple:
    """The light loop's draw set of a direct-lighting pass: for each light
    li, the seed hash_combine(px, py, si, PURPOSE_LIGHT, li, seed) and its
    2-D ls x ls samples of each k < ls^2 (an immediate index), rows
    2 (li ls^2 + k) and the one after."""
    ls = config.light_samples
    return tuple(
        rngo.Draw(("px", "py", "si", rngo.PURPOSE_LIGHT, li, config.seed),
                  ls, ls, index_mul=0, index_add=k)
        for li in range(n_lights) for k in range(ls * ls))


def _image(v: V3, n_si: int, h: int, w: int):
    """V3 wavefront of n_si samples x H x W -> [H, W, 3], summed over the
    samples."""
    return torch.stack([c.reshape(n_si, h, w).sum(dim=0)
                        for c in (v.x, v.y, v.z)], dim=-1)


def _camera_spec(camera):
    return tuple(tuple(float(x) for x in v) for v in camera)


# ---------------------------------------------------------------------------
# Stage 1: deterministic flat-colour render
# ---------------------------------------------------------------------------


def _color_pass_body(scene: SceneData, config: RenderConfig, fov: float,
                     camera):
    """[H, W, 3] on the scene's device: the hit material's colour, black
    on a miss."""
    px, py = _pixel_grid(config.width, config.height, scene.device)
    xu, yu = screen_uv(config, px, py, 0.0, 0.0)
    o, d = make_camera_ray_stage1(fov, *camera, xu, yu)
    hit = scene_intersect(scene, o, d, 0.0, config.ray_tmin, 1.0e30)
    color = material_row(scene, hit.mat)[1]
    zero = torch.zeros_like(color.x)
    color = vwhere(hit.valid, color, V3(zero, zero, zero))
    return _image(color, 1, config.height, config.width)


def _render_color_pass(scene: SceneData, config: RenderConfig, fov: float,
                       camera):
    """The stage-1 pass through ``utils/graphs.run``: on the card one
    replay of its graph (key: the reference's static arguments config,
    fov, camera, and the scene), the eager body on the CPU. [H, W, 3] on
    the scene's device."""
    return graphs.run(
        ("color", config, fov, camera), scene, scene.device,
        lambda: (_color_pass_body(scene, config, fov, camera),), {},
        label="color pass")[0]


def render_color(scene: SceneData, config: RenderConfig, fov=30.0,
                 camera=((0.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0))):
    """Stage-1 render: material colour on a hit, black on a miss; 1 spp,
    deterministic. Returns a numpy [H, W, 3] float32 image."""
    return _render_color_pass(scene, config, float(fov),
                              _camera_spec(camera)).cpu().numpy()


# ---------------------------------------------------------------------------
# Stages 2-4: direct lighting with per-light area sampling
# ---------------------------------------------------------------------------


def _material_shade(scene: SceneData, mat_ids, normal: V3, in_dir: V3,
                    light_dir: V3) -> V3:
    """Stage-3/4 Material::shade: lambert max(0, l.n) colour, phong
    max(0, h.n)^exponent colour, emitter 0."""
    kind, color, expo = material_row(scene, mat_ids)
    lamb = lambert_shade(normal, light_dir)
    phong = phong_shade(normal, in_dir, light_dir, expo)
    s = torch.where(kind == KIND_LAMBERT, lamb,
                    torch.where(kind == KIND_PHONG, phong, 0.0))
    s = torch.where(kind == KIND_EMITTER, 0.0, s)
    return color * s


def _sample_light_surface_direct(scene: SceneData, li: int, ref_pos: V3, u1,
                                 u2):
    """Stage-2/3 Light::sampleSurface of light ``li`` (a host index).

    Rect light: uniform in the parallelogram, its normal flipped toward the
    shading point. Sphere ShapeLight: a uniform point of the sphere, moved
    to the shading point's side. Returns (light point V3, light normal V3).
    """
    kind = scene.light_kinds_host[li]
    idx = scene.light_indices_host[li]
    if kind == LIGHT_RECT:
        corner = from_aos(scene.rect_corner)[idx]
        s1 = from_aos(scene.rect_side1)[idx]
        s2 = from_aos(scene.rect_side2)[idx]
        nrm = normalize(cross(s1, s2))
        pos = corner + s1 * u1 + s2 * u2
        nrm = nrm.broadcast_to(pos.shape)
        flip = dot(nrm, pos - ref_pos) > 0.0
        return pos, vwhere(flip, -nrm, nrm)
    if kind == LIGHT_SPHERE:
        center = from_aos(scene.sph_center)[idx]
        radius = scene.sph_radius[idx]
        nrm = uniform_to_sphere(u1, u2)
        pos = nrm * radius + center
        flip = dot(nrm, ref_pos - pos) < 0.0
        nrm = vwhere(flip, -nrm, nrm)
        pos = vwhere(flip, nrm * radius + center, pos)
        return pos, nrm
    raise NotImplementedError("a mesh ShapeLight has no direct-stage sampler")


def _direct_pass_body(scene: SceneData, config: RenderConfig, fov: float,
                      camera, spp_x: int, spp_y: int, si_chunk):
    """One wavefront over all pixels x the sample indices ``si_chunk``
    (int32 [n_si] on the scene's device), eagerly. Returns the SUM image
    over those samples, [H, W, 3] on the scene's device."""
    w, h = config.width, config.height
    dev = scene.device
    n_si = si_chunk.shape[0]
    px, py = _pixel_grid(w, h, dev)
    px = px.repeat(n_si)
    py = py.repeat(n_si)
    si = si_chunk[:, None].expand(n_si, w * h).reshape(-1)
    jx, jy = _subpixel_jitter(config, px, py, si, spp_x, spp_y)
    xu, yu = screen_uv(config, px, py, jx, jy)
    o, d = make_camera_ray_stage1(fov, *camera, xu, yu)
    n = xu.shape[0]
    tmin = config.ray_tmin

    hit = scene_intersect(scene, o, d, 0.0, tmin, 1.0e30)
    result = material_emittance(scene, hit.mat)
    position = o + d * hit.t
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)

    ls = config.light_samples
    ls_total = ls * ls
    u = rngo.cmj_draws(direct_light_draws(config, scene.n_lights), px, py,
                       si)
    for li in range(scene.n_lights):
        lc = scene.light_color[li]
        lpow = scene.light_power[li]
        emitted = V3(lc[0] * lpow, lc[1] * lpow, lc[2] * lpow)
        light_sid = scene.light_shape_id[li]
        is_rect = scene.light_kinds_host[li] == LIGHT_RECT
        acc = V3(zero, zero, zero)
        for k in range(ls_total):
            row = 2 * (li * ls_total + k)
            u1, u2 = u[row], u[row + 1]
            lp, _ = _sample_light_surface_direct(scene, li, position, u1, u2)
            to_light = lp - position
            dist = sqrt_ieee(torch.clamp_min(dot(to_light, to_light),
                                              1e-37))
            to_light = to_light / dist
            # the shadow ray is a full closest-hit query up to the sampled
            # point; a rect light accepts a hit on its own shape, a sphere
            # ShapeLight does not (the reference's pointer comparison)
            shadow = scene_intersect(scene, position, to_light, 0.0, tmin,
                                     dist)
            visible = ~shadow.valid
            if is_rect:
                visible = visible | (shadow.shape_id == light_sid)
            shade = _material_shade(scene, hit.mat, hit.normal, d, to_light)
            gain = torch.where(visible & hit.valid, hit.color_mod, 0.0)
            acc = acc + emitted * shade * gain
        result = result + acc * float(np.float32(1.0) / np.float32(ls_total))

    result = vwhere(hit.valid, result, V3(zero, zero, zero))
    return _image(result, n_si, h, w)


def _render_direct_pass(scene: SceneData, config: RenderConfig, fov: float,
                        camera, spp_x: int, spp_y: int, si_lo: int,
                        si_hi: int):
    """Sample indices [si_lo, si_hi) over all pixels through
    ``utils/graphs.run``: on the card one replay of the pass graph (key:
    the reference's static arguments config, fov, camera, spp_x, spp_y,
    and the scene and chunk size; the chunk's indices in a static buffer),
    the eager body on the CPU. The SUM image, [H, W, 3] on the scene's
    device."""
    def body(si):
        return (_direct_pass_body(scene, config, fov, camera, spp_x, spp_y,
                                  si),)

    return graphs.run(
        ("direct", config, fov, camera, spp_x, spp_y, si_hi - si_lo), scene,
        scene.device, body,
        {"si": torch.arange(si_lo, si_hi, dtype=torch.int32,
                            device=scene.device)},
        label=f"direct pass, {si_hi - si_lo} samples")[0]


def render_direct(scene: SceneData, config: RenderConfig, fov=45.0,
                  camera=((0.0, 5.0, 15.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
                  spp=None):
    """Stage-2/3/4 direct-lighting render. ``spp`` replaces the per-axis
    (pixel_samples x pixel_samples) stratification with an (spp, 1)
    pattern (stage 2 takes 64 unstratified samples). Samples are chunked
    into wavefronts of at most config.max_rays_per_pass rays; each chunk's
    sum is added on the host in float32, in chunk order. Returns a numpy
    [H, W, 3] float32 image."""
    if spp is not None:
        spp_x, spp_y = int(spp), 1
    else:
        spp_x = spp_y = config.pixel_samples
    cam = _camera_spec(camera)
    spp_total = spp_x * spp_y
    n_pix = config.width * config.height
    chunk = max(1, min(spp_total, config.max_rays_per_pass // n_pix))
    acc = np.zeros((config.height, config.width, 3), np.float32)
    for s0 in range(0, spp_total, chunk):
        acc += _render_direct_pass(scene, config, float(fov), cam, spp_x,
                                   spp_y, s0, min(s0 + chunk, spp_total)
                                   ).cpu().numpy()
    return acc / np.float32(spp_total)
