"""Wavefront path tracer with next-event estimation and two-way MIS
(counterpart of ``rayito_tpu/render/pathtracer.py``).

The reference's rolled ``lax.fori_loop`` over bounces and light samples,
and its ``lax.scan`` over launches, are Python loops here; everything
inside runs as tensor ops on the scene's device. Semantics are the
reference's: emission only at bounce 0 or through an unbroken chain of
Dirac bounces, uniform light selection per sample, power-heuristic MIS
between a light sample and a BRDF sample (each with its own shadow query),
light scale n_lights / num_light_samples, no Russian roulette.

Analytic lights (rect, sphere) only, at most ``ROLL_LIGHTS`` of them; mesh
lights and the rolled many-light loop come with later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.camera import PerspectiveCamera
from ..models.scene import LIGHT_RECT, LIGHT_SPHERE, SceneData
from ..ops import rng as rngo
from ..ops.brdf import (
    KIND_EMITTER,
    KIND_GLOSSY,
    KIND_REFLECTION,
    evaluate_sa,
    sample_sa,
)
from ..ops.mis import power_heuristic
from ..ops.vec3 import RAY_TMAX, V3, dot, where as vwhere
from ..utils.config import RenderConfig
from . import lights as L
from .integrator import _pixel_grid, _subpixel_jitter, screen_uv
from .trace import (
    material_emittance,
    material_row,
    scene_intersect,
    scene_occluded_pair,
)

ROLL_LIGHTS = 8


def _mat_lookup(scene: SceneData, mat_ids):
    kind, color, param = material_row(scene, mat_ids)
    # glossy exponent = 1/roughness^2
    exponent = torch.where(
        kind == KIND_GLOSSY, 1.0 / torch.clamp_min(param * param, 1e-12), 1.0
    )
    return kind, color, exponent


def _select(stacked, light_idx):
    """stacked [L, N] -> per-lane row light_idx [N]."""
    return stacked.gather(0, light_idx.long()[None, :])[0]


def _select_v3(vs, light_idx) -> V3:
    return V3(
        _select(torch.stack([v.x for v in vs]), light_idx),
        _select(torch.stack([v.y for v in vs]), light_idx),
        _select(torch.stack([v.z for v in vs]), light_idx),
    )


def pathtrace_wave(scene: SceneData, config: RenderConfig, o: V3, d: V3,
                   time, px, py, si, active=None):
    """Trace one wavefront of camera rays to completion.

    o, d: V3 of [N]; time [N]; px, py [N] pixel coords; si [N] pixel-sample
    index. Returns (radiance V3 of [N], overflow 0, queries [] int64 on the
    device): ``queries`` counts the scene queries the integrator issues —
    alive-lane traces plus NEE shadow / BRDF-side queries on lanes whose
    masks require one — the ray-throughput denominator, as the reference
    defines it. ``active`` (bool [N]) marks launch-padding lanes dead from
    bounce 0."""
    n_lights = scene.n_lights
    if n_lights > ROLL_LIGHTS:
        raise NotImplementedError(
            f"more than {ROLL_LIGHTS} lights (rolled NEE) is not ported yet"
        )
    if any(k not in (LIGHT_RECT, LIGHT_SPHERE)
           for k in scene.light_kinds_host):
        raise NotImplementedError("mesh lights are not ported yet")
    n = o.x.shape[0]
    dev = o.x.device
    f32 = torch.float32
    zeros = torch.zeros((n,), dtype=f32, device=dev)
    result = V3(zeros, zeros, zeros)
    ones = torch.ones((n,), dtype=f32, device=dev)
    throughput = V3(ones, ones, ones)
    alive = (torch.ones((n,), dtype=torch.bool, device=dev)
             if active is None else active)
    num_dirac = torch.zeros((n,), dtype=torch.int32, device=dev)
    queries = torch.zeros((), dtype=torch.int64, device=dev)

    nls = config.light_samples * config.light_samples if n_lights else 0
    ps = config.pixel_samples
    ls = config.light_samples
    seed = config.seed
    tmin = config.ray_tmin
    emitted_const = [L.light_emitted(scene, li) for li in range(n_lights)]

    for bounce in range(config.max_depth):
        hit = scene_intersect(scene, o, d, time, tmin,
                              torch.where(alive, RAY_TMAX, 0.0))
        queries = queries + alive.sum()
        lane = alive & hit.valid
        kind, mat_color, exponent = _mat_lookup(scene, hit.mat)

        # emission: camera-visible or through a pure-Dirac chain
        gate = lane & ((bounce == 0) | (num_dirac == bounce))
        result = result + vwhere(gate, throughput * material_emittance(
            scene, hit.mat), V3(zeros, zeros, zeros))
        lane = lane & (kind != KIND_EMITTER)  # emitters end the path
        is_dirac = (kind == KIND_REFLECTION) & lane
        num_dirac = num_dirac + is_dirac.to(torch.int32)

        position = o + d * hit.t
        outgoing = -d
        normal = hit.normal
        cmod_color = mat_color * hit.color_mod

        if n_lights > 0 and nls > 0:
            nee_lane = lane & ~is_dirac
            perm_sel = rngo.hash_combine(
                px, py, rngo.PURPOSE_LIGHT_SELECT, bounce, seed)
            perm_elem = rngo.hash_combine(
                px, py, rngo.PURPOSE_LIGHT_ELEMENT, bounce, seed)
            perm_light = rngo.hash_combine(
                px, py, rngo.PURPOSE_LIGHT, bounce, seed)
            perm_brdf = rngo.hash_combine(
                px, py, rngo.PURPOSE_BRDF, bounce, seed)
            acc = V3(zeros, zeros, zeros)
            for lsi in range(nls):
                fsi = rngo.u32(si) * nls + lsi
                liu = rngo.cmj_sample_1d(fsi, (ps * ls) ** 2, perm_sel)
                light_idx = torch.clamp_max(
                    (liu * n_lights).to(torch.int32), n_lights - 1
                )
                lsu, lsv = rngo.cmj_sample_2d(fsi, ps * ls, ps * ls,
                                              perm_light)
                leu = rngo.cmj_sample_1d(fsi, (ps * ls) ** 2, perm_elem)

                # sample every light, keep each lane's chosen one
                cand = [L.sample_light(scene, li, position, normal, time,
                                       lsu, lsv, leu, tmin)
                        for li in range(n_lights)]
                lp = _select_v3([c[0] for c in cand], light_idx)
                lpdf = _select(torch.stack([c[2] for c in cand]), light_idx)
                emitted = _select_v3(
                    [e.broadcast_to((n,)) for e in emitted_const], light_idx
                )

                # light-sampled direction
                light_incoming = position - lp
                dist = torch.sqrt(torch.clamp_min(
                    dot(light_incoming, light_incoming), 1e-37))
                light_incoming = light_incoming / dist
                f_l, brdf_pdf_l = evaluate_sa(kind, exponent, light_incoming,
                                              outgoing, normal)
                ok_l = (nee_lane & (lpdf > 0.0) & (f_l > 0.0)
                        & (brdf_pdf_l > 0.0))
                queries = queries + ok_l.sum()
                tmax_l = torch.where(ok_l, dist - tmin, 0.0)

                # BRDF-sampled direction toward the same light: analytic
                # light hit + one any-hit occlusion query
                bsu, bsv = rngo.cmj_sample_2d(fsi, ps * ls, ps * ls,
                                              perm_brdf)
                b_in, f_b, pdf_b = sample_sa(kind, exponent, outgoing,
                                             normal, bsu, bsv)
                ok_b = nee_lane & (pdf_b > 0.0) & (f_b > 0.0)
                hits = [L.light_hit_analytic(scene, li, position, -b_in,
                                             time, tmin)
                        for li in range(n_lights)]
                t_l = _select(torch.stack([h[0] for h in hits]), light_idx)
                n_l = _select_v3([h[1] for h in hits], light_idx)
                l_hit = _select(torch.stack([h[2] for h in hits]), light_idx)
                ok_b = ok_b & l_hit
                queries = queries + ok_b.sum()
                occluded, blocked, _ = scene_occluded_pair(
                    scene, position, -light_incoming, tmax_l, -b_in,
                    torch.where(ok_b, torch.where(l_hit, t_l, 0.0) - tmin,
                                0.0),
                    time, tmin, live=ok_l | ok_b,
                )
                hit_light = ok_b & ~blocked

                ok_l = ok_l & ~occluded
                w_l = power_heuristic(1.0, lpdf, 1.0, brdf_pdf_l)
                gain_l = torch.where(
                    ok_l,
                    f_l * torch.abs(dot(-light_incoming, normal)) * w_l
                    / torch.clamp_min(lpdf, 1e-37),
                    0.0,
                )
                acc = acc + emitted * cmod_color * gain_l
                lpdf_b = _select(torch.stack([
                    L.light_intersect_pdf(scene, li, position, -b_in, t_l,
                                          n_l, time)
                    for li in range(n_lights)
                ]), light_idx)
                ok_b = hit_light & (lpdf_b > 0.0)
                w_b = power_heuristic(1.0, pdf_b, 1.0, lpdf_b)
                gain_b = torch.where(
                    ok_b,
                    f_b * torch.abs(dot(-b_in, normal)) * w_b
                    / torch.clamp_min(pdf_b, 1e-37),
                    0.0,
                )
                acc = acc + emitted * cmod_color * gain_b
            result = result + throughput * acc * float(
                np.float32(n_lights) / np.float32(nls)
            )

        # BRDF sample for the path continuation
        perm_bounce = rngo.hash_combine(px, py, rngo.PURPOSE_BOUNCE, bounce,
                                        seed)
        bu, bv = rngo.cmj_sample_2d(si, ps, ps, perm_bounce)
        incoming, f_c, pdf_c = sample_sa(kind, exponent, outgoing, normal,
                                         bu, bv)
        cont = lane & (pdf_c > 0.0)
        gain_c = torch.where(
            cont,
            f_c * torch.abs(dot(-incoming, normal))
            / torch.clamp_min(pdf_c, 1e-37),
            1.0,
        )
        throughput = vwhere(cont, throughput * cmod_color * gain_c,
                            throughput)
        o = vwhere(cont, position, o)
        d = vwhere(cont, -incoming, d)
        alive = cont
    return result, 0, queries


def _render_path_pass(scene: SceneData, config: RenderConfig,
                      camera: PerspectiveCamera, si_chunk, row0=0,
                      rows: int = 0):
    """Pixel rows [row0, row0+rows) x the sample indices ``si_chunk``.
    Returns (SUM image [rows, W, 3] on the device, overflow 0, queries)."""
    dev = scene.device
    w = config.width
    rows = rows or config.height
    si_chunk = torch.as_tensor(si_chunk, dtype=torch.int32, device=dev)
    n_si = si_chunk.shape[0]
    px, py = _pixel_grid(w, rows, dev)
    py = py + int(row0)
    px = px.repeat(n_si)
    py = py.repeat(n_si)
    si = si_chunk.repeat_interleave(w * rows)
    ps = config.pixel_samples

    jx, jy = _subpixel_jitter(config, px, py, si, ps, ps)
    xu, yu = screen_uv(config, px, py, jx, jy)
    perm_lens = rngo.hash_combine(px, py, rngo.PURPOSE_LENS, config.seed)
    lens_u, lens_v = rngo.cmj_sample_2d(si, ps, ps, perm_lens)
    perm_time = rngo.hash_combine(px, py, rngo.PURPOSE_TIME, config.seed)
    time_u = rngo.cmj_sample_1d(si, ps * ps, perm_time)

    o, d, t = camera.make_rays(xu, yu, lens_u, lens_v, time_u)
    radiance, overflow, queries = pathtrace_wave(scene, config, o, d, t, px,
                                                 py, si)
    img = torch.stack(
        [c.reshape(n_si, rows, w).sum(dim=0)
         for c in (radiance.x, radiance.y, radiance.z)],
        dim=-1,
    )
    return img, overflow, queries


def _render_path_frame(scene: SceneData, config: RenderConfig,
                       camera: PerspectiveCamera, si_mat, row0s,
                       rows: int = 0):
    """A launch grid: one _render_path_pass per (sample chunk, row band).
    si_mat [L, k] sample indices per launch, row0s [L] first rows.
    Returns (imgs [L, rows, W, 3], overflow 0, queries summed) on the
    device — no host synchronisation."""
    imgs = []
    queries = torch.zeros((), dtype=torch.int64, device=scene.device)
    for si, r0 in zip(si_mat, row0s):
        img, _, q = _render_path_pass(scene, config, camera, si, int(r0),
                                      rows)
        imgs.append(img)
        queries = queries + q
    return torch.stack(imgs), 0, queries


def render_path_with_stats(scene: SceneData, config: RenderConfig,
                           camera: PerspectiveCamera):
    """Path-traced render (box-filtered mean of pixel_samples^2 samples).
    Returns (image np [H, W, 3], overflow 0, queries int). Launches hold at
    most config.max_rays_per_pass lanes: chunks of sample indices first,
    then pixel-row bands when one sample exceeds the budget. Each launch's
    image is added on the host in the reference's order, so memory stays
    bounded by one launch."""
    spp_total = config.pixel_samples * config.pixel_samples
    w, h = config.width, config.height
    acc = np.zeros((h, w, 3), np.float32)
    queries = 0
    if w * h <= config.max_rays_per_pass:
        chunk = max(1, min(spp_total, config.max_rays_per_pass // (w * h)))
        for s0 in range(0, spp_total, chunk):
            si = np.arange(s0, min(s0 + chunk, spp_total), dtype=np.int32)
            img, _, q = _render_path_pass(scene, config, camera, si)
            acc += img.cpu().numpy()
            queries += int(q)
    else:
        band = max(1, config.max_rays_per_pass // w)
        n_bands = -(-h // band)
        # uniform band height; the last band is shifted up and cropped
        r0s = [min(b * band, h - band) for b in range(n_bands)]
        for s0 in range(spp_total):
            for b, r0 in enumerate(r0s):
                img, _, q = _render_path_pass(scene, config, camera, [s0],
                                              r0, band)
                skip = max(0, b * band - r0)
                acc[r0 + skip:r0 + band] += img.cpu().numpy()[skip:]
                queries += int(q)
    return acc / np.float32(spp_total), 0, queries


def render_path(scene: SceneData, config: RenderConfig,
                camera: PerspectiveCamera):
    """render_path_with_stats, image only."""
    return render_path_with_stats(scene, config, camera)[0]
