"""Wavefront path tracer with next-event estimation and two-way MIS
(counterpart of ``rayito_tpu/render/pathtracer.py``).

The reference's rolled ``lax.fori_loop`` over bounces and light samples
is a Python loop here; everything inside runs as tensor ops on the scene's
device. The reference's dispatch is ported whole: a jitted pass is a CUDA
graph captured once per (scene, config, rows, samples per launch) and
replayed (``utils/graphs.py``), ``_render_path_frame`` replays it over a
launch grid without reading anything back, and ``_dispatch_grid`` splits a
grid into the reference's bounded groups, on either mesh route. The CPU
runs the same pass eagerly (``utils/graphs.run``).

Semantics are the reference's: emission only at bounce 0 or through an
unbroken chain of Dirac bounces, uniform light selection per sample,
power-heuristic MIS between a light sample and a BRDF sample (each with
its own shadow query), light scale n_lights / num_light_samples, no
Russian roulette.

With only analytic lights (rect, sphere) the BRDF-side sample is an
analytic light hit plus an any-hit query; one mesh light in the scene turns
it, for every light, into a full closest-hit query whose hit must be the
chosen light's shape. Each lane evaluates its chosen light only
(``lights.*_rolled``), at every light count.

``overflow`` sums the candidates the ``traversal='xla'`` route's K1/K2
truncation dropped, over the closest-hit and NEE queries of every bounce
and light sample: an int64 device scalar there, the int 0 on the kernel
route (no truncation, no extra launch). ``render_path`` warns when it is
positive.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..models.camera import PerspectiveCamera
from ..models.scene import SceneData
from ..ops import rng as rngo
from ..ops.vec3 import RAY_TMAX, V3
from ..utils import graphs, tracing
from ..utils.config import RenderConfig
from . import shade
from .integrator import _image, _pixel_grid, screen_uv, subpixel_draw
from .trace import scene_intersect, scene_occluded, scene_occluded_pair

# the reference's threshold for its rolled light loop; here it only times
# the compile-time warning about a mesh light in a larger set
ROLL_LIGHTS = 8


def pathtrace_wave(scene: SceneData, config: RenderConfig, o: V3, d: V3,
                   time, px, py, si, active=None):
    """Trace one wavefront of camera rays to completion.

    o, d: V3 of [N]; time [N]; px, py [N] pixel coords; si [N] pixel-sample
    index. Returns (radiance V3 of [N], overflow (see the module
    docstring), queries [] int64 on the device): ``queries`` counts the
    scene queries the integrator issues — alive-lane traces plus NEE
    shadow / BRDF-side queries on lanes whose masks require one — the
    ray-throughput denominator, as the reference defines it. ``active`` (bool [N]) marks launch-padding lanes dead from
    bounce 0.

    A bounce: the closest-hit query, the bounce's draw set, the shading
    before the shadow queries (``shade.bounce_prepare``), each light
    sample's queries, the shading after them (``shade.bounce_resolve``):
    on the card two kernel launches around the queries."""
    n_lights = scene.n_lights
    analytic = shade.analytic_lights(scene)
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
    overflow = 0

    nls = shade.light_samples(scene, config)
    tmin = config.ray_tmin

    for bounce in range(config.max_depth):
        with tracing.device_span(f"bounce[{bounce}]", dev):
            with tracing.device_span("query.closest", dev):
                hit = scene_intersect(scene, o, d, time, tmin,
                                      torch.where(alive, RAY_TMAX, 0.0))
            overflow = overflow + hit.overflow
            n_alive = alive.sum()
            tracing.count("query.rays.closest", n_alive)
            queries = queries + n_alive
            # every draw of the bounce in one set (bounce_draws)
            with tracing.device_span("draws", dev):
                u = rngo.cmj_draws(bounce_draws(config, n_lights, bounce),
                                   px, py, si)
            with tracing.device_span("shading.prepare", dev):
                prep = shade.bounce_prepare(scene, config, bounce, hit, u,
                                            throughput, alive, num_dirac, o,
                                            d, time, result)
            num_dirac = prep.num_dirac
            if nls:
                n_shadow = prep.ok_l.sum() + prep.ok_b.sum()
                tracing.count("query.rays.shadow", n_shadow)
                queries = queries + n_shadow
            occluded, blocked, hits = [], [], []
            for lsi in range(nls):
                with tracing.device_span(f"query.shadow[{lsi}]", dev):
                    occ, blk, h, ovf = _shadow_queries(scene, prep, lsi,
                                                       analytic, time, tmin)
                if analytic:
                    blocked.append(blk)
                else:
                    hits.append(h)
                occluded.append(occ)
                overflow = overflow + ovf
            with tracing.device_span("shading.resolve", dev):
                result, throughput, o, d, alive = shade.bounce_resolve(
                    scene, config, prep, hit.normal, throughput, o, d, time,
                    occluded, blocked if analytic else None,
                    None if analytic else hits)
    return result, overflow, queries


def _shadow_queries(scene: SceneData, prep, lsi: int, analytic: bool, time,
                    tmin):
    """Light sample ``lsi``'s NEE queries: (occluded, blocked or None, the
    BRDF side's hit or None, overflow). With analytic lights both sides
    are any-hit queries; a mesh light has no analytic hit, so the BRDF
    side is the full closest hit, for every light of the scene (dead lanes
    carry tmax = tmin)."""
    if analytic:
        occ, blk, ovf = scene_occluded_pair(
            scene, prep.position, prep.wl[lsi], prep.tmax_l[lsi],
            prep.wb[lsi], prep.tmax_b[lsi], time, tmin, live=None)
        return occ, blk, None, ovf
    occ, ovf = scene_occluded(scene, prep.position, prep.wl[lsi], time, tmin,
                              prep.tmax_l[lsi])
    h = scene_intersect(scene, prep.position, prep.wb[lsi], time, tmin,
                        prep.tmax_b[lsi])
    return occ, None, h, ovf + h.overflow


def camera_draws(config: RenderConfig) -> tuple:
    """The camera's draw set: the subpixel jitter (2-D), the lens sample
    (2-D) and the shutter time (1-D), each of the pixel sample si; rows
    jx, jy, lens_u, lens_v, time_u."""
    ps, seed = config.pixel_samples, config.seed
    return (subpixel_draw(config, ps, ps),
            rngo.Draw(("px", "py", rngo.PURPOSE_LENS, seed), ps, ps),
            rngo.Draw(("px", "py", rngo.PURPOSE_TIME, seed), ps * ps))


def bounce_draws(config: RenderConfig, n_lights: int, bounce: int) -> tuple:
    """One bounce's draw set: with lights, for each light sample lsi (the
    flat index si * nls + lsi) the light choice (1-D), the point on it
    (2-D), its element (1-D) and the BRDF direction toward it (2-D), rows
    6 lsi to 6 lsi + 5; then the continuation's BRDF sample (2-D), the
    last two rows."""
    ps, ls, seed = config.pixel_samples, config.light_samples, config.seed
    nls = ls * ls if n_lights else 0
    key = lambda purpose: ("px", "py", purpose, bounce, seed)  # noqa: E731
    plan = []
    for lsi in range(nls):
        fsi = dict(index_mul=nls, index_add=lsi)
        plan += [
            rngo.Draw(key(rngo.PURPOSE_LIGHT_SELECT), (ps * ls) ** 2, **fsi),
            rngo.Draw(key(rngo.PURPOSE_LIGHT), ps * ls, ps * ls, **fsi),
            rngo.Draw(key(rngo.PURPOSE_LIGHT_ELEMENT), (ps * ls) ** 2,
                      **fsi),
            rngo.Draw(key(rngo.PURPOSE_BRDF), ps * ls, ps * ls, **fsi)]
    plan.append(rngo.Draw(key(rngo.PURPOSE_BOUNCE), ps, ps))
    return tuple(plan)


def _camera_rays(config: RenderConfig, camera: PerspectiveCamera, px, py,
                 si):
    """Camera rays (origin V3, direction V3, time) of the lanes (px, py,
    si): subpixel jitter, lens and shutter-time samples per lane, one draw
    set (camera_draws)."""
    jx, jy, lens_u, lens_v, time_u = rngo.cmj_draws(camera_draws(config),
                                                    px, py, si)
    xu, yu = screen_uv(config, px, py, jx, jy)
    return camera.make_rays(xu, yu, lens_u, lens_v, time_u)


def _path_pass_body(scene: SceneData, config: RenderConfig,
                    camera: PerspectiveCamera, si, row0, rows: int):
    """The pass itself, eagerly: pixel rows [row0, row0 + rows) x the
    sample indices ``si`` (int32 [n_si] on the scene's device; ``row0`` an
    int32 device scalar, as the reference traces it). Returns (SUM image
    [rows, W, 3], overflow, queries) on the device; reads nothing back on
    the kernel route."""
    dev = scene.device
    w = config.width
    n_si = si.shape[0]
    with tracing.device_span("camera_rays", dev):
        px, py = _pixel_grid(w, rows, dev)
        py = py + row0
        px = px.repeat(n_si)
        py = py.repeat(n_si)
        si = si.repeat_interleave(w * rows)
        o, d, t = _camera_rays(config, camera.to(dev), px, py, si)
    radiance, overflow, queries = pathtrace_wave(scene, config, o, d, t, px,
                                                 py, si)
    with tracing.device_span("image", dev):
        return _image(radiance, n_si, rows, w), overflow, queries


def _path_pass(scene: SceneData, config: RenderConfig, si, row0,
               camera_flat, rows: int):
    """One pass through ``utils/graphs.run``: on the card a replay of the
    pass graph of (scene, config, rows, n_si), captured on its first use,
    the counterpart of the reference's jitted ``_render_path_pass``
    (static: config, rows; traced: si, row0, the camera); the eager body
    on the CPU. (SUM image, overflow, queries) on the scene's device."""
    def body(si, row0, camera):
        return _path_pass_body(scene, config,
                               PerspectiveCamera.from_flat(camera), si, row0,
                               rows)

    return graphs.run(
        ("path", config, rows, si.shape[0]), scene, scene.device, body,
        {"si": si, "row0": row0, "camera": camera_flat},
        label=f"path pass {config.width}x{rows}, {si.shape[0]} samples")


def _int32_on(x, dev):
    """``x`` as an int32 tensor on ``dev``; a Python or numpy int becomes a
    fill on the device, not a copy that waits for it."""
    if isinstance(x, (int, np.integer)):
        return torch.full((), int(x), dtype=torch.int32, device=dev)
    return torch.as_tensor(x, dtype=torch.int32, device=dev)


def _render_path_pass(scene: SceneData, config: RenderConfig,
                      camera: PerspectiveCamera, si_chunk, row0=0,
                      rows: int = 0):
    """Pixel rows [row0, row0+rows) x the sample indices ``si_chunk``.
    Returns (SUM image [rows, W, 3] on the device, overflow, queries): one
    replay of the pass graph on the card, the eager body on the CPU
    (``_path_pass``)."""
    dev = scene.device
    return _path_pass(scene, config, _int32_on(si_chunk, dev),
                      _int32_on(row0, dev), camera.to(dev).flat(),
                      rows or config.height)


def _render_path_frame(scene: SceneData, config: RenderConfig,
                       camera: PerspectiveCamera, si_mat, row0s,
                       rows: int = 0):
    """A launch grid, the reference's one dispatch per frame: one pass per
    (sample chunk, row band) launch. si_mat [L, k] sample indices per
    launch, row0s [L] first rows (best given as device tensors). On the
    card each launch is one replay of the pass graph, its image copied out
    of the graph's output buffer before the next replay; overflow and
    queries are summed on the device and nothing is read back. Returns
    (imgs [L, rows, W, 3], overflow, queries) on the device, each image
    bit-identical to that launch's ``_render_path_pass``."""
    dev = scene.device
    rows = rows or config.height
    si_mat = _int32_on(si_mat, dev)
    row0s = _int32_on(row0s, dev)
    cam = camera.to(dev).flat()
    imgs = []
    overflow = 0
    queries = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(si_mat.shape[0]):
        img, ovf, q = _path_pass(scene, config, si_mat[k], row0s[k], cam,
                                 rows)
        imgs.append(img)
        overflow = overflow + ovf
        queries = queries + q
    return torch.stack(imgs), overflow, queries


def _dispatch_grid(scene: SceneData, config: RenderConfig,
                   camera: PerspectiveCamera, si_mat, row0s, rows: int,
                   out_rows: int, group=None):
    """A launch grid through ``_render_path_frame`` in the reference's
    bounded groups: at most ~64 MB of launch images and ~2^30 worst-case
    counted queries per group (every lane alive every bounce, one trace
    and two NEE-side queries per light sample), one host read per group,
    totals in Python ints. Returns (imgs np [L, out_rows, W, 3], overflow,
    queries)."""
    n_launch = si_mat.shape[0]
    launch_bytes = max(1, out_rows * config.width * 3 * 4)
    q_est = max(1, config.max_rays_per_pass * config.max_depth
                * (1 + 2 * config.light_samples * config.light_samples))
    g = group or int(max(1, min(n_launch, (64 << 20) // launch_bytes,
                                (1 << 30) // q_est)))
    imgs = []
    overflow = queries = 0
    for i0 in range(0, n_launch, g):
        im, ovf, q = _render_path_frame(scene, config, camera,
                                        si_mat[i0:i0 + g],
                                        row0s[i0:i0 + g], rows)
        imgs.append(im.cpu().numpy())
        overflow += int(ovf)
        queries += int(q)
    return (np.concatenate(imgs, axis=0) if len(imgs) > 1 else imgs[0],
            overflow, queries)


def render_path_with_stats(scene: SceneData, config: RenderConfig,
                           camera: PerspectiveCamera):
    """Path-traced render (box-filtered mean of pixel_samples^2 samples).
    Returns (image np [H, W, 3], overflow int, queries int). Launches hold at
    most config.max_rays_per_pass lanes: chunks of sample indices first,
    then pixel-row bands of one height when one sample exceeds the budget
    (the last band shifted up, its overlap traced, counted and cropped on
    the host), as the reference does. Full chunks and bands go through
    ``_dispatch_grid``, the ragged tail chunk runs as one pass; each
    launch's image is added on the host in the reference's order."""
    dev = scene.device
    camera = camera.to(dev)
    spp_total = config.pixel_samples * config.pixel_samples
    w, h = config.width, config.height
    i32 = dict(dtype=torch.int32, device=dev)
    acc = np.zeros((h, w, 3), np.float32)
    overflow = queries = 0
    if w * h <= config.max_rays_per_pass:
        chunk = max(1, min(spp_total, config.max_rays_per_pass // (w * h)))
        n_full = spp_total // chunk
        if n_full:
            imgs, ovf, q = _dispatch_grid(
                scene, config, camera,
                torch.arange(n_full * chunk, **i32).reshape(n_full, chunk),
                torch.zeros((n_full,), **i32), 0, h)
            for img in imgs:
                acc += img
            overflow += ovf
            queries += q
        if n_full * chunk < spp_total:  # the ragged tail chunk, one launch
            img, ovf, q = _render_path_pass(
                scene, config, camera,
                torch.arange(n_full * chunk, spp_total, **i32))
            acc += img.cpu().numpy()
            overflow += int(ovf)
            queries += int(q)
    else:
        band = max(1, config.max_rays_per_pass // w)
        n_bands = -(-h // band)
        # uniform band height; the last band is shifted up and cropped
        r0s = [min(b * band, h - band) for b in range(n_bands)]
        si_mat = torch.arange(spp_total, **i32).repeat_interleave(
            n_bands)[:, None]  # sample-major, as the reference's grid
        row0s = torch.clamp_max(torch.arange(n_bands, **i32) * band,
                                h - band).repeat(spp_total)
        imgs, overflow, queries = _dispatch_grid(
            scene, config, camera, si_mat, row0s, band, band)
        for s0 in range(spp_total):
            for b, r0 in enumerate(r0s):
                skip = max(0, b * band - r0)
                acc[r0 + skip:r0 + band] += imgs[s0 * n_bands + b][skip:]
    return acc / np.float32(spp_total), overflow, queries


def warn_overflow(overflow: int) -> None:
    """The reference's warning when the 'xla' route truncated."""
    if overflow:
        print(f"[rayito_tpu_torch] WARNING: cluster-traversal candidate "
              f"overflow x{overflow} — K1/K2 budgets exceeded; nearest hits "
              "may have been dropped (see render/mesh_intersect.py)",
              file=sys.stderr)


def render_path(scene: SceneData, config: RenderConfig,
                camera: PerspectiveCamera):
    """render_path_with_stats, image only; warns on a positive overflow."""
    img, overflow, _ = render_path_with_stats(scene, config, camera)
    warn_overflow(overflow)
    return img
