"""The bounce's shading around its shadow queries (counterpart of the
bounce body of ``rayito_tpu/render/pathtracer.py`` ``pathtrace_wave``,
:150-305 before the NEE queries and :338-396 after them).

A bounce of the path tracer is: the closest-hit query, the bounce's draw
set, :func:`bounce_prepare`, each light sample's shadow queries, then
:func:`bounce_resolve`. On a CUDA tensor each of the two is one launch of
``csrc/shade.cu``; on the CPU each runs its plain version,
:func:`bounce_prepare_plain` / :func:`bounce_resolve_plain`, the reference's
bounce body as PyTorch ops, op by op in its order. Mixed devices raise.

``bounce_prepare`` takes the bounce's ``Hit``, the draw set ``u`` ([rows,
N]: six rows per light sample, then the continuation's two), the path
state and the lanes' times, and returns a :class:`Prepared`: the material
row's emission added into ``result``, the lanes still alive after an
emitter, the Dirac count, and per light sample (``[nls, N]`` planes) the
chosen light, its sample's pdf, the BRDF's f and pdf toward it, the shadow
ray and its tmax, the BRDF-sampled direction toward the same light with
its f, pdf and query tmax (with analytic lights the light's own hit, t_l
and n_l, already folded into ``ok_b`` and its tmax), and the
continuation's BRDF sample. ``bounce_resolve`` takes that and the shadow
queries' results as they come, one per light sample (``occluded`` and,
with analytic lights, ``blocked``; with a mesh light the BRDF-side
query's full ``Hit`` instead), and returns the new (result, throughput,
o, d, alive).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch

from ..accel.clusters import TRI_PER_CLUSTER
from ..models.scene import LIGHT_MESH, LIGHT_RECT, LIGHT_SPHERE, SceneData
from ..ops.brdf import (
    KIND_EMITTER,
    KIND_GLOSSY,
    KIND_REFLECTION,
    evaluate_sa,
    sample_sa,
)
from ..ops import transform as xfm
from ..ops.mis import power_heuristic
from ..ops.vec3 import RAY_TMAX, V3, dot, sqrt_ieee, where as vwhere
from ..utils import cuda_lib
from ..utils.config import RenderConfig
from . import lights as L
from .trace import material_emittance, material_row


@dataclasses.dataclass(frozen=True)
class Prepared:
    """:func:`bounce_prepare`'s outputs: ``[N]`` per lane, ``[nls, N]`` per
    light sample (``nls`` rows, 0 without lights). The directions are those
    the queries and the continuation use: ``wl`` toward the sampled light
    point (the reference's ``-light_incoming``), ``wb`` the BRDF-sampled
    one (``-b_in``), ``wc`` the continuation's (``-incoming``)."""

    result: V3
    lane: Any  # bool: alive, hit, not an emitter
    num_dirac: Any  # i32
    position: V3
    cmod_color: V3
    wc: V3
    f_c: Any
    pdf_c: Any
    light_idx: Any  # i32 [nls, N]
    lpdf: Any
    f_l: Any
    pdf_l: Any
    ok_l: Any  # bool: the light-side shadow query runs
    wl: V3
    tmax_l: Any
    wb: V3
    f_b: Any
    pdf_b: Any
    ok_b: Any  # bool: the BRDF-side query runs
    tmax_b: Any
    t_l: Any = None  # analytic lights: the chosen light's own hit
    n_l: Optional[V3] = None
    # the kernel's output buffers, whose views the fields above are
    # (bounce_resolve reads them in place); None from the plain version
    buffers: Optional[dict] = dataclasses.field(default=None, repr=False,
                                                compare=False)


def light_samples(scene: SceneData, config: RenderConfig) -> int:
    """Light samples per bounce: light_samples^2, 0 without lights."""
    return config.light_samples ** 2 if scene.n_lights else 0


def analytic_lights(scene: SceneData) -> bool:
    """True when every light is a rect or a sphere: the BRDF-side query is
    the light's own analytic hit and an any-hit query; a mesh light turns
    it into a closest-hit query for every light."""
    return all(k in (LIGHT_RECT, LIGHT_SPHERE) for k in scene.light_kinds_host)


def _mat_lookup(scene: SceneData, mat_ids):
    kind, color, param = material_row(scene, mat_ids)
    # glossy exponent = 1/roughness^2
    exponent = torch.where(
        kind == KIND_GLOSSY, 1.0 / torch.clamp_min(param * param, 1e-12), 1.0
    )
    return kind, color, exponent


def _stacked(xs):
    """[len(xs), ...] of tensors of one shape: a view for one."""
    return xs[0][None] if len(xs) == 1 else torch.stack(xs)


def _rows(xs, n: int, dtype, dev):
    """[len(xs), N]: one row per light sample."""
    if not xs:
        return torch.empty((0, n), dtype=dtype, device=dev)
    return _stacked(xs)


def _rows3(vs, n: int, dev) -> V3:
    f32 = torch.float32
    return V3(_rows([v.x for v in vs], n, f32, dev),
              _rows([v.y for v in vs], n, f32, dev),
              _rows([v.z for v in vs], n, f32, dev))


def bounce_prepare_plain(scene: SceneData, config: RenderConfig, bounce: int,
                         hit, u, throughput: V3, alive, num_dirac, o: V3,
                         d: V3, time, result: V3) -> Prepared:
    """Everything of bounce ``bounce`` before its shadow queries, as
    PyTorch ops (see the module docstring)."""
    n_lights = scene.n_lights
    nls = light_samples(scene, config)
    analytic = analytic_lights(scene)
    tmin = config.ray_tmin
    n, dev = hit.t.shape[0], hit.t.device
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
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

    per = {k: [] for k in ("light_idx", "lpdf", "f_l", "pdf_l", "ok_l", "wl",
                           "tmax_l", "wb", "f_b", "pdf_b", "ok_b", "tmax_b",
                           "t_l", "n_l")}
    nee_lane = lane & ~is_dirac
    for lsi in range(nls):
        liu, lsu, lsv, leu, bsu, bsv = u[6 * lsi:6 * lsi + 6]
        light_idx = torch.clamp_max(
            (liu * n_lights).to(torch.int32), n_lights - 1
        )

        # each lane's chosen light only
        lp, _, lpdf = L.sample_chosen_light_rolled(
            scene, light_idx, position, time, lsu, lsv, leu, tmin)

        # light-sampled direction
        light_incoming = position - lp
        dist = sqrt_ieee(torch.clamp_min(
            dot(light_incoming, light_incoming), 1e-37))
        light_incoming = light_incoming / dist
        f_l, brdf_pdf_l = evaluate_sa(kind, exponent, light_incoming,
                                      outgoing, normal)
        ok_l = (nee_lane & (lpdf > 0.0) & (f_l > 0.0)
                & (brdf_pdf_l > 0.0))
        tmax_l = torch.where(ok_l, dist - tmin, 0.0)

        # BRDF-sampled direction toward the same light
        b_in, f_b, pdf_b = sample_sa(kind, exponent, outgoing, normal, bsu,
                                     bsv)
        ok_b = nee_lane & (pdf_b > 0.0) & (f_b > 0.0)
        if analytic:
            # "full intersect, hit shape == the chosen light" is: the light
            # is hit analytically and nothing is nearer, so one analytic
            # hit + one any-hit query replace it
            t_l, n_l, l_hit = L.light_hit_analytic_rolled(
                scene, light_idx, position, -b_in, time, tmin)
            ok_b = ok_b & l_hit
            tmax_b = torch.where(ok_b, torch.where(l_hit, t_l, 0.0) - tmin,
                                 0.0)
            per["t_l"].append(t_l)
            per["n_l"].append(n_l)
        else:
            # a mesh light has no analytic hit: the full closest hit, for
            # every light of the scene (dead lanes carry tmax = tmin)
            tmax_b = torch.where(ok_b, RAY_TMAX, tmin)
        for k, v in (("light_idx", light_idx), ("lpdf", lpdf), ("f_l", f_l),
                     ("pdf_l", brdf_pdf_l), ("ok_l", ok_l),
                     ("wl", -light_incoming), ("tmax_l", tmax_l),
                     ("wb", -b_in), ("f_b", f_b), ("pdf_b", pdf_b),
                     ("ok_b", ok_b), ("tmax_b", tmax_b)):
            per[k].append(v)

    # BRDF sample for the path continuation
    incoming, f_c, pdf_c = sample_sa(kind, exponent, outgoing, normal,
                                     u[-2], u[-1])
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    rows = {k: _rows3(v, n, dev) if k in ("wl", "wb", "n_l")
            else _rows(v, n, i32 if k == "light_idx" else
                       b8 if k.startswith("ok") else f32, dev)
            for k, v in per.items()}
    if not analytic:
        rows["t_l"] = rows["n_l"] = None
    return Prepared(result=result, lane=lane, num_dirac=num_dirac,
                    position=position, cmod_color=cmod_color, wc=-incoming,
                    f_c=f_c, pdf_c=pdf_c, **rows)


def bounce_resolve_plain(scene: SceneData, config: RenderConfig,
                         prep: Prepared, normal: V3, throughput: V3, o: V3,
                         d: V3, time, occluded=(), blocked=None, hits=None):
    """Everything of a bounce after its shadow queries, as PyTorch ops:
    both MIS weights and gains of each light sample, the light-sampled
    radiance added into the result, and the continuation. Per light
    sample: ``occluded`` (bool [N]) the light-side query's; with analytic
    lights ``blocked`` (bool [N]) the BRDF-side any-hit query's, with a
    mesh light ``hits`` (a ``Hit``) the BRDF-side closest hit. Returns
    (result, throughput, o, d, alive)."""
    n_lights = scene.n_lights
    nls = prep.light_idx.shape[0]
    result = prep.result
    cmod_color = prep.cmod_color
    if nls:
        zeros = torch.zeros_like(prep.f_c)
        acc = V3(zeros, zeros, zeros)
        for lsi in range(nls):
            light_idx = prep.light_idx[lsi]
            emitted = L.light_emitted_rolled(scene, light_idx)
            ok_b = prep.ok_b[lsi]
            if hits is None:
                hit_light = ok_b & ~blocked[lsi]
                t_l, n_l = prep.t_l[lsi], prep.n_l[lsi]
            else:
                sh = hits[lsi]
                chosen_sid = scene.light_shape_id[light_idx.long()]
                hit_light = ok_b & sh.valid & (sh.shape_id == chosen_sid)
                t_l, n_l = sh.t, sh.normal

            lpdf = prep.lpdf[lsi]
            ok_l = prep.ok_l[lsi] & ~occluded[lsi]
            w_l = power_heuristic(1.0, lpdf, 1.0, prep.pdf_l[lsi])
            gain_l = torch.where(
                ok_l,
                prep.f_l[lsi] * torch.abs(dot(prep.wl[lsi], normal)) * w_l
                / torch.clamp_min(lpdf, 1e-37),
                0.0,
            )
            acc = acc + emitted * cmod_color * gain_l
            wb = prep.wb[lsi]
            lpdf_b = L.light_intersect_pdf_rolled(
                scene, light_idx, prep.position, wb, t_l, n_l, time)
            ok_b = hit_light & (lpdf_b > 0.0)
            pdf_b = prep.pdf_b[lsi]
            w_b = power_heuristic(1.0, pdf_b, 1.0, lpdf_b)
            gain_b = torch.where(
                ok_b,
                prep.f_b[lsi] * torch.abs(dot(wb, normal)) * w_b
                / torch.clamp_min(pdf_b, 1e-37),
                0.0,
            )
            acc = acc + emitted * cmod_color * gain_b
        result = result + throughput * acc * float(
            np.float32(n_lights) / np.float32(nls)
        )

    # the path continuation
    cont = prep.lane & (prep.pdf_c > 0.0)
    gain_c = torch.where(
        cont,
        prep.f_c * torch.abs(dot(prep.wc, normal))
        / torch.clamp_min(prep.pdf_c, 1e-37),
        1.0,
    )
    throughput = vwhere(cont, throughput * cmod_color * gain_c, throughput)
    return (result, throughput, vwhere(cont, prep.position, o),
            vwhere(cont, prep.wc, d), cont)


# ---------------------------------------------------------------------------
# The kernels (csrc/shade.cu)
# ---------------------------------------------------------------------------

# row order of the prepared planes: per lane [F_LANE, N], per light sample
# [F_LS, nls, N] (csrc/shade.cu FLane, FLs)
F_LANE = (("result", 3), ("position", 3), ("cmod_color", 3), ("wc", 3),
          ("f_c", 1), ("pdf_c", 1))
F_LS = (("lpdf", 1), ("f_l", 1), ("pdf_l", 1), ("wl", 3), ("tmax_l", 1),
        ("wb", 3), ("f_b", 1), ("pdf_b", 1), ("tmax_b", 1), ("t_l", 1),
        ("n_l", 3))
# a launch's pointer slots, in csrc/shade.cu's enum Ptr order; the scene's
# tables first, the light table and its chain slots among them
# (SceneData.light_table, light_slots)
_PTRS = (
    "mat_kind", "mat_color", "mat_param", "light_color", "light_power",
    "light_shape_id", "light_table", "light_slots", "rect_corner",
    "rect_side1", "rect_side2", "sph_center", "sph_radius", "tri_area_cdf",
    "tri_vert_rows", "mesh_total_area", "xf_times", "xf_translate",
    "xf_scale", "xf_rotate", "xf_nkeys",
    "hit_t", "hit_valid", "hit_mat", "nx", "ny", "nz", "cmod", "u", "tpx",
    "tpy", "tpz", "alive", "num_dirac", "ox", "oy", "oz", "dx", "dy", "dz",
    "time", "rx", "ry", "rz",
    "f_lane", "f_ls", "i_lane", "i_ls", "b_lane", "b_ls",
    "occluded", "blocked", "sh_valid", "sh_shape_id", "sh_t", "sh_n",
    "r_f", "r_b",
)
_TABLES = _PTRS[:21]


# a light's record in SceneData.light_table (csrc/shade.cu ShadeLight)
LIGHT_FIELDS = ("kind", "idx", "depth", "chain0", "tri0", "own", "n_padded")


def light_records(scene: SceneData):
    """The scene's lights as csrc/shade.cu reads them, built once with the
    scene (``SceneData.light_table``, ``light_slots``): (records i32
    [L, 7], one ``LIGHT_FIELDS`` row a light, and slots i32 [S], every
    light's transform chain, outermost first, ``depth`` slots from
    ``chain0``; depth 0 where the light does not move). A mesh light's record holds
    the run of the area CDF that ``render/lights.py`` searches: its first
    triangle, the run's length (its triangles padded to whole clusters, cut
    at the table's end) and its padded cluster count in triangles."""
    xf_of = {LIGHT_RECT: scene.rect_xf_host, LIGHT_SPHERE: scene.sph_xf_host,
             LIGHT_MESH: scene.mesh_xf_host}
    cdf_len = scene.tri_area_cdf.shape[0]
    records, slots = [], []
    for kind, idx in zip(scene.light_kinds_host, scene.light_indices_host):
        if kind not in xf_of:
            raise NotImplementedError(f"unknown light kind {kind}")
        chain = xfm.chain_slots(scene, xf_of[kind][idx])
        tri0 = own = n_padded = 0
        if kind == LIGHT_MESH:
            tri0, count = scene.mesh_tri_ranges[idx]
            own = min(max(1, -(-count // TRI_PER_CLUSTER)) * TRI_PER_CLUSTER,
                      cdf_len - tri0)
            n_padded = scene.mesh_cl_ranges[idx][1] * TRI_PER_CLUSTER
        records.append((kind, idx, len(chain), len(slots), tri0, own,
                        n_padded))
        slots += chain
    return (np.asarray(records, np.int32).reshape(-1, len(LIGHT_FIELDS)),
            np.asarray(slots, np.int32))


class _ShadeSpec(ctypes.Structure):
    """A launch's constants, passed to the kernel by value (the lights are
    the scene's device table)."""
    _fields_ = [("n_lights", ctypes.c_int32), ("nls", ctypes.c_int32),
                ("k", ctypes.c_int32), ("bounce", ctypes.c_int32),
                ("analytic", ctypes.c_int32), ("motion", ctypes.c_int32),
                ("tmin", ctypes.c_float), ("light_scale", ctypes.c_float)]


def _spec(scene: SceneData, config: RenderConfig, bounce: int) -> _ShadeSpec:
    n_lights = scene.n_lights
    nls = light_samples(scene, config)
    return _ShadeSpec(
        n_lights=n_lights, nls=nls, k=int(scene.xf_times.shape[1]),
        bounce=bounce, analytic=int(analytic_lights(scene)),
        motion=int(scene.has_motion), tmin=float(config.ray_tmin),
        light_scale=float(np.float32(n_lights) / np.float32(nls)) if nls
        else 0.0)


@functools.lru_cache(maxsize=None)
def _check_layout() -> None:
    """The spec's ctypes layout and the pointer count are the kernel's
    (once per process)."""
    lib = cuda_lib.library()
    if lib.rt_shade_spec_bytes() != ctypes.sizeof(_ShadeSpec):
        raise RuntimeError("shade: ShadeSpec differs between shade.cu and "
                           "render/shade.py")
    if lib.rt_shade_ptrs() != len(_PTRS):
        raise RuntimeError("shade: the pointer slots differ between "
                           "shade.cu and render/shade.py")


def _launch(fn, spec, ptrs: dict, n: int, resolve: int) -> None:
    name = fn.__name__
    _check_layout()
    tensors = [t for t in ptrs.values() if t is not None]
    lib, stream = cuda_lib.launch_args(name, *tensors)
    arr = (ctypes.c_void_p * len(_PTRS))(
        *(None if ptrs.get(k) is None else ptrs[k].data_ptr() for k in _PTRS))
    if n:
        cuda_lib.check(lib.rt_shade(ctypes.byref(spec), arr, resolve, n,
                                    stream), name)
        cuda_lib.count_launch(fn, tensors[0].device)


def _table_ptrs(scene: SceneData) -> dict:
    return {k: getattr(scene, k) for k in _TABLES}


def _lanes(name, tensors: dict, n: int, dtypes: dict) -> dict:
    """The lane inputs contiguous, each checked for its shape and type."""
    out = {}
    for k, t in tensors.items():
        if t is None:
            out[k] = None
            continue
        want = dtypes.get(k, torch.float32)
        if t.dtype != want or t.shape[-1:] != (n,):
            raise ValueError(f"{name}: {k} must be {want} [..., {n}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        out[k] = t.contiguous()
    return out


def _planes(buf, layout) -> dict:
    """Views of a [rows, *lead] buffer by the row layout (V3 for three
    rows)."""
    out, r = {}, 0
    for k, w in layout:
        out[k] = buf[r] if w == 1 else V3(buf[r], buf[r + 1], buf[r + 2])
        r += w
    return out


@cuda_lib.counted
def bounce_prepare(scene: SceneData, config: RenderConfig, bounce: int, hit,
                   u, throughput: V3, alive, num_dirac, o: V3, d: V3, time,
                   result: V3) -> Prepared:
    """Kernel wrapper of :func:`bounce_prepare_plain` (same contract): one
    launch of ``csrc/shade.cu``'s bounce_prepare_kernel on CUDA tensors."""
    name = "bounce_prepare"
    n = hit.t.shape[0]
    nls = light_samples(scene, config)
    lanes = {"hit_t": hit.t, "hit_valid": hit.valid, "hit_mat": hit.mat,
             "nx": hit.normal.x, "ny": hit.normal.y, "nz": hit.normal.z,
             "cmod": hit.color_mod, "u": u, "tpx": throughput.x,
             "tpy": throughput.y, "tpz": throughput.z, "alive": alive,
             "num_dirac": num_dirac, "ox": o.x, "oy": o.y, "oz": o.z,
             "dx": d.x, "dy": d.y, "dz": d.z,
             "time": time if scene.has_motion else None,
             "rx": result.x, "ry": result.y, "rz": result.z}
    if cuda_lib.on_cpu(name, *(t for t in lanes.values() if t is not None),
                       scene.mat_kind):
        return bounce_prepare_plain(scene, config, bounce, hit, u,
                                    throughput, alive, num_dirac, o, d, time,
                                    result)
    if u.shape != (6 * nls + 2, n):
        raise ValueError(f"{name}: the draw set must be [{6 * nls + 2}, "
                         f"{n}], got {tuple(u.shape)}")
    lanes = _lanes(name, {k: v.expand(n) if k not in ("u",) and v is not None
                          and v.dim() == 0 else v for k, v in lanes.items()},
                   n, {"hit_valid": torch.bool, "hit_mat": torch.int32,
                       "alive": torch.bool, "num_dirac": torch.int32})
    spec = _spec(scene, config, bounce)
    dev = hit.t.device
    f_lane = torch.empty((sum(w for _, w in F_LANE), n), dtype=torch.float32,
                         device=dev)
    f_ls = torch.empty((sum(w for _, w in F_LS), nls, n),
                       dtype=torch.float32, device=dev)
    i_lane = torch.empty((n,), dtype=torch.int32, device=dev)
    i_ls = torch.empty((nls, n), dtype=torch.int32, device=dev)
    b_lane = torch.empty((n,), dtype=torch.bool, device=dev)
    b_ls = torch.empty((2, nls, n), dtype=torch.bool, device=dev)
    bufs = {"f_lane": f_lane, "f_ls": f_ls, "i_lane": i_lane, "i_ls": i_ls,
            "b_lane": b_lane, "b_ls": b_ls}
    _launch(_WRAPPERS["prepare"], spec,
            {**_table_ptrs(scene), **lanes, **bufs}, n, 0)
    ls = _planes(f_ls, F_LS)
    if not spec.analytic:
        ls["t_l"] = ls["n_l"] = None
    return Prepared(**_planes(f_lane, F_LANE), **ls, lane=b_lane,
                    num_dirac=i_lane, light_idx=i_ls, ok_l=b_ls[0],
                    ok_b=b_ls[1], buffers=bufs)


@cuda_lib.counted
def bounce_resolve(scene: SceneData, config: RenderConfig, prep: Prepared,
                   normal: V3, throughput: V3, o: V3, d: V3, time,
                   occluded=(), blocked=None, hits=None):
    """Kernel wrapper of :func:`bounce_resolve_plain` (same contract): one
    launch of ``csrc/shade.cu``'s bounce_resolve_kernel on CUDA tensors.
    ``prep`` must come from :func:`bounce_prepare` (its planes are read in
    place)."""
    name = "bounce_resolve"
    n = prep.f_c.shape[0]
    nls = prep.light_idx.shape[0]
    analytic = analytic_lights(scene)
    if nls and (len(occluded) != nls or (blocked is None) == (hits is None)
                or (hits is None) != analytic):
        raise ValueError(f"{name}: occluded and, with analytic lights, "
                         "blocked, with a mesh light hits, expected per "
                         "light sample")
    queries = [*occluded, *(() if blocked is None else blocked),
               *(t for h in (() if hits is None else hits)
                 for t in (h.valid, h.shape_id, h.t, h.normal.x, h.normal.y,
                           h.normal.z))]
    lanes = {"nx": normal.x, "ny": normal.y, "nz": normal.z,
             "tpx": throughput.x, "tpy": throughput.y, "tpz": throughput.z,
             "ox": o.x, "oy": o.y, "oz": o.z, "dx": d.x, "dy": d.y,
             "dz": d.z, "time": time if scene.has_motion else None}
    if cuda_lib.on_cpu(name, prep.f_c, *queries,
                       *(t for t in lanes.values() if t is not None),
                       scene.mat_kind):
        return bounce_resolve_plain(scene, config, prep, normal, throughput,
                                    o, d, time, occluded, blocked, hits)
    if prep.buffers is None:
        raise ValueError(f"{name}: prep must come from bounce_prepare on "
                         "the card")
    if nls:  # one [nls, N] plane per field
        lanes["occluded"] = _stacked(list(occluded))
        if hits is None:
            lanes["blocked"] = _stacked(list(blocked))
        else:
            for k, f in (("sh_valid", "valid"), ("sh_shape_id", "shape_id"),
                         ("sh_t", "t")):
                lanes[k] = _stacked([getattr(h, f) for h in hits])
            lanes["sh_n"] = torch.stack([
                _stacked([getattr(h.normal, c) for h in hits])
                for c in "xyz"])
    lanes = _lanes(name, {k: v.expand(n) if v is not None and v.dim() == 0
                          else v for k, v in lanes.items()}, n,
                   {"occluded": torch.bool, "blocked": torch.bool,
                    "sh_valid": torch.bool, "sh_shape_id": torch.int32})
    for k, v in lanes.items():
        if k in ("occluded", "blocked", "sh_valid", "sh_shape_id", "sh_t",
                 "sh_n") and v.shape[-2:] != (nls, n):
            raise ValueError(f"{name}: the queries' {k} must be [N] per "
                             "light sample")
    dev = prep.f_c.device
    r_f = torch.empty((12, n), dtype=torch.float32, device=dev)
    r_b = torch.empty((n,), dtype=torch.bool, device=dev)
    _launch(_WRAPPERS["resolve"], _spec(scene, config, 0),
            {**_table_ptrs(scene), **lanes, **prep.buffers, "r_f": r_f,
             "r_b": r_b}, n, 1)
    return (V3(r_f[0], r_f[1], r_f[2]), V3(r_f[3], r_f[4], r_f[5]),
            V3(r_f[6], r_f[7], r_f[8]), V3(r_f[9], r_f[10], r_f[11]), r_b)


# the wrappers as registered (their launches are counted on these, also
# where a caller has put something else under their module names)
_WRAPPERS = {"prepare": bounce_prepare, "resolve": bounce_resolve}
