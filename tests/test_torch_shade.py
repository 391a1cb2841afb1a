"""Port parity: the bounce's shading (render/shade.py) against the JAX
package on the CPU.

``bounce_prepare_plain`` and ``bounce_resolve_plain`` run on seeded lanes
(every material kind of the scene, hits and misses, dead lanes, positions
inside a sphere light, lane times in [-0.5, 1.5]) of six scenes: stage 6
on the n=8 stand-in (a rect and a sphere light), ``stage7_scene1`` (a
keyed rect and a four-key sphere light; Lambert, glossy, mirror and
emitter materials), the box mesh light (the BRDF-side closest-hit branch),
the sixteen-light scene, the last two at light_samples=2, and the two
scenes past the card's old light limits: 65 sphere lights, and a sphere
light nested nine groups deep (a keyed chain of nine links). Each output
is held, field by field, against the reference's own functions fed the
same lanes: ``evaluate_sa`` / ``sample_sa`` (ops/brdf.py),
``sample_chosen_light_rolled`` (``sample_light`` per light for the mesh
light), ``light_hit_analytic_rolled``, ``light_intersect_pdf_rolled``
(render/lights.py) and ``power_heuristic`` (ops/mis.py). Integers and
masks must be equal; floats agree to rtol = atol = 1e-5 (the two
compilers round a transcendental or a fused multiply-add apart), with
tests/test_torch_ops.py's two exceptions: the glossy lobe's pdf through
pow(n.h, e) at rtol 5e-5, and values through ``torch.cos`` above 3.5 rad
at atol 2e-4.

The refactored ``pathtrace_wave`` is held bit for bit against the frames
of the code before it was split into the two halves (pinned SHA-256 of
the image, overflow, queries) at 16x16, depth 3, on the first four scenes.
The wrappers run the plain versions on CPU tensors and raise on mixed
devices; their kernels are held against the plain versions on the card in
tests/test_torch_cuda.py.
"""

import dataclasses
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayito_tpu as rt
import rayito_tpu.models.demo as jdemo
from rayito_tpu.ops import brdf as jb
from rayito_tpu.ops import mis as jm
from rayito_tpu.ops.vec3 import V3 as JV3
from rayito_tpu.render import lights as jlights
from rayito_tpu.render import trace as jtrace
import rayito_tpu_torch as tt
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
from rayito_tpu_torch.models.scene import LIGHT_MESH, LIGHT_SPHERE
from rayito_tpu_torch.ops.vec3 import V3 as TV3
from rayito_tpu_torch.render import pathtracer as tpath
from rayito_tpu_torch.render import shade
from rayito_tpu_torch.render.trace import Hit
from rayito_tpu_torch.utils import cuda_lib
from rayito_tpu_torch.utils.config import RenderConfig as TConfig

JAX_COMPILE = dict(traversal="pallas", traverse_mt="bw_closest",
                   tiny_fold=False)
N = 256
TMIN = 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)
GLOSSY = dict(rtol=5e-5, atol=1e-5)
TRIG = dict(rtol=1e-5, atol=2e-4)
SCENES = ("stage6", "stage7", "box_light", "lights16")
# the field-by-field scenes: SCENES and the two past the card's old limits
PARITY = SCENES + ("lights65", "deep9")
LIGHT_SAMPLES = {"stage6": 1, "stage7": 1, "box_light": 2, "lights16": 2,
                 "lights65": 1, "deep9": 1}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions' many small ops spin threads on a loaded CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def standin8(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("obj") / "bumpy8.obj")
    tdemo.write_bumpy_standin(path, n=8)
    return path


def _box_light(pkg, demo):
    """A plane, the inline box and a second inline box, scaled and lifted,
    wrapped as a light (tests/test_torch_lights.py's box_light)."""
    b = pkg.Scene()
    b.add(pkg.Plane((0.0, -1.5, 0.0), (0.0, 1.0, 0.0),
                    pkg.DiffuseMaterial((0.7, 0.7, 0.8))))
    b.add(demo.inline_box_mesh(pkg.DiffuseMaterial((0.8, 0.3, 0.1))))
    lm = demo.inline_box_mesh(pkg.DiffuseMaterial((0.9, 0.9, 0.9)))
    lm.vertices = (np.asarray(lm.vertices, np.float32) * np.float32(0.5)
                   + np.float32([0.0, 3.0, 0.0]))
    b.add(pkg.ShapeLight(lm, color=(1.0, 1.0, 1.0), power=8.0))
    return b


def _scenes(name, path):
    """(reference Scene, port Scene)."""
    if name == "stage6":
        return jdemo.stage6_scene(path), tdemo.stage6_scene(path)
    if name == "stage7":
        return jdemo.stage7_scene1(path), tdemo.stage7_scene1(path)
    if name == "box_light":
        return _box_light(rt, jdemo), _box_light(tt, tdemo)
    build = {"lights16": tdemo.sixteen_lights_scene,
             "lights65": tdemo.many_sphere_lights_scene,
             "deep9": tdemo.deep_light_scene}[name]
    return build(pkg=rt), build(pkg=tt)


@pytest.fixture(scope="module")
def compiled(standin8):
    cache = {}

    def get(name):
        if name not in cache:
            js, ts = _scenes(name, standin8)
            cache[name] = (js.compile(**JAX_COMPILE), ts.compile("cpu"))
        return cache[name]
    return get


# ---------------------------------------------------------------------------
# seeded lanes
# ---------------------------------------------------------------------------


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _lanes(tsd, nls, seed):
    """Seeded bounce inputs as numpy: a hit (every material of the scene,
    misses with mat -1), positions in the scene's box, an eighth of them
    inside a static sphere light, lane times in [-0.5, 1.5]."""
    rs = np.random.default_rng(seed)
    f32 = np.float32
    n_mat = tsd.mat_kind.shape[0]
    pos = np.stack([rs.uniform(-4, 4, N), rs.uniform(-2, 3, N),
                    rs.uniform(-4, 4, N)], 1).astype(f32)
    spheres = [idx for kind, idx, xf in zip(
        tsd.light_kinds_host, tsd.light_indices_host,
        (tsd.sph_xf_host[i] if k == LIGHT_SPHERE else 0
         for k, i in zip(tsd.light_kinds_host, tsd.light_indices_host)))
        if kind == LIGHT_SPHERE and not (tsd.has_motion and xf)]
    if spheres:
        centers = tsd.sph_center.numpy()
        radii = tsd.sph_radius.numpy()
        for i in range(0, N, 8):
            s = spheres[rs.integers(len(spheres))]
            pos[i] = centers[s] + 0.5 * radii[s] * _unit(rs, 1)[0]
    d = _unit(rs, N)
    t = rs.uniform(0.5, 6.0, N).astype(f32)
    valid = rs.uniform(size=N) < 0.9
    return dict(
        t=np.where(valid, t, np.inf).astype(f32), valid=valid,
        mat=np.where(valid, rs.integers(0, n_mat, N), -1).astype(np.int32),
        normal=_unit(rs, N), color_mod=np.where(
            rs.uniform(size=N) < 0.2, f32(0.2), f32(1.0)).astype(f32),
        u=rs.uniform(0.0, 1.0, (6 * nls + 2, N)).astype(f32),
        throughput=rs.uniform(0.1, 1.0, (N, 3)).astype(f32),
        alive=rs.uniform(size=N) < 0.85,
        num_dirac=rs.integers(0, 3, N).astype(np.int32),
        o=(pos - d * t[:, None]).astype(f32), d=d,
        time=rs.uniform(-0.5, 1.5, N).astype(f32),
        result=rs.uniform(0.0, 0.5, (N, 3)).astype(f32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tv3(a):
    return TV3(*(_t(a[:, k]) for k in range(3)))


def _jv3(a):
    return JV3(*(jnp.asarray(np.ascontiguousarray(a[:, k]))
                 for k in range(3)))


def _np3(v):
    """A V3 (torch or JAX) of [..., N] as numpy [..., N, 3]."""
    return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], -1)


def _prepare(tsd, cfg, lanes, bounce=1):
    hit = Hit(t=_t(lanes["t"]), valid=_t(lanes["valid"]),
              shape_id=torch.full((N,), -1, dtype=torch.int32),
              mat=_t(lanes["mat"]), normal=_tv3(lanes["normal"]),
              color_mod=_t(lanes["color_mod"]))
    args = (tsd, cfg, bounce, hit, _t(lanes["u"]),
            _tv3(lanes["throughput"]), _t(lanes["alive"]),
            _t(lanes["num_dirac"]), _tv3(lanes["o"]), _tv3(lanes["d"]),
            _t(lanes["time"]), _tv3(lanes["result"]))
    return args, shade.bounce_prepare_plain(*args)


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _light_sample_ref(jsd, tsd, light_idx, jpos, jtime, u):
    """The reference's sample of each lane's chosen light: (position, pdf)
    as numpy."""
    lsu, lsv, leu = (jnp.asarray(x) for x in u)
    if LIGHT_MESH not in tsd.light_kinds_host:
        lp, _, lpdf = jlights.sample_chosen_light_rolled(
            jsd, jnp.asarray(light_idx), jpos, jtime, lsu, lsv, TMIN)
        return _np3(lp), np.asarray(lpdf)
    normal = _jv3(np.tile(np.float32([0, 1, 0]), (N, 1)))
    lp = np.zeros((N, 3), np.float32)
    lpdf = np.zeros(N, np.float32)
    for li in range(tsd.n_lights):
        p, _, pdf = jlights.sample_light(jsd, li, jpos, normal, jtime, lsu,
                                         lsv, leu, TMIN)
        sel = light_idx == li
        lp[sel] = _np3(p)[sel]
        lpdf[sel] = np.asarray(pdf)[sel]
    return lp, lpdf


@pytest.mark.parametrize("scene", PARITY)
def test_prepare_against_reference(compiled, scene):
    """bounce_prepare_plain field by field against the reference's
    functions on the same lanes."""
    jsd, tsd = compiled(scene)
    nls = LIGHT_SAMPLES[scene] ** 2
    cfg = TConfig(light_samples=LIGHT_SAMPLES[scene])
    lanes = _lanes(tsd, nls, seed=3 + PARITY.index(scene))
    _, prep = _prepare(tsd, cfg, lanes)
    analytic = shade.analytic_lights(tsd)
    assert prep.light_idx.shape == (nls, N) and (prep.t_l is None) != analytic

    # the material row, the emission gate, the Dirac count
    mat = jnp.asarray(lanes["mat"])
    kind = np.asarray(jsd.mat_kind)[np.maximum(lanes["mat"], 0)]
    param = np.asarray(jsd.mat_param)[np.maximum(lanes["mat"], 0)]
    color = np.asarray(jsd.mat_color)[np.maximum(lanes["mat"], 0)]
    exponent = np.where(kind == jb.KIND_GLOSSY,
                        np.float32(1.0) / np.maximum(param * param,
                                                     np.float32(1e-12)),
                        np.float32(1.0)).astype(np.float32)
    lane = lanes["alive"] & lanes["valid"]
    gate = lane & (lanes["num_dirac"] == 1)
    emit = _np3(jtrace.material_emittance(jsd, mat))
    _close(_np3(prep.result), lanes["result"] + np.where(
        gate[:, None], lanes["throughput"] * emit, 0.0), "result")
    lane = lane & (kind != jb.KIND_EMITTER)
    dirac = lane & (kind == jb.KIND_REFLECTION)
    assert np.array_equal(prep.lane.numpy(), lane)
    assert np.array_equal(prep.num_dirac.numpy(), lanes["num_dirac"] + dirac)
    # every material kind of the scene reaches a hit
    assert set(kind[lanes["valid"]]) == set(np.asarray(jsd.mat_kind))
    pos = lanes["o"] + lanes["d"] * lanes["t"][:, None]
    _close(_np3(prep.position), pos, "position")
    _close(_np3(prep.cmod_color), color * lanes["color_mod"][:, None], "cmod")

    jkind, jexp = jnp.asarray(kind), jnp.asarray(exponent)
    jn, jout = _jv3(lanes["normal"]), _jv3(-lanes["d"])
    jpos, jtime = _jv3(_np3(prep.position)), jnp.asarray(lanes["time"])
    nee = lane & ~dirac
    u = lanes["u"]
    for lsi in range(nls):
        liu = u[6 * lsi]
        li = np.minimum((liu * np.float32(tsd.n_lights)).astype(np.int32),
                        tsd.n_lights - 1)
        assert np.array_equal(prep.light_idx[lsi].numpy(), li)
        lp, lpdf = _light_sample_ref(jsd, tsd, li, jpos, jtime,
                                     u[6 * lsi + 1:6 * lsi + 4])
        _close(prep.lpdf[lsi], lpdf, f"lpdf {lsi}", GLOSSY)
        to_l = _np3(prep.position) - lp
        dist = np.sqrt(np.maximum((to_l * to_l).sum(1), 1e-37))
        with np.errstate(invalid="ignore"):  # misses: inf positions
            _close(_np3(prep.wl[lsi]), -to_l / dist[:, None], f"wl {lsi}",
                   TRIG)
        # the BRDF toward the light, fed the port's direction
        f_l, pdf_l = jb.evaluate_sa(jkind, jexp, -_jv3(_np3(prep.wl[lsi])),
                                    jout, jn)
        _close(prep.f_l[lsi], f_l, f"f_l {lsi}", GLOSSY)
        _close(prep.pdf_l[lsi], pdf_l, f"pdf_l {lsi}", GLOSSY)
        ok_l = (nee & (prep.lpdf[lsi].numpy() > 0) & (np.asarray(f_l) > 0)
                & (np.asarray(pdf_l) > 0))
        assert np.array_equal(prep.ok_l[lsi].numpy(), ok_l), lsi
        assert 0 < ok_l.sum() < N
        _close(prep.tmax_l[lsi], np.where(ok_l, dist - np.float32(TMIN), 0),
               f"tmax_l {lsi}", TRIG)
        # the BRDF-sampled direction toward the same light
        b_in, f_b, pdf_b = jb.sample_sa(jkind, jexp, jout, jn,
                                        jnp.asarray(u[6 * lsi + 4]),
                                        jnp.asarray(u[6 * lsi + 5]))
        _close(_np3(prep.wb[lsi]), -_np3(b_in), f"wb {lsi}", TRIG)
        _close(prep.f_b[lsi], f_b, f"f_b {lsi}", GLOSSY)
        _close(prep.pdf_b[lsi], pdf_b, f"pdf_b {lsi}", GLOSSY)
        ok_b = nee & (np.asarray(pdf_b) > 0) & (np.asarray(f_b) > 0)
        if analytic:
            t_l, n_l, l_hit = jlights.light_hit_analytic_rolled(
                jsd, jnp.asarray(li), jpos, _jv3(_np3(prep.wb[lsi])), jtime,
                TMIN)
            l_hit = np.asarray(l_hit)
            ok_b = ok_b & l_hit
            fin = np.isfinite(np.asarray(t_l))
            assert np.array_equal(np.isfinite(prep.t_l[lsi].numpy()), fin)
            _close(prep.t_l[lsi].numpy()[fin], np.asarray(t_l)[fin],
                   f"t_l {lsi}")
            _close(_np3(prep.n_l[lsi])[l_hit], _np3(n_l)[l_hit],
                   f"n_l {lsi}")
            tmax_b = np.where(ok_b, np.where(l_hit, np.asarray(t_l), 0)
                              - np.float32(TMIN), 0)
        else:
            tmax_b = np.where(ok_b, np.float32(1e30), np.float32(TMIN))
        assert np.array_equal(prep.ok_b[lsi].numpy(), ok_b), lsi
        _close(prep.tmax_b[lsi], tmax_b, f"tmax_b {lsi}")
    # the continuation
    inc, f_c, pdf_c = jb.sample_sa(jkind, jexp, jout, jn, jnp.asarray(u[-2]),
                                   jnp.asarray(u[-1]))
    _close(_np3(prep.wc), -_np3(inc), "wc", TRIG)
    _close(prep.f_c, f_c, "f_c", GLOSSY)
    _close(prep.pdf_c, pdf_c, "pdf_c", GLOSSY)


def _query_bits(tsd, prep, nls, seed):
    """Seeded shadow bits per light sample (rows of [nls, N]), and with a
    mesh light a BRDF-side hit that is the chosen light's shape on about
    half the lanes."""
    rs = np.random.default_rng(seed)
    occluded = _t(rs.uniform(size=(nls, N)) < 0.3)
    if shade.analytic_lights(tsd):
        return occluded, _t(rs.uniform(size=(nls, N)) < 0.3), None
    sid = tsd.light_shape_id[prep.light_idx.long()].numpy()
    hits = []
    for lsi in range(nls):
        valid = _t(rs.uniform(size=N) < 0.9)
        hits.append(Hit(
            t=_t(rs.uniform(0.5, 4.0, N).astype(np.float32)), valid=valid,
            shape_id=_t(np.where(rs.uniform(size=N) < 0.5, sid[lsi],
                                 sid[lsi] + 1).astype(np.int32)),
            mat=torch.zeros(N, dtype=torch.int32),
            normal=_tv3(_unit(rs, N)), color_mod=torch.ones(N)))
    return occluded, None, hits


@pytest.mark.parametrize("scene", PARITY)
def test_resolve_against_reference(compiled, scene):
    """bounce_resolve_plain against the reference's light_intersect_pdf,
    power heuristic and the bounce body's sums, on the prepared lanes."""
    jsd, tsd = compiled(scene)
    nls = LIGHT_SAMPLES[scene] ** 2
    cfg = TConfig(light_samples=LIGHT_SAMPLES[scene])
    lanes = _lanes(tsd, nls, seed=11 + PARITY.index(scene))
    args, prep = _prepare(tsd, cfg, lanes)
    occluded, blocked, hits = _query_bits(tsd, prep, nls, seed=5)
    normal, tp = args[3].normal, args[5]
    result, tp_out, o, d, alive = shade.bounce_resolve_plain(
        tsd, cfg, prep, normal, tp, args[8], args[9], args[10], occluded,
        blocked, hits)

    n_np = lanes["normal"]
    jtime = jnp.asarray(lanes["time"])
    jpos = _jv3(_np3(prep.position))
    cmod = _np3(prep.cmod_color)
    acc = np.zeros((N, 3), np.float32)
    lcolor = np.asarray(jsd.light_color) * np.asarray(jsd.light_power)[:, None]
    sid = np.asarray(jsd.light_shape_id)
    for lsi in range(nls):
        li = prep.light_idx[lsi].numpy()
        ec = lcolor[li] * cmod
        wl, wb = _np3(prep.wl[lsi]), _np3(prep.wb[lsi])
        lpdf, pdf_b = prep.lpdf[lsi].numpy(), prep.pdf_b[lsi].numpy()
        ok_l = prep.ok_l[lsi].numpy() & ~occluded[lsi].numpy()
        w_l = np.asarray(jm.power_heuristic(1.0, jnp.asarray(lpdf), 1.0,
                                            jnp.asarray(prep.pdf_l[lsi])))
        gain_l = np.where(ok_l, prep.f_l[lsi].numpy() * np.abs(
            (wl * n_np).sum(1)) * w_l / np.maximum(lpdf, 1e-37), 0.0)
        if hits is None:
            hit_light = prep.ok_b[lsi].numpy() & ~blocked[lsi].numpy()
            t_l, n_l = prep.t_l[lsi].numpy(), _np3(prep.n_l[lsi])
        else:
            sh = hits[lsi]
            hit_light = (prep.ok_b[lsi].numpy() & sh.valid.numpy()
                         & (sh.shape_id.numpy() == sid[li]))
            t_l, n_l = sh.t.numpy(), _np3(sh.normal)
        lpdf_b = np.asarray(jlights.light_intersect_pdf_rolled(
            jsd, jnp.asarray(li), jpos, _jv3(wb), jnp.asarray(t_l),
            _jv3(n_l), jtime))
        ok_b = hit_light & (lpdf_b > 0)
        w_b = np.asarray(jm.power_heuristic(1.0, jnp.asarray(pdf_b), 1.0,
                                            jnp.asarray(lpdf_b)))
        gain_b = np.where(ok_b, prep.f_b[lsi].numpy() * np.abs(
            (wb * n_np).sum(1)) * w_b / np.maximum(pdf_b, 1e-37), 0.0)
        acc = acc + ec * gain_l[:, None] + ec * gain_b[:, None]
        assert ok_l.any() and (ok_b.any() or not hit_light.any())
    want = _np3(prep.result) + lanes["throughput"] * acc * np.float32(
        tsd.n_lights / nls)
    _close(_np3(result), want, "result", GLOSSY)
    cont = prep.lane.numpy() & (prep.pdf_c.numpy() > 0)
    wc = _np3(prep.wc)
    gain_c = np.where(cont, prep.f_c.numpy() * np.abs((wc * n_np).sum(1))
                      / np.maximum(prep.pdf_c.numpy(), 1e-37), 1.0)
    _close(_np3(tp_out), np.where(cont[:, None], lanes["throughput"] * cmod
                                  * gain_c[:, None], lanes["throughput"]),
           "throughput", GLOSSY)
    assert np.array_equal(alive.numpy(), cont)
    assert np.array_equal(_np3(o), np.where(cont[:, None],
                                            _np3(prep.position), lanes["o"]))
    assert np.array_equal(_np3(d), np.where(cont[:, None], wc, lanes["d"]))


# ---------------------------------------------------------------------------
# the refactored pathtrace_wave, bit for bit
# ---------------------------------------------------------------------------

# 16x16, 1 spp, depth 3, seed 1 frames of pathtrace_wave as it stood before
# the bounce body was split into bounce_prepare / bounce_resolve: SHA-256
# of the float32 image, overflow, queries
LIGHT_CAM = (40.0, (0, 3, 10), (0, 0, 0), (0, 1, 0))
PINNED = {
    "stage6": ("92931c0f3e9cceec81b2449a4311bb2be3733a46dd7ec28ae71d687cf0a88792",
               0, 831),
    "stage7": ("31c93cb933b159037613fd040df536ed4e3ae7194337fa29415416427bc8cc32",
               0, 827),
    "box_light": ("e24c921305f857b52937c0f3bb9c122442c9ccf12abf84acc5b08df97f0bbcf4",
                  0, 1985),
    "lights16": ("5fcf103410d4c06edc22b939696ea0a0f6930364b577f1a400126e4e0fd84c30",
                 0, 1373),
}


def _camera(scene):
    if scene == "stage6":
        return TCam.make(30.0, *tdemo.STAGE6_CAMERA, focal_distance=16.0,
                         lens_radius=0.0)
    if scene == "stage7":
        return TCam.make(30.0, *tdemo.STAGE7_CAMERA, focal_distance=16.0,
                         lens_radius=0.0, shutter_open=0.0,
                         shutter_close=1.0)
    return TCam.make(*LIGHT_CAM)


@pytest.mark.parametrize("scene", SCENES)
def test_frame_is_the_one_before(compiled, scene):
    tsd = compiled(scene)[1]
    cfg = TConfig(width=16, height=16, pixel_samples=1,
                  light_samples=LIGHT_SAMPLES[scene], max_depth=3, seed=1)
    img, ovf, q = tpath.render_path_with_stats(tsd, cfg, _camera(scene))
    digest = hashlib.sha256(
        np.ascontiguousarray(img, np.float32).tobytes()).hexdigest()
    assert (digest, int(ovf), int(q)) == PINNED[scene]


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _bits(x):
    """A tensor or V3 as one integer tensor of its bits (NaN included)."""
    if isinstance(x, TV3):
        x = torch.stack([x.x, x.y, x.z])
    return x.view(torch.int32) if x.is_floating_point() else x


def test_wrappers_run_plain_on_cpu(compiled):
    """On CPU tensors each wrapper is its plain version, launching
    nothing."""
    _, tsd = compiled("box_light")
    cfg = TConfig(light_samples=2)
    lanes = _lanes(tsd, 4, seed=21)
    args, want = _prepare(tsd, cfg, lanes)
    counts = shade.bounce_prepare.launches, shade.bounce_resolve.launches
    got = shade.bounce_prepare(*args)
    for f in dataclasses.fields(shade.Prepared):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None and b is None) or torch.equal(_bits(a),
                                                        _bits(b)), f.name
    occluded, blocked, hits = _query_bits(tsd, want, 4, seed=2)
    rest = (tsd, cfg, want, args[3].normal, args[5], args[8], args[9],
            args[10], occluded, blocked, hits)
    for a, b in zip(shade.bounce_resolve(*rest),
                    shade.bounce_resolve_plain(*rest)):
        assert torch.equal(_bits(a), _bits(b))
    assert (shade.bounce_prepare.launches,
            shade.bounce_resolve.launches) == counts
    assert shade.bounce_prepare in cuda_lib.KERNELS
    assert shade.bounce_resolve in cuda_lib.KERNELS


def test_wrappers_refuse_mixed_devices(compiled):
    _, tsd = compiled("stage6")
    cfg = TConfig()
    lanes = _lanes(tsd, 1, seed=22)
    args, prep = _prepare(tsd, cfg, lanes)
    hit = args[3]
    meta = Hit(t=hit.t.to("meta"), valid=hit.valid, shape_id=hit.shape_id,
               mat=hit.mat, normal=hit.normal, color_mod=hit.color_mod)
    with pytest.raises(ValueError, match="bounce_prepare"):
        shade.bounce_prepare(tsd, cfg, 1, meta, *args[4:])
    occluded, blocked, _ = _query_bits(tsd, prep, 1, seed=3)
    with pytest.raises(ValueError, match="bounce_resolve"):
        shade.bounce_resolve(tsd, cfg, prep, args[3].normal, args[5],
                             args[8], args[9], args[10],
                             occluded.to("meta"), blocked)
