"""Port parity: the ``traversal='xla'`` route (the two-level cluster
pipeline with its K1/K2 truncation and ``overflow`` count) on the CPU.

The reference is compiled with ``traversal="xla"`` (no Pallas
interpreter); inputs come from numpy seeds. Scenes: stage 6 and stage 7 on
the n=8 bumpy stand-in, ``stage7_scene2``, two scenes of
``tests/test_rolled_scale.py`` (40 moving spheres; eight rect lights and a
triangle mesh light), a stack of 420 thin parallel layers whose rays cross
it end-on (18 superclusters: the truncation drops candidates at both
levels), and the stand-in as a mesh light under a keyed rotation.

  * the route's tables (``cl_min``, ``cl_max``, ``sc_min``, ``sc_max``,
    ``sc_rows``, ``tri_rows``, ``mesh_cl_ranges``, ``mesh_sc_ranges``)
    equal the reference's bit for bit;
  * ``mesh_intersect_clusters``, closest and any hit, on 1,000 seeded rays
    (not a multiple of the reference's block of 256, so its pad slots
    count lane 0 again), axis-parallel directions among them: prim equal
    in every lane but exact-t ties (under 0.1%); t, beta and gamma within
    4 ulps or 1e-6 relative; overflow equal;
  * ``scene_intersect`` / ``scene_occluded`` on 512 seeded rays at seeded
    times: the same hits, shapes, materials, occlusion and overflow; t to
    1e-5 relative, normals to 1e-5 (the reference's XLA contracts
    multiply-adds into FMAs, PyTorch does not; the moving spheres take
    tests/test_torch_rolled.py's 2e-4 and 6e-3);
  * 32x32 renders within 0.5% relative RMSE of the reference's, overflow
    equal, queries equal (stage 7: within 0.1%, its knife edge in ROADMAP
    Queue 3);
  * RAYITO_TRAVERSAL resolves at compile; the CLI's stats line; the
    overflow warnings of render_path, render_progressive and the sharded
    render; the sharded overflow equals the unsharded one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayito_tpu as rt
import rayito_tpu.models.obj as jobj
from rayito_tpu.models import demo as jdemo
from rayito_tpu.models.camera import PerspectiveCamera as JCam
from rayito_tpu.ops.vec3 import V3 as JV3
from rayito_tpu.render import mesh_intersect as jmi
from rayito_tpu.render import pathtracer as jpath
from rayito_tpu.render import trace as jtrace
from rayito_tpu.utils.config import RenderConfig as JConfig
import rayito_tpu_torch as tt
from rayito_tpu_torch import cli as tcli
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.models import obj as tobj
from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
from rayito_tpu_torch.models.scene import resolve_traversal
from rayito_tpu_torch.ops.vec3 import V3 as TV3
from rayito_tpu_torch.parallel import sharding as tshard
from rayito_tpu_torch.render import mesh_intersect as tmi
from rayito_tpu_torch.render import pathtracer as tpath
from rayito_tpu_torch.render import progressive as tprog
from rayito_tpu_torch.render import trace as ttrace
from rayito_tpu_torch.utils.config import RenderConfig as TConfig
from rayito_tpu_torch.utils.image import read_pfm

TABLES = ("cl_min", "cl_max", "sc_min", "sc_max", "sc_rows", "tri_rows")
N_MI = 1000  # rays per mesh_intersect_clusters case: R = 256, 24 pad slots
N_RAYS = 512
WARNING = "WARNING: cluster-traversal candidate overflow"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The route's many small ops spin threads on a loaded CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def standin8(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("obj") / "bumpy8.obj")
    tdemo.write_bumpy_standin(path, n=8)
    return path


def _layers(pkg, n_layers=420, g=4, dz=0.05, light=False):
    """n_layers square layers of g x g quads, stacked along z with seeded
    jitter: 13,440 triangles, 280 clusters, 18 superclusters; with
    ``light`` a floor, a rect light and a sphere beside them."""
    rs = np.random.default_rng(5)
    verts, idx = [], []
    for k in range(n_layers):
        z = k * dz + rs.uniform(-0.001, 0.001)
        base = len(verts)
        verts += [(i / g * 2 - 1, j / g * 2 - 1, z) for j in range(g + 1)
                  for i in range(g + 1)]
        for j in range(g):
            for i in range(g):
                a = base + j * (g + 1) + i
                idx += [(a, a + 1, a + g + 2), (a, a + g + 2, a + g + 1)]
    s = pkg.Scene()
    s.add(pkg.TriangleMesh(np.asarray(verts, np.float32),
                           np.asarray(idx, np.int32),
                           pkg.DiffuseMaterial((0.6, 0.5, 0.4))))
    if light:
        s.add(pkg.Plane((0.0, -1.5, 0.0), (0.0, 1.0, 0.0),
                        pkg.DiffuseMaterial((0.7, 0.7, 0.9))))
        s.add(pkg.Sphere((2.0, 0.0, 10.0), 0.8,
                         pkg.DiffuseMaterial((0.8, 0.3, 0.7))))
        s.add(pkg.RectangleLight((-2.0, 4.0, 0.0), (4.0, 0.0, 0.0),
                                 (0.0, 0.0, 4.0), (1.0, 1.0, 1.0), 6.0))
    return s


def _mesh_light_xf(pkg, objmod, path):
    """Stage 6's floor and box with the 768-triangle stand-in as a mesh
    light under a two-key rotation (a traversal domain of its own on the
    kernel route)."""
    s = pkg.Scene()
    s.add(pkg.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                    pkg.DiffuseMaterial((0.7, 0.7, 0.9)), bullseye=True))
    s.add(pkg.Sphere((-3.0, 0.0, -2.0), 2.0,
                     pkg.GlossyMaterial((0.3, 0.9, 0.3), 0.1)))
    s.add(pkg.RectangleLight((-1.5, 4.0, -1.5), (3.0, 0.0, 0.0),
                             (0.0, 0.0, 3.0), (1.0, 1.0, 1.0), 5.0))
    mesh = objmod.load_obj(path, pkg.DiffuseMaterial((0.8, 0.1, 0.1)))
    mesh.transform.set_rotation(0.0, (1.0, 0.0, 0.0, 0.0))
    mesh.transform.set_rotation(
        1.0, (np.cos(np.pi / 8), 0.0, np.sin(np.pi / 8), 0.0))
    s.add(pkg.ShapeLight(mesh, color=(1.0, 1.0, 0.3), power=10.0))
    return s


def _spheres40(pkg):
    """test_rolled_scale.py's moving-sphere scene at 40 spheres."""
    rs = np.random.default_rng(5)
    s = pkg.Scene()
    s.add(pkg.Plane((0, -2, 0), (0, 1, 0), pkg.DiffuseMaterial((0.7,) * 3)))
    mats = [pkg.DiffuseMaterial((0.8, 0.3, 0.2)),
            pkg.GlossyMaterial((0.2, 0.6, 0.8), 0.25)]
    for i in range(40):
        sph = pkg.Sphere(tuple(rs.uniform(-6, 6, 3)),
                         float(rs.uniform(0.2, 0.5)), mats[i % 2])
        if i % 3 == 0:
            sph.transform.set_translation(0.0, tuple(rs.uniform(-.5, .5, 3)))
            sph.transform.set_translation(1.0, tuple(rs.uniform(-.5, .5, 3)))
        s.add(sph)
    s.add(pkg.RectangleLight((-3, 9, -3), (6, 0, 0), (0, 0, 6),
                             (1.0, 1.0, 1.0), 3.0))
    return s


def _mixed_lights(pkg):
    """test_rolled_scale.py's eight rect lights and one triangle mesh
    light."""
    rs = np.random.default_rng(11)
    s = pkg.Scene()
    s.add(pkg.Plane((0, -1, 0), (0, 1, 0), pkg.DiffuseMaterial((0.7,) * 3)))
    for _ in range(8):
        s.add(pkg.RectangleLight(
            tuple(rs.uniform(-6, 6, 3) + np.asarray([0, 6, 0])),
            (1.5, 0, 0), (0, 0, 1.5), tuple(rs.uniform(0.5, 1.0, 3)), 2.0))
    tri = np.array([[-1, 5, -1], [1, 5, -1], [0, 5, 1]], np.float32)
    s.add(pkg.ShapeLight(
        pkg.TriangleMesh(tri, np.array([[0, 1, 2]], np.int32),
                         pkg.DiffuseMaterial((1.0,) * 3)),
        (1.0, 0.9, 0.8), 4.0))
    return s


def _builders(name, path):
    if name == "stage6":
        return jdemo.stage6_scene(path), tdemo.stage6_scene(path)
    if name == "stage7":
        return jdemo.stage7_scene1(path), tdemo.stage7_scene1(path)
    if name == "stage7_scene2":
        return jdemo.stage7_scene2(), tdemo.stage7_scene2()
    if name == "layers":
        return _layers(rt), _layers(tt)
    if name == "mesh_light_xf":
        return (_mesh_light_xf(rt, jobj, path),
                _mesh_light_xf(tt, tobj, path))
    if name == "spheres40":
        return _spheres40(rt), _spheres40(tt)
    return _mixed_lights(rt), _mixed_lights(tt)


@pytest.fixture(scope="module")
def compiled(standin8):
    """name -> (reference SceneData, port arrays, static, SceneData), all
    under traversal='xla', compiled on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            jb, tb = _builders(name, standin8)
            arrays, static = tb.compile_arrays(traversal="xla")
            cache[name] = (jb.compile(traversal="xla"), arrays, static,
                           tb.compile("cpu", traversal="xla"))
        return cache[name]

    return get


def _both_v3(a):
    return (JV3(*(jnp.asarray(a[:, k]) for k in range(3))),
            TV3(*(torch.from_numpy(a[:, k].copy()) for k in range(3))))


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("scene", ["stage6", "stage7", "stage7_scene2"])
def test_xla_tables_bit_identical(compiled, scene):
    jsd, arrays, static, own = compiled(scene)
    for k in TABLES:
        ref = np.asarray(getattr(jsd, k))
        assert arrays[k].dtype == ref.dtype and arrays[k].shape == ref.shape
        np.testing.assert_array_equal(arrays[k], ref, err_msg=k)
        assert torch.equal(getattr(own, k), torch.from_numpy(ref.copy())), k
    for k in ("mesh_cl_ranges", "mesh_sc_ranges", "mesh_tri_ranges"):
        assert static[k] == getattr(jsd, k) == getattr(own, k), k
    assert own.traversal == static["traversal"] == "xla"


def _mi_rays(case):
    """(mesh index, o, d, tmax) of N_MI seeded rays. Layers: rays from
    below the stack crossing it end-on (lane 0 among them: it truncates),
    every 10th straight up the z axis, every 10th (from inside the stack)
    along +y; stage 6: rays around the camera toward the bumpy mesh, every
    10th along -z and every 10th along -y."""
    rs = np.random.default_rng(1 if case == "layers" else 2)
    n = N_MI
    if case == "layers":
        o = np.stack([rs.uniform(-0.9, 0.9, n), rs.uniform(-0.9, 0.9, n),
                      np.full(n, -3.0)], 1)
        d = rs.normal(0.0, 0.05, (n, 3))
        d[:, 2] = 1.0
        d[::10], d[5::10] = (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)
        o[5::10, 2] = 1.0
        mi = 0
    else:
        o = rs.uniform(-3.0, 3.0, (n, 3))
        o[:, 2] += 8.0
        d = rs.normal(0.0, 1.0, (n, 3)) * 0.08 - o / np.linalg.norm(
            o, axis=1, keepdims=True)
        d[::10], d[5::10] = (0.0, 0.0, -1.0), (0.0, -1.0, 0.0)
        mi = 1
    tmax = np.full(n, 1e30, np.float32)
    tmax[3::7] = rs.uniform(2.0, 9.0, len(tmax[3::7]))
    return mi, o.astype(np.float32), _unit(d), tmax


def _close(a, b):
    """|a - b| within 4 ulps of b or 1e-6 relative."""
    return np.abs(a - b) <= np.maximum(4 * np.spacing(np.abs(b)),
                                       1e-6 * np.abs(b))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["layers", "stage6"])
def test_mesh_intersect_clusters_matches_reference(compiled, case, any_hit):
    jsd, _, _, tsd = compiled(case)
    mi, o, d, tmax = _mi_rays(case)
    (jo, to), (jd, td) = _both_v3(o), _both_v3(d)
    ref = jmi.mesh_intersect_clusters(jsd, mi, jo, jd, 1e-4,
                                      jnp.asarray(tmax), any_hit=any_hit)
    got = tmi.mesh_intersect_clusters(tsd, mi, to, td, 1e-4,
                                      torch.from_numpy(tmax), any_hit=any_hit)
    assert int(got[4]) == int(ref[4])
    rp, gp = np.asarray(ref[1]), got[1].numpy()
    rt_, gt = np.asarray(ref[0]), got[0].numpy()
    hit = (rp >= 0) & (gp >= 0)
    tie = (rp != gp) & hit
    tie[tie] = _close(gt[tie], rt_[tie])
    assert ((rp != gp) & ~tie).sum() == 0
    assert tie.sum() <= 0.001 * N_MI
    assert N_MI // 4 < hit.sum() < N_MI
    assert _close(gt[hit], rt_[hit]).all()
    if any_hit:
        assert not got[2].any() and not got[3].any()
    else:
        same = hit & ~tie
        for k in (2, 3):
            assert _close(got[k].numpy()[same], np.asarray(ref[k])[same]).all()
    if case == "layers":
        # the truncation drops candidates, and the reference's pad slots
        # (1,000 lanes in blocks of 256) add lane 0's count 24 times: the
        # same rays as 1,024 lanes (24 dead ones appended) have no pad
        assert int(got[4]) > N_MI
        pad = lambda a, v: torch.cat([a, torch.full((24,), v)])
        flat = tmi.mesh_intersect_clusters(
            tsd, mi, TV3(*(pad(c, 0.0) for c in (to.x, to.y, to.z))),
            TV3(*(pad(c, 1.0) for c in (td.x, td.y, td.z))), 1e-4,
            pad(torch.from_numpy(tmax), 0.0), any_hit=any_hit)[4]
        lane0 = int(got[4]) - int(flat)
        assert lane0 > 0 and lane0 % 24 == 0


def _scene_rays(name, seed):
    """512 seeded rays toward the scene, at seeded times in [0, 1]."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-4.0, 4.0, (N_RAYS, 3))
    if name == "layers":
        o[:, :2] *= 0.3
        o[:, 2] = -4.0 + o[:, 2] * 0.1
        tgt = rs.uniform(-1.0, 1.0, (N_RAYS, 3)) + np.asarray([0, 0, 10])
    else:
        o[:, 1] += 4.0
        o[:, 2] += 10.0
        tgt = rs.normal(0.0, 1.5, (N_RAYS, 3))
        tgt[: N_RAYS // 2, 1] -= 1.5
    return (o.astype(np.float32), _unit(tgt - o),
            rs.uniform(0.0, 1.0, N_RAYS).astype(np.float32))


@pytest.mark.parametrize("scene", ["stage6", "stage7", "layers",
                                   "spheres40", "mixed_lights"])
def test_scene_queries_match_reference(compiled, scene):
    jsd, _, _, tsd = compiled(scene)
    o, d, time = _scene_rays(scene, 11)
    (jo, to), (jd, td) = _both_v3(o), _both_v3(d)
    ref = jtrace.scene_intersect(jsd, jo, jd, jnp.asarray(time), 1e-4,
                                 jnp.full((N_RAYS,), 1e30, jnp.float32))
    got = ttrace.scene_intersect(tsd, to, td, torch.from_numpy(time), 1e-4,
                                 torch.full((N_RAYS,), 1e30))
    valid = np.asarray(ref.valid)
    assert valid.sum() > N_RAYS // 4
    for k in ("valid", "shape_id", "mat"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    # the moving spheres: tests/test_torch_rolled.py's tolerances
    rtol, atol = (2e-4, 6e-3) if scene == "spheres40" else (1e-5, 1e-5)
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(ref.t)[valid],
                               rtol=rtol)
    for c in "xyz":
        np.testing.assert_allclose(
            getattr(got.normal, c).numpy()[valid],
            np.asarray(getattr(ref.normal, c))[valid], atol=atol)
    assert int(got.overflow) == int(ref.overflow)
    if scene == "layers":
        assert int(ref.overflow) > 0

    tmax = np.random.default_rng(12).uniform(1.0, 14.0, N_RAYS)
    tmax = tmax.astype(np.float32)
    r_occ, r_ovf = jtrace.scene_occluded(jsd, jo, jd, jnp.asarray(time),
                                         1e-4, jnp.asarray(tmax))
    g_occ, g_ovf = ttrace.scene_occluded(tsd, to, td, torch.from_numpy(time),
                                         1e-4, torch.from_numpy(tmax))
    np.testing.assert_array_equal(g_occ.numpy(), np.asarray(r_occ))
    assert int(g_ovf) == int(r_ovf)
    assert 0 < np.asarray(r_occ).sum() < N_RAYS


def _render_kw(name):
    return (dict(width=32, height=32, pixel_samples=1, light_samples=1,
                 max_depth=3, aspect_correction=True),
            dict(focal_distance=16.0, lens_radius=0.0, shutter_open=0.0,
                 shutter_close=0.0 if name == "stage6" else 1.0),
            jdemo.STAGE6_CAMERA if name != "stage7" else jdemo.STAGE7_CAMERA)


@pytest.mark.parametrize("scene", ["stage6", "stage7"])
def test_render_matches_reference(compiled, scene):
    jsd, _, _, tsd = compiled(scene)
    kw, cam, spec = _render_kw(scene)
    j_img, j_ovf, j_q = jpath.render_path_with_stats(
        jsd, JConfig(**kw), JCam.make(30.0, *spec, **cam))
    t_img, t_ovf, t_q = tpath.render_path_with_stats(
        tsd, TConfig(**kw), TCam.make(30.0, *spec, **cam))
    j_img = np.asarray(j_img, np.float32)
    err = float(np.sqrt(np.mean((t_img - j_img) ** 2))
                / np.sqrt(np.mean(j_img ** 2)))
    assert err <= 0.005, f"relative RMSE {err:.4%} > 0.5%"
    assert t_ovf == int(j_ovf) == 0
    if scene == "stage6":
        assert t_q == int(j_q)
    else:  # the FMA knife edge of five lanes, net one query of 3,371
        # (test_stage7_query_lanes_are_the_sphere_light_knife_edge)
        assert int(j_q) - t_q == 1
    assert np.isfinite(t_img).all() and t_img.min() >= 0.0


def test_stage7_query_lanes_are_the_sphere_light_knife_edge(compiled,
                                                          monkeypatch):
    """The 32x32 stage-7 render issues 3,370 queries in the port and 3,371
    in the reference: five lanes differ, +1 -1 +1 -1 +1 for the reference
    (lanes 21, 46, 85, 295, 455; pixels (21,0), (14,1), (21,2), (7,9),
    (7,14)), all from XLA's contraction of multiply-adds into FMAs, which
    PyTorch does not do. Held here on one depth-2 frame of each package
    (3,096 and 3,094 queries), their values read in the frame itself:

      * the sphere light's sample (radius 0.1, 80-640 units away) grazes
        its silhouette, and whether the sampled normal faces the shading
        point (else pdf 0 and no light-side query) follows the last bits.
        Its outcome differs on exactly lanes 21, 46, 85 at bounce 0 and
        455 at bounce 1. On the reference's own inputs of those lanes the
        port's sample equals the reference run op by op bit for bit (pdf
        0); the jitted reference gives pdf > 0 on lanes 21 and 85 (the
        FMA is in the sample), and 0 on lane 46, whose port-side pdf > 0
        comes from its own bounce-0 hit point, a few ulps away;
      * lanes 295 and 455 hit a sphere's grazing edge at bounce 0 (the
        discriminant cancels): the two packages' t are more than 1e-5
        apart. Lane 295's reference continuation re-enters that sphere
        past the 1e-4 epsilon where the port's leaves it; lane 455's
        bounce-1 hit point moves, and its sphere-light sample flips."""
    from rayito_tpu.render import lights as jlights
    from rayito_tpu_torch.render import lights as tlights

    jsd, _, _, tsd = compiled("stage7")
    kw, cam, spec = _render_kw("stage7")
    kw = dict(kw, max_depth=2)
    sphere_light = 1
    assert jsd.light_kinds_host[sphere_light] == 1  # a sphere light
    rec = {"j_light": [], "t_light": [], "j_hit": [], "t_hit": []}
    j_sample, t_sample = jlights.sample_light, tlights.sample_chosen_light_rolled
    j_hit, t_hit = jpath.scene_intersect, tpath.scene_intersect

    def keep(key, *values):  # one bounce's [1024] lanes per value
        rec[key].append([np.asarray(v).copy() for v in values])

    def j_sample_spy(scene, li, position, normal, time, lsu, lsv, leu,
                     tmin):
        out = j_sample(scene, li, position, normal, time, lsu, lsv, leu,
                       tmin)
        if li == sphere_light:
            jax.debug.callback(
                lambda *v: keep("j_light", *v), position.x, position.y,
                position.z, normal.x, normal.y, normal.z, time, lsu, lsv,
                leu, out[2])
        return out

    def t_sample_spy(scene, light_idx, position, time, lsu, lsv, leu,
                     tmin):
        out = t_sample(scene, light_idx, position, time, lsu, lsv, leu,
                       tmin)
        keep("t_light", position.x, position.y, position.z, light_idx,
             out[2])
        return out

    def j_hit_spy(scene, o, d, time, tmin, tmax):
        hit = j_hit(scene, o, d, time, tmin, tmax)
        jax.debug.callback(lambda *v: keep("j_hit", *v), hit.t,
                           hit.shape_id)
        return hit

    def t_hit_spy(scene, o, d, time, tmin, tmax):
        hit = t_hit(scene, o, d, time, tmin, tmax)
        keep("t_hit", hit.t, hit.shape_id)
        return hit

    monkeypatch.setattr(jlights, "sample_light", j_sample_spy)
    monkeypatch.setattr(tlights, "sample_chosen_light_rolled", t_sample_spy)
    monkeypatch.setattr(jpath, "scene_intersect", j_hit_spy)
    monkeypatch.setattr(tpath, "scene_intersect", t_hit_spy)
    _, _, j_q = jpath.render_path_with_stats(
        jsd, JConfig(**kw), JCam.make(30.0, *spec, **cam))
    jax.effects_barrier()
    _, _, t_q = tpath.render_path_with_stats(
        tsd, TConfig(**kw), TCam.make(30.0, *spec, **cam))
    assert (int(j_q), t_q) == (3096, 3094)
    assert [len(v) for v in rec.values()] == [2, 2, 2, 2]

    def on_sphere_light(b):
        j, t = rec["j_light"][b], rec["t_light"][b]
        return np.flatnonzero((t[3] == sphere_light)
                              & ((j[-1] > 0) != (t[4] > 0)))

    assert on_sphere_light(0).tolist() == [21, 46, 85]
    assert on_sphere_light(1).tolist() == [455]
    assert (rec["j_light"][0][-1][[21, 46, 85]] > 0).tolist() == [
        True, False, True]
    assert rec["j_light"][1][-1][455] > 0.0

    def sample(b, lanes, how):
        """The sphere light's sample of ``lanes`` on the reference's inputs
        of bounce b: jitted, op by op, or the port's."""
        v = [np.asarray(x)[lanes] for x in rec["j_light"][b][:10]]
        if how == "port":
            c = [torch.from_numpy(x.copy()) for x in v]
            p, _, pdf = t_sample(tsd, torch.full((len(lanes),), sphere_light,
                                                 dtype=torch.int32),
                                 TV3(*c[:3]), c[6], c[7], c[8], c[9], 1e-4)
            return [getattr(p, k).numpy() for k in "xyz"], pdf.numpy()

        def f(*a):
            a = [jnp.asarray(x) for x in a]
            return j_sample(jsd, sphere_light, JV3(*a[:3]), JV3(*a[3:6]),
                            a[6], a[7], a[8], a[9], 1e-4)

        if how == "jit":
            p, _, pdf = jax.jit(f)(*v)
        else:
            with jax.disable_jit():
                p, _, pdf = f(*v)
        return [np.asarray(getattr(p, k)) for k in "xyz"], np.asarray(pdf)

    for b, lanes in ((0, [21, 46, 85]), (1, [455])):
        (pp, ppdf), (op, opdf) = sample(b, lanes, "port"), sample(b, lanes,
                                                                 "op")
        for got, want in zip(pp + [ppdf], op + [opdf]):
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
        np.testing.assert_array_equal(opdf, 0.0)
    assert (sample(0, [21, 46, 85], "jit")[1] > 0).tolist() == [
        True, False, True]
    # lane 46: the port's own hit point, a few ulps off, samples pdf > 0
    j0, t0 = rec["j_light"][0], rec["t_light"][0]
    assert any(np.float32(j0[k][46]).view(np.int32)
               != np.float32(t0[k][46]).view(np.int32) for k in range(3))
    assert t0[4][46] > 0.0
    # lanes 295 and 455: grazing bounce-0 hits on the same sphere
    (jt, js), (tt_, ts) = rec["j_hit"][0], rec["t_hit"][0]
    for lane in (295, 455):
        assert js[lane] == ts[lane] and abs(jt[lane] - tt_[lane]) > 1e-5
    (jt1, js1), (tt1, ts1) = rec["j_hit"][1], rec["t_hit"][1]
    assert js1[295] == js[295] and 1e-4 < jt1[295] < 2e-4
    assert ts1[295] != ts[295]


def test_mesh_light_above_192_triangles_under_a_keyed_transform(compiled):
    """The stand-in (768 triangles) as a mesh light under a keyed rotation:
    its own traversal domain on the kernel route, the pipeline in its
    local space under 'xla'. Both routes' 32x32 renders are held to the
    reference's 'xla' render (0.5% relative RMSE, no overflow)."""
    jsd, _, _, tsd = compiled("mesh_light_xf")
    assert len(tsd.ktab_xf) == 1 and tsd.ktab_xf[0] != 0
    kw = dict(width=32, height=32, pixel_samples=1, light_samples=1,
              max_depth=3, aspect_correction=True)
    cam = dict(focal_distance=16.0, lens_radius=0.0, shutter_open=0.0,
               shutter_close=1.0)
    j_img, j_ovf, j_q = jpath.render_path_with_stats(
        jsd, JConfig(**kw), JCam.make(30.0, *jdemo.STAGE6_CAMERA, **cam))
    j_img = np.asarray(j_img, np.float32)
    assert int(j_ovf) == 0 and j_img.max() > 0.0
    for traversal in ("xla", "pallas"):
        sd = dataclasses.replace(tsd, traversal=traversal)
        t_img, t_ovf, t_q = tpath.render_path_with_stats(
            sd, TConfig(**kw), TCam.make(30.0, *tdemo.STAGE6_CAMERA, **cam))
        err = float(np.sqrt(np.mean((t_img - j_img) ** 2))
                    / np.sqrt(np.mean(j_img ** 2)))
        assert err <= 0.005, (traversal, err)
        assert t_ovf == 0 and abs(t_q - int(j_q)) <= 0.001 * int(j_q)


def test_traversal_resolves_at_compile(monkeypatch, standin8):
    monkeypatch.delenv("RAYITO_TRAVERSAL", raising=False)
    assert resolve_traversal() == "pallas"
    for env, want in (("auto", "pallas"), ("pallas", "pallas"),
                      ("XLA", "xla"), ("xla", "xla")):
        monkeypatch.setenv("RAYITO_TRAVERSAL", env)
        assert resolve_traversal() == want
    sd = tdemo.stage6_scene(standin8).compile("cpu")
    assert sd.traversal == "xla"
    monkeypatch.setenv("RAYITO_TRAVERSAL", "cuda")
    with pytest.raises(ValueError, match="RAYITO_TRAVERSAL"):
        tdemo.stage6_scene(standin8).compile("cpu")
    assert sd.traversal == "xla"  # read once, at compile
    assert tdemo.stage6_scene(standin8).compile(
        "cpu", traversal="pallas").traversal == "pallas"
    monkeypatch.delenv("RAYITO_TRAVERSAL")
    pallas = tdemo.stage6_scene(standin8).compile("cpu")
    switched = dataclasses.replace(pallas, traversal="xla")
    o, d, _ = _scene_rays("stage6", 3)
    _, to = _both_v3(o)
    _, td = _both_v3(d)
    a = ttrace.scene_intersect(switched, to, td, None, 1e-4, 1e30)
    b = ttrace.scene_intersect(sd, to, td, None, 1e-4, 1e30)
    assert torch.equal(a.t, b.t) and torch.equal(a.shape_id, b.shape_id)
    assert isinstance(a.overflow, torch.Tensor)
    assert ttrace.scene_intersect(pallas, to, td, None, 1e-4,
                                  1e30).overflow == 0


def test_cli_under_rayito_traversal_xla(monkeypatch, capsys, standin8,
                                        tmp_path):
    """RAYITO_TRAVERSAL=xla reaches the route through the CLI: its stats
    line names the traversal and the pipeline's cluster count, and its PFM
    equals render_path_with_stats under 'xla'."""
    monkeypatch.setenv("RAYITO_TRAVERSAL", "xla")
    out = str(tmp_path / "s6.pfm")
    assert tcli.main(["--device", "cpu", "--scene", "stage6", "--obj",
                      standin8, "--width", "16", "--height", "12",
                      "--pixel-samples", "1", "--depth", "2", "--pfm",
                      "-o", out]) == 0
    err = capsys.readouterr().err
    sd = tdemo.stage6_scene(standin8).compile("cpu")
    assert "traversal=xla" in err and f"clusters={sd.cl_min.shape[0]} " in err
    assert sd.cl_min.shape[0] == 32
    cfg = TConfig(width=16, height=12, pixel_samples=1, light_samples=1,
                  max_depth=2)
    cam = TCam.make(30.0, *tdemo.STAGE6_CAMERA, focal_distance=16.0,
                    lens_radius=0.0, shutter_open=0.0, shutter_close=1.0)
    img, ovf, _ = tpath.render_path_with_stats(sd, cfg, cam)
    assert ovf == 0
    np.testing.assert_array_equal(read_pfm(out).view(np.int32),
                                  img.view(np.int32))
    monkeypatch.setenv("RAYITO_TRAVERSAL", "auto")
    tcli.main(["--device", "cpu", "--scene", "stage1", "--width", "8",
               "--height", "6", "-o", str(tmp_path / "s1.ppm")])
    assert "traversal=pallas" in capsys.readouterr().err


def test_overflow_warnings_and_sharded_overflow(capsys, tmp_path):
    """The layered scene seen end-on overflows: render_path,
    render_progressive and the sharded render warn; the sharded overflow
    over [cpu] * 2 and its image equal the unsharded render's."""
    sd = _layers(tt, light=True).compile("cpu", traversal="xla")
    cfg = TConfig(width=16, height=16, pixel_samples=1, light_samples=1,
                  max_depth=2)
    cam = TCam.make(25.0, (0.0, 0.3, -6.0), (0.0, 0.0, 10.0), (0, 1, 0),
                    focal_distance=16.0, lens_radius=0.0)
    img, ovf, q = tpath.render_path_with_stats(sd, cfg, cam)
    assert ovf > 0 and q > 256
    assert WARNING not in capsys.readouterr().err
    np.testing.assert_array_equal(tpath.render_path(sd, cfg, cam), img)
    assert f"{WARNING} x{ovf}" in capsys.readouterr().err
    prog, stats = tprog.render_progressive(sd, cfg, cam)
    assert stats.overflow == ovf and stats.rays_traced == q
    np.testing.assert_array_equal(prog, img)
    assert f"{WARNING} x{ovf}" in capsys.readouterr().err
    mesh = [torch.device("cpu")] * 2
    sh_img, sh_ovf, sh_q = tshard.render_path_sharded_with_stats(
        sd, cfg, cam, mesh)
    assert (sh_ovf, sh_q) == (ovf, q)
    np.testing.assert_array_equal(sh_img, img)
    assert f"{WARNING} x{ovf}" in capsys.readouterr().err
    _, st = tprog.render_progressive(sd, cfg, cam, mesh=mesh)
    assert st.overflow == ovf
