"""Port parity: mesh ShapeLights (the area CDF, triangle-by-area sampling,
the BRDF-side closest-hit branch of the path tracer) against the JAX
package on the CPU.

Three scenes, compiled by each package (the reference with the main path's
kernel settings: traversal='pallas' in interpret mode,
traverse_mt='bw_closest', tiny_fold=False):

  * ``box_light``: a plane, the inline box, and a second inline box scaled
    and lifted, wrapped as a light (two meshes, the light the last; 12
    triangles in a run of 48, so the reference's padded CDF slice is cut
    at the table's end);
  * ``moving_quad``: a two-triangle quad light under a two-key translation
    and rotation (the sample leaves through the transform at the lane's
    time; the quad is a tiny transformed mesh);
  * ``standin_light``: the bumpy stand-in at n=8 wrapped as a light (768
    triangles: the padded slice is exactly the mesh's run).

Checks: the CDF tables bit for bit; ``sample_light`` and
``light_intersect_pdf`` lane for lane on seeded inputs (identical triangle
picks and rejected-sample masks away from the facing edge, position to
1e-5 absolute, pdf to 1e-5 relative), with the two ends of u3 apart; the
two queries of the BRDF-side branch on the same inputs; a 32x32 render of
``box_light`` within 0.5% relative RMSE with query counts within 0.1%;
a nine-light set with one mesh light, which warns and renders; and a mesh
light that is not the scene's last mesh, where the reference's CDF slice is
not sorted and the port searches the light's own run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayito_tpu as rt
import rayito_tpu.models.demo as jdemo
import rayito_tpu.models.obj as jobj
from rayito_tpu.models.camera import PerspectiveCamera as JCam
from rayito_tpu.ops.vec3 import V3 as JV3
from rayito_tpu.render import lights as jlights
from rayito_tpu.render import pathtracer as jpath
from rayito_tpu.render import trace as jtrace
from rayito_tpu.utils.config import RenderConfig as JConfig
import rayito_tpu_torch as tt
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.models import obj as tobj
from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
from rayito_tpu_torch.models.scene import LIGHT_MESH, scene_data_from_arrays
from rayito_tpu_torch.ops.vec3 import V3 as TV3
from rayito_tpu_torch.render import lights as tlights
from rayito_tpu_torch.render import pathtracer as tpath
from rayito_tpu_torch.render import trace as ttrace
from rayito_tpu_torch.utils.config import RenderConfig as TConfig
from rayito_tpu_torch.utils.image import diagnose

JAX_COMPILE = dict(traversal="pallas", traverse_mt="bw_closest",
                   tiny_fold=False)
N = 512
TMIN = 1e-4
SCENES = ("box_light", "moving_quad", "standin_light")


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
    b = pkg.Scene()
    b.add(pkg.Plane((0.0, -1.5, 0.0), (0.0, 1.0, 0.0),
                    pkg.DiffuseMaterial((0.7, 0.7, 0.8))))
    b.add(demo.inline_box_mesh(pkg.DiffuseMaterial((0.8, 0.3, 0.1))))
    lm = demo.inline_box_mesh(pkg.DiffuseMaterial((0.9, 0.9, 0.9)))
    lm.vertices = (np.asarray(lm.vertices, np.float32) * np.float32(0.5)
                   + np.float32([0.0, 3.0, 0.0]))
    b.add(pkg.ShapeLight(lm, color=(1.0, 1.0, 1.0), power=8.0))
    return b


def _moving_quad(pkg):
    verts = np.array([[-0.5, 3.0, -0.5], [0.5, 3.0, -0.5], [0.5, 3.0, 0.5],
                      [-0.5, 3.0, 0.5]], np.float32)
    # winding chosen so cross(p1-p0, p2-p0) points down, toward the plane
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    s = pkg.Scene()
    s.add(pkg.Plane((0, 0, 0), (0, 1, 0), pkg.DiffuseMaterial((0.8,) * 3)))
    quad = pkg.TriangleMesh(vertices=verts, indices=tris,
                            material=pkg.DiffuseMaterial((1, 1, 1)),
                            face_ids=np.array([0, 0], np.int32))
    quad.transform.set_translation(0.0, (0.0, 0.0, 0.0))
    quad.transform.set_translation(1.0, (1.0, 0.5, 0.0))
    quad.transform.set_rotation(0.0, (1.0, 0.0, 0.0, 0.0))
    quad.transform.set_rotation(
        1.0, (np.cos(np.pi / 12), 0.0, 0.0, np.sin(np.pi / 12)))
    s.add(pkg.ShapeLight(quad, (1.0, 1.0, 1.0), 5.0))
    return s


def _standin_light(pkg, objmod, path):
    s = pkg.Scene()
    s.add(pkg.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                    pkg.DiffuseMaterial((0.7, 0.7, 0.9)), bullseye=True))
    s.add(pkg.Sphere((3.0, -1.0, 0.0), 1.0,
                     pkg.GlossyMaterial((0.3, 0.9, 0.3), 0.1)))
    s.add(pkg.ShapeLight(
        objmod.load_obj(path, pkg.DiffuseMaterial((1, 1, 1))),
        color=(1.0, 0.9, 0.8), power=6.0))
    return s


@pytest.fixture(scope="module")
def compiled(standin8):
    """{scene: (jax SceneData, port arrays, port static, port SceneData)}."""
    scenes = {
        "box_light": (_box_light(rt, jdemo), _box_light(tt, tdemo)),
        "moving_quad": (_moving_quad(rt), _moving_quad(tt)),
        "standin_light": (_standin_light(rt, jobj, standin8),
                          _standin_light(tt, tobj, standin8)),
    }
    out = {}
    for name, (js, ts) in scenes.items():
        arrays, static = ts.compile_arrays()
        out[name] = (js.compile(**JAX_COMPILE), arrays, static,
                     scene_data_from_arrays(arrays, static, "cpu"))
    return out


def _both_v3(a):
    return (JV3(*(jnp.asarray(a[:, k]) for k in range(3))),
            TV3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3))))


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _np3(v):
    return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], 1)


def _mesh_light(tsd):
    li = tsd.light_kinds_host.index(LIGHT_MESH)
    return li, tsd.light_indices_host[li]


@pytest.mark.parametrize("scene", SCENES)
def test_cdf_tables_bit_identical(compiled, scene):
    jsd, arrays, static, tsd = compiled[scene]
    for field in ("tri_area_cdf", "mesh_total_area"):
        ref = np.asarray(getattr(jsd, field))
        assert arrays[field].dtype == ref.dtype == np.float32, field
        np.testing.assert_array_equal(arrays[field], ref, err_msg=field)
    assert static["mesh_cl_ranges"] == jsd.mesh_cl_ranges
    assert static["mesh_tri_ranges"] == jsd.mesh_tri_ranges
    assert tsd.light_kinds_host == jsd.light_kinds_host
    mi = _mesh_light(tsd)[1]
    # a multiple of 16 clusters; the CDF ends at the mesh's area
    assert static["mesh_cl_ranges"][mi][1] % 16 == 0
    tri0, count = static["mesh_tri_ranges"][mi]
    assert arrays["tri_area_cdf"][tri0 + count - 1] == \
        arrays["mesh_total_area"][mi] > 0.0


def test_reference_arrays_carry_the_cdf_across(compiled):
    """SceneData built from the reference's arrays samples as the port's
    own compile does."""
    from rayito_tpu_torch.models.scene import (ARRAY_FIELDS, DOMAIN_FIELDS,
                                               STATIC_FIELDS)
    jsd, _, _, own = compiled["box_light"]
    port_only = ("traverse_items", "items_w", "items_max", "items_cap")

    def field(name):
        v = getattr(jsd, name)
        return ([np.asarray(a) for a in v] if isinstance(v, tuple)
                else np.asarray(v))

    from_ref = scene_data_from_arrays(
        {k: field(k) for k in ARRAY_FIELDS + DOMAIN_FIELDS},
        {k: getattr(own if k in port_only else jsd, k)
         for k in STATIC_FIELDS}, "cpu")
    assert torch.equal(from_ref.tri_area_cdf, own.tri_area_cdf)
    assert torch.equal(from_ref.mesh_total_area, own.mesh_total_area)
    assert from_ref.mesh_cl_ranges == own.mesh_cl_ranges


def _sample_inputs(scene, seed):
    rs = np.random.default_rng(seed)
    floor = {"box_light": -1.5, "moving_quad": 0.0, "standin_light": -2.0}
    ref_pos = np.stack([rs.uniform(-3, 3, N), np.full(N, floor[scene]),
                        rs.uniform(-3, 3, N)], 1).astype(np.float32)
    ref_pos[N // 2:, 1] += rs.uniform(0.0, 6.0, N - N // 2).astype(np.float32)
    u = rs.uniform(0.0, 1.0, (3, N)).astype(np.float32)
    time = rs.uniform(0.0, 1.0, N).astype(np.float32)
    return ref_pos, u, time


def _sample_both(compiled, scene, ref_pos, u, time):
    jsd, _, _, tsd = compiled[scene]
    li, _ = _mesh_light(tsd)
    jp, tp = _both_v3(ref_pos)
    jn, tn = _both_v3(np.tile(np.float32([0, 1, 0]), (len(time), 1)))
    (ju1, tu1), (ju2, tu2), (ju3, tu3) = (_both(x) for x in u)
    jt, ttime = _both(time)
    ref = jlights.sample_light(jsd, li, jp, jn, jt, ju1, ju2, ju3, TMIN)
    got = tlights.sample_light(tsd, li, tp, tn, ttime, tu1, tu2, tu3, TMIN)
    return ref, got


@pytest.mark.parametrize("scene", SCENES)
def test_triangle_picks_identical(compiled, scene):
    """The port searches the mesh's own run of the f32 CDF, the reference
    its padded slice (here cut at the table's end, or the run itself): the
    same index lane for lane, the ends of u3 included."""
    jsd, _, _, tsd = compiled[scene]
    mi = _mesh_light(tsd)[1]
    tri0, count = tsd.mesh_tri_ranges[mi]
    n_padded = tsd.mesh_cl_ranges[mi][1] * 48
    own = -(-count // 48) * 48
    u3 = np.random.default_rng(2).uniform(0, 1, N).astype(np.float32)
    u3[:2] = 0.0, np.nextafter(np.float32(1.0), np.float32(0.0))
    jcdf = jsd.tri_area_cdf[tri0:tri0 + n_padded]
    assert len(jcdf) == own
    ref = np.asarray(jnp.searchsorted(
        jcdf, jnp.asarray(u3) * jsd.mesh_total_area[mi], side="right"))
    got = torch.searchsorted(
        tsd.tri_area_cdf[tri0:tri0 + own],
        torch.from_numpy(u3) * tsd.mesh_total_area[mi], right=True).numpy()
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(ref)) > 1


def _box_light_first(pkg, demo, objmod, path):
    """box_light's light mesh as the FIRST mesh, the n=8 stand-in (768
    triangles) after it: the reference's padded CDF slice of the light,
    16 x 48 entries, runs through the stand-in's CDF."""
    b = pkg.Scene()
    b.add(pkg.Plane((0.0, -1.5, 0.0), (0.0, 1.0, 0.0),
                    pkg.DiffuseMaterial((0.7, 0.7, 0.8))))
    lm = demo.inline_box_mesh(pkg.DiffuseMaterial((0.9, 0.9, 0.9)))
    lm.vertices = (np.asarray(lm.vertices, np.float32) * np.float32(0.5)
                   + np.float32([0.0, 3.0, 0.0]))
    b.add(pkg.ShapeLight(lm, color=(1.0, 1.0, 1.0), power=8.0))
    b.add(objmod.load_obj(path, pkg.DiffuseMaterial((0.8, 0.3, 0.1))))
    return b


def test_mesh_light_before_another_mesh(compiled, standin8):
    """A mesh light that is not the scene's last mesh. The reference's
    binary search runs over a slice that is not sorted (its own run, then
    the next mesh's CDF from 0 up) and leaves the light's run on most
    lanes: those picks are pad triangles of zero area (ROADMAP Queue 3).
    The port searches the light's own sorted run: every pick is a triangle
    of the light, the one the same light gives as the scene's last mesh,
    and wherever the reference's pick is the CDF's answer (the first
    cumulative area above u3 * total) the two agree."""
    jsd = _box_light_first(rt, jdemo, jobj, standin8).compile(**JAX_COMPILE)
    tsd = _box_light_first(tt, tdemo, tobj, standin8).compile("cpu")
    last = compiled["box_light"][3]
    li, mi = _mesh_light(tsd)
    assert mi == 0 and tsd.n_meshes == 2
    tri0, count = tsd.mesh_tri_ranges[mi]
    assert (tri0, count) == (0, 12) and tsd.mesh_cl_ranges == jsd.mesh_cl_ranges
    np.testing.assert_array_equal(tsd.tri_area_cdf.numpy(),
                                  np.asarray(jsd.tri_area_cdf))
    n_padded = tsd.mesh_cl_ranges[mi][1] * 48
    ref_pos, u, time = _sample_inputs("box_light", 61)
    x = u[2] * np.float32(tsd.mesh_total_area[mi])
    cdf = tsd.tri_area_cdf.numpy()
    ref = np.asarray(jnp.searchsorted(jsd.tri_area_cdf[:n_padded],
                                      jnp.asarray(x), side="right"))
    got = torch.searchsorted(tsd.tri_area_cdf[:48], torch.from_numpy(x),
                             right=True).numpy()
    assert (got < count).all()
    defined = (ref < 48) & (cdf[np.minimum(ref, 47)] > x) & (
        (ref == 0) | (cdf[np.maximum(ref, 1) - 1] <= x))
    np.testing.assert_array_equal(got[defined], ref[defined])
    assert (ref >= 48).mean() > 0.5  # the reference's search left the run

    pos = _both_v3(ref_pos)[1]
    u1, u2, u3, tt_ = (torch.from_numpy(a) for a in (*u, time))
    first = tlights.sample_light(tsd, li, pos, None, tt_, u1, u2, u3, TMIN)
    as_last = tlights.sample_light(last, _mesh_light(last)[0], pos, None, tt_,
                                   u1, u2, u3, TMIN)
    for g, w in zip(first[:2], as_last[:2]):
        np.testing.assert_array_equal(_np3(g), _np3(w))
    np.testing.assert_array_equal(first[2].numpy(), as_last[2].numpy())
    assert (first[2] > 0).sum() > N // 16
    nrm = _np3(first[1])
    assert (np.abs(np.linalg.norm(nrm, axis=1) - 1.0) < 1e-5).all()


@pytest.mark.parametrize("scene", SCENES)
def test_sample_light_lane_for_lane(compiled, scene):
    ref_pos, u, time = _sample_inputs(scene, 41)
    (r_pos, r_nrm, r_pdf), (g_pos, g_nrm, g_pdf) = _sample_both(
        compiled, scene, ref_pos, u, time)
    r_pos, r_nrm, r_pdf = _np3(r_pos), _np3(r_nrm), np.asarray(r_pdf)
    # the same triangle and barycentrics: positions agree to rounding
    np.testing.assert_allclose(_np3(g_pos), r_pos, atol=1e-5)
    np.testing.assert_allclose(_np3(g_nrm), r_nrm, atol=1e-5)
    # the rejection flips where the sample sees the point edge-on
    facing = np.einsum("ij,ij->i", r_nrm, ref_pos - r_pos)
    clear = np.abs(facing) > 1e-4
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(g_pdf.numpy()[clear] == 0.0,
                                  r_pdf[clear] == 0.0)
    lit = clear & (r_pdf > 0.0)
    assert N // 16 < lit.sum()
    np.testing.assert_allclose(g_pdf.numpy()[lit], r_pdf[lit], rtol=1e-5)


@pytest.mark.parametrize("scene", SCENES)
def test_sample_light_at_the_ends_of_u3(compiled, scene):
    """u3 = 0 picks the first triangle with area; u3 just below 1 the
    last; where u3 * total reaches the total (u3 = 1 here) the pick is the
    clamp's: the last triangle of the padded slice, which past the mesh's
    own run is an all-zero pad triangle (position at the local origin,
    zero normal, an unbounded pdf), as in the reference."""
    n = 12
    ref_pos = np.tile(np.float32([0.3, -1.0, 0.4]), (n, 1))
    ref_pos[:, 0] += np.arange(n, dtype=np.float32) * 0.1
    u = np.full((3, n), 0.37, np.float32)
    u[2, :4] = 0.0
    u[2, 4:8] = np.nextafter(np.float32(1.0), np.float32(0.0))
    u[2, 8:] = 1.0
    time = np.zeros(n, np.float32)  # the local origin stays the world's
    (r_pos, r_nrm, r_pdf), (g_pos, g_nrm, g_pdf) = _sample_both(
        compiled, scene, ref_pos, u, time)
    np.testing.assert_allclose(_np3(g_pos), _np3(r_pos), atol=1e-5)
    np.testing.assert_allclose(_np3(g_nrm), _np3(r_nrm), atol=1e-5)
    r_pdf = np.asarray(r_pdf)
    np.testing.assert_array_equal(g_pdf.numpy() == 0.0, r_pdf == 0.0)
    np.testing.assert_allclose(g_pdf.numpy(), r_pdf, rtol=1e-5)
    assert np.isfinite(_np3(g_pos)).all()
    if scene != "standin_light":
        # the run of 48 is shorter than the 16 x 48 slice: a pad pick
        assert (_np3(g_nrm)[8:] == 0.0).all()
        assert (_np3(g_pos)[8:] == 0.0).all()
        assert (_np3(g_nrm)[:8] != 0.0).any(axis=1).all()


@pytest.mark.parametrize("scene", SCENES)
def test_light_intersect_pdf_lane_for_lane(compiled, scene):
    jsd, _, _, tsd = compiled[scene]
    li, _ = _mesh_light(tsd)
    rs = np.random.default_rng(43)
    o = rs.uniform(-3, 3, (N, 3)).astype(np.float32)
    d = rs.normal(0, 1, (N, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    nrm = rs.normal(0, 1, (N, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    t = rs.uniform(0.5, 9.0, N).astype(np.float32)
    time = rs.uniform(0, 1, N).astype(np.float32)
    (jo, to), (jd, td), (jn, tn) = _both_v3(o), _both_v3(d), _both_v3(nrm)
    (jt, t_t), (jtime, ttime) = _both(t), _both(time)
    ref = np.asarray(jlights.light_intersect_pdf(jsd, li, jo, jd, jt, jn,
                                                 jtime))
    got = tlights.light_intersect_pdf(tsd, li, to, td, t_t, tn, ttime)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    assert (ref > 0).all()
    assert tlights.light_hit_analytic(tsd, li, to, td, ttime, TMIN) is None
    assert jlights.light_hit_analytic(jsd, li, jo, jd, jtime, TMIN) is None


@pytest.mark.parametrize("scene", SCENES)
def test_brdf_side_queries_lane_for_lane(compiled, scene):
    """The two queries a mesh light switches NEE to, on the same inputs:
    the light-side shadow ray that ends on the light's own triangle
    (tmax = dist - tmin), and the BRDF-side closest hit whose dead lanes
    carry tmax = tmin."""
    jsd, _, _, tsd = compiled[scene]
    ref_pos, u, time = _sample_inputs(scene, 47)
    ref_pos[:, 1] += 1e-3  # off the floor, as a shaded point's rounding
    (r_pos, _, r_pdf), _ = _sample_both(compiled, scene, ref_pos, u, time)
    lp = _np3(r_pos)
    inc = ref_pos - lp
    dist = np.sqrt(np.maximum((inc * inc).sum(1), 1e-37)).astype(np.float32)
    d1 = (-inc / dist[:, None]).astype(np.float32)
    ok_l = np.asarray(r_pdf) > 0.0
    tmax_l = np.where(ok_l, dist - np.float32(TMIN), 0.0).astype(np.float32)
    (jp, tp), (jd1, td1) = _both_v3(ref_pos), _both_v3(d1)
    (jt, ttime), (jtm, ttm) = _both(time), _both(tmax_l)
    ref_occ, _ = jtrace.scene_occluded(jsd, jp, jd1, jt, TMIN, jtm)
    got_occ, _ = ttrace.scene_occluded(tsd, tp, td1, ttime, TMIN, ttm)
    np.testing.assert_array_equal(got_occ.numpy(), np.asarray(ref_occ))
    assert ok_l.sum() > N // 16

    rs = np.random.default_rng(53)
    d2 = rs.normal(0, 1, (N, 3))
    d2[:, 1] = np.abs(d2[:, 1])
    d2[: N // 2] = d1[: N // 2]  # half straight at the light
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    ok_b = rs.uniform(0, 1, N) < 0.8
    tmax_b = np.where(ok_b, np.float32(1e30), np.float32(TMIN))
    jd2, td2 = _both_v3(d2)
    jtb, ttb = _both(tmax_b.astype(np.float32))
    ref = jtrace.scene_intersect(jsd, jp, jd2, jt, TMIN, jtb)
    got = ttrace.scene_intersect(tsd, tp, td2, ttime, TMIN, ttb)
    valid, sid = np.asarray(ref.valid), np.asarray(ref.shape_id)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.shape_id.numpy(), sid)
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(ref.mat))
    assert not valid[~ok_b].any()
    light_sid = int(tsd.light_shape_id[_mesh_light(tsd)[0]])
    assert (sid[valid] == light_sid).sum() > N // 32
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(ref.t)[valid],
                               rtol=1e-5)
    for c in "xyz":
        np.testing.assert_allclose(
            getattr(got.normal, c).numpy()[valid],
            np.asarray(getattr(ref.normal, c))[valid], atol=1e-5)


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / max(np.sqrt(np.mean(b ** 2)), 1e-20))


def test_box_light_render_matches_reference(compiled):
    jsd, _, _, tsd = compiled["box_light"]
    kw = dict(width=32, height=32, pixel_samples=1, light_samples=1,
              max_depth=3, aspect_correction=True)
    spec = ((0.0, 2.0, 8.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    j_img, _, j_q = jpath.render_path_with_stats(
        jsd, JConfig(**kw), JCam.make(45.0, *spec))
    t_img, _, t_q = tpath.render_path_with_stats(
        tsd, TConfig(**kw), TCam.make(45.0, *spec))
    j_img, j_q, t_q = np.asarray(j_img, np.float32), int(j_q), int(t_q)
    err = _rel_rmse(t_img, j_img)
    assert err <= 0.005, f"relative RMSE {err:.4%} > 0.5%"
    assert j_img.max() > 0.0
    assert abs(t_q - j_q) <= 0.001 * j_q, (t_q, j_q)
    diag = diagnose(t_img)
    assert diag["nan_pixels"] == 0 and diag["negative_pixels"] == 0


def _nine_lights(pkg):
    """Eight rect lights and one single-triangle mesh light: above
    ROLL_LIGHTS (the reference keeps such a set on its unrolled loop and
    warns; the port warns that the mesh light is evaluated alone)."""
    rs = np.random.default_rng(11)
    b = pkg.Scene()
    b.add(pkg.Plane((0, -1, 0), (0, 1, 0),
                    pkg.DiffuseMaterial((0.7, 0.7, 0.7))))
    for _ in range(8):
        b.add(pkg.RectangleLight(
            tuple(rs.uniform(-6, 6, 3) + np.asarray([0, 6, 0])),
            (1.5, 0, 0), (0, 0, 1.5), tuple(rs.uniform(0.5, 1.0, 3)), 2.0))
    tri_v = np.array([[-1, 5, -1], [1, 5, -1], [0, 5, 1]], np.float32)
    b.add(pkg.ShapeLight(
        pkg.TriangleMesh(tri_v, np.array([[0, 1, 2]], np.int32), None),
        (1.0, 0.9, 0.8), 4.0))
    return b


def test_nine_light_mixed_set_warns_and_renders(capsys):
    tsd = _nine_lights(tt).compile("cpu")
    err = capsys.readouterr().err
    assert "mesh light" in err and "9 lights" in err
    assert tsd.n_lights == 9 > tpath.ROLL_LIGHTS
    jsd = _nine_lights(rt).compile(**JAX_COMPILE)
    kw = dict(width=12, height=8, pixel_samples=1, light_samples=1,
              max_depth=2)
    spec = ((0, 3, 10), (0, 0, 0), (0, 1, 0))
    j_img = np.asarray(jpath.render_path_with_stats(
        jsd, JConfig(**kw), JCam.make(40.0, *spec))[0], np.float32)
    t_img, _, _ = tpath.render_path_with_stats(tsd, TConfig(**kw),
                                               TCam.make(40.0, *spec))
    assert np.isfinite(t_img).all() and t_img.max() > 1e-3
    err = _rel_rmse(t_img, j_img)
    assert err <= 0.005, f"relative RMSE {err:.4%} > 0.5%"


def test_rolled_light_forms_refuse_a_mesh_light(compiled):
    """A mesh light has no analytic hit, so that form refuses it; the
    sampling and pdf forms evaluate it alone, as the per-light functions
    do."""
    _, _, _, tsd = compiled["box_light"]
    z = torch.zeros(4)
    v = TV3(z, z, z + 1.0)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="mesh light"):
        tlights.light_hit_analytic_rolled(tsd, idx, v, v, z, TMIN)
    ref_pos, u, time = _sample_inputs("box_light", 59)
    pos = _both_v3(ref_pos)[1]
    u1, u2, u3, tt_ = (torch.from_numpy(x) for x in (*u, time))
    li = _mesh_light(tsd)[0]
    idx = torch.full((N,), li, dtype=torch.int32)
    got = tlights.sample_chosen_light_rolled(tsd, idx, pos, tt_, u1, u2, u3,
                                             TMIN)
    want = tlights.sample_light(tsd, li, pos, None, tt_, u1, u2, u3, TMIN)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_np3(g), _np3(w))
    np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
    assert (got[2] > 0).sum() > N // 16
