"""Port parity: stage 7 (keyed transforms, motion blur, nested groups) end
to end on the CPU.

Three scenes, compiled by each package (the reference with the main
path's kernel settings: traversal='pallas' in interpret mode,
traverse_mt='bw_closest', tiny_fold=False):

  * ``stage7_scene1`` on the bumpy stand-in at n=8: the mesh's three-key
    rotation gives it a traversal domain of its own, entered in mesh-local
    space at each lane's time; the cube is a tiny transformed mesh;
  * ``stage7_scene2``: ten bouncing spheres and ten tumbling cubes, every
    cube a tiny transformed mesh (no traversal domain);
  * a depth-3 nested-group scene (a moving group around a static group
    around shapes with their own transforms) with a mesh domain, a cube, a
    sphere and a rect light inside the chain.

Checks: ``compile_arrays`` equal to the reference's arrays bit for bit;
scene_intersect / scene_occluded on 512 seeded rays at seeded times in
[0, 1] (identical hit, shape, material and occlusion; t to 1e-5 relative;
normals to 1e-5 absolute: unit vectors through the same float32 chain,
where XLA may contract a multiply-add into one FMA and PyTorch rounds
twice); 32x32 renders within 0.5% relative RMSE of the reference's with
issued queries within 0.1%; the render at the reference's golden config
against its golden ``path_stage7b.pfm`` (see RENDERS for why that check
counts agreeing pixels).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayito_tpu as rt
import rayito_tpu.models.demo as jdemo
import rayito_tpu.models.obj as jobj
from rayito_tpu.models.camera import PerspectiveCamera as JCam
from rayito_tpu.ops.vec3 import V3 as JV3
from rayito_tpu.render import mesh_intersect as jmi
from rayito_tpu.render import pathtracer as jpath
from rayito_tpu.render import trace as jtrace
from rayito_tpu.utils.config import RenderConfig as JConfig
from rayito_tpu.utils.image import read_pfm
import rayito_tpu_torch as tt
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.models import obj as tobj
from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
from rayito_tpu_torch.models.scene import (
    ARRAY_FIELDS,
    DOMAIN_FIELDS,
    STATIC_FIELDS,
    scene_data_from_arrays,
)
from rayito_tpu_torch.ops.vec3 import V3 as TV3
from rayito_tpu_torch.render import mesh_intersect as tmi
from rayito_tpu_torch.render import pathtracer as tpath
from rayito_tpu_torch.render import trace as ttrace
from rayito_tpu_torch.utils.config import RenderConfig as TConfig
from rayito_tpu_torch.utils.image import diagnose

JAX_COMPILE = dict(traversal="pallas", traverse_mt="bw_closest",
                   tiny_fold=False)
N_RAYS = 512
SCENES = ("stage7_scene1", "stage7_scene2", "nested_groups")
# the item knobs are module defaults in the reference, SceneData fields here
PORT_ONLY_STATIC = ("traverse_items", "items_w", "items_max", "items_cap")


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


def _nested_groups(pkg, objmod, path):
    """Depth-3 chains (after the reference's nested-group test): a group
    rotating about Y over the shutter holds a translated group, which
    holds a sphere, the stand-in mesh, a cube and a rect light, each with
    a transform of its own; a plane and a sphere light stay at the root."""
    s = pkg.Scene()
    s.add(pkg.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                    pkg.DiffuseMaterial((0.6, 0.6, 0.9)), bullseye=True))
    outer = pkg.Group()
    outer.transform.set_rotation(0.0, (1.0, 0.0, 0.0, 0.0))
    outer.transform.set_rotation(
        1.0, (np.cos(np.pi / 6), 0.0, np.sin(np.pi / 6), 0.0))
    outer.transform.set_translation(1.0, (0.5, 0.0, 0.0))
    inner = pkg.Group()
    inner.transform.set_translation(0.0, (0.0, 0.5, 0.0))
    inner.transform.set_scaling(0.0, (1.0, 1.2, 1.0))
    sph = pkg.Sphere((0.0, 0.0, 0.0), 0.6, pkg.GlossyMaterial((0.3, 0.9, 0.3),
                                                             0.1))
    sph.transform.set_translation(0.0, (-2.5, 0.0, 1.0))
    sph.transform.set_translation(1.0, (-2.0, 0.0, 1.0))
    inner.add(sph)
    mesh = objmod.load_obj(path, pkg.GlossyMaterial((0.8, 0.1, 0.1), 0.3))
    mesh.transform.set_rotation(0.0, (1.0, 0.0, 0.0, 0.0))
    mesh.transform.set_rotation(
        1.0, (np.cos(np.pi / 8), np.sin(np.pi / 8), 0.0, 0.0))
    inner.add(mesh)
    cube = (tdemo if pkg is tt else jdemo).make_cube(
        pkg.DiffuseMaterial((0.8, 0.3, 0.1)))
    cube.transform.set_translation(0.0, (1.5, -1.0, 1.0))
    inner.add(cube)
    inner.add(pkg.RectangleLight((0.0, 0.0, 0.0), (2.0, 0.0, 0.0),
                                 (0.0, 0.0, 2.0), (1.0, 1.0, 1.0), 5.0,
                                 transform=pkg.Transform(
                                     times=[0.0],
                                     translations=[(-1.0, 3.0, -1.0)])))
    outer.add(inner)
    s.add(outer)
    s.add(pkg.ShapeLight(pkg.Sphere((0.0, 2.0, 4.0), 0.2,
                                    pkg.DiffuseMaterial((0.6, 0.6, 0.9))),
                         color=(1.0, 1.0, 0.3), power=40.0))
    return s


def _builders(name, path):
    if name == "stage7_scene1":
        return jdemo.stage7_scene1(path), tdemo.stage7_scene1(path)
    if name == "stage7_scene2":
        return jdemo.stage7_scene2(), tdemo.stage7_scene2()
    return _nested_groups(rt, jobj, path), _nested_groups(tt, tobj, path)


@pytest.fixture(scope="module")
def compiled(standin8):
    """{scene: (jax SceneData, port arrays, port static, port SceneData)}."""
    out = {}
    for name in SCENES:
        js, ts = _builders(name, standin8)
        arrays, static = ts.compile_arrays()
        out[name] = (js.compile(**JAX_COMPILE), arrays, static,
                     scene_data_from_arrays(arrays, static, "cpu"))
    return out


def _jax_field(jsd, name):
    v = getattr(jsd, name)
    if isinstance(v, tuple):
        return [np.asarray(a) for a in v]
    return np.asarray(v)


@pytest.mark.parametrize("scene", SCENES)
def test_compile_arrays_bit_identical(compiled, scene):
    jsd, arrays, _, own = compiled[scene]
    for field in ARRAY_FIELDS + DOMAIN_FIELDS:
        ref, got = _jax_field(jsd, field), arrays[field]
        if isinstance(ref, list):
            assert len(ref) == len(got), field
            pairs = zip(ref, got)
        else:
            pairs = [(ref, got)]
        for r, g in pairs:
            assert g.dtype == r.dtype and g.shape == r.shape, field
            np.testing.assert_array_equal(g, r, err_msg=field)
    for k in STATIC_FIELDS:
        if k not in PORT_ONLY_STATIC:
            assert getattr(own, k) == getattr(jsd, k), k


def test_stage7_layouts(compiled):
    """Scene 1: the world-space domain is gone (every mesh moves); the
    bumpy mesh is a domain in its own slot, the cube a tiny mesh. Scene 2:
    no domain, ten tiny meshes. Nested groups: chains of depth 3."""
    _, _, s1, _ = compiled["stage7_scene1"]
    assert s1["ktab_xf"] == (9,) and s1["ktab_small"] == (0,)
    assert s1["has_motion"] and s1["xf_depth"] == 1
    _, _, s2, d2 = compiled["stage7_scene2"]
    assert s2["ktab_xf"] == () and s2["ktab_small"] == tuple(range(10))
    assert d2.n_spheres == 10 and d2.n_meshes == 10
    jsd, _, sg, _ = compiled["nested_groups"]
    assert sg["xf_depth"] == 3 and len(sg["ktab_xf"]) == 1
    assert sg["ktab_small"] == (1,) and sg["ktab_xf"][0] != 0


def test_scene_data_from_reference_arrays(compiled):
    """The reference's compiled stage-7 arrays carried across equal the
    port's own compile, tensor for tensor, host slots included."""
    jsd, _, _, own = compiled["nested_groups"]
    ref_arrays = {k: _jax_field(jsd, k) for k in ARRAY_FIELDS + DOMAIN_FIELDS}
    ref_static = {k: getattr(own if k in PORT_ONLY_STATIC else jsd, k)
                  for k in STATIC_FIELDS}
    from_ref = scene_data_from_arrays(ref_arrays, ref_static, "cpu")
    for k in ARRAY_FIELDS:
        assert torch.equal(getattr(from_ref, k), getattr(own, k)), k
    for k in DOMAIN_FIELDS:
        for a, b in zip(getattr(from_ref, k), getattr(own, k)):
            assert torch.equal(a, b), k
    for k in ("pln_xf_host", "sph_xf_host", "rect_xf_host", "mesh_xf_host",
              "xf_parent_host", "has_motion", "xf_depth", "ktab_small"):
        assert getattr(from_ref, k) == getattr(own, k), k


def _both_v3(a):
    return (JV3(*(jnp.asarray(a[:, k]) for k in range(3))),
            TV3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3))))


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


# per scene: (camera eye, look-at spread center, sigma) for closest-hit
# rays; (floor y, xz half-width, light center) for shadow rays
RAYS = {
    "stage7_scene1": ((-4.0, 5.0, 15.0), (0.2, -0.5, 0.0), 1.8,
                      -1.9, 4.0, (0.0, 4.0, 0.0)),
    "stage7_scene2": ((-4.0, 10.0, 30.0), (0.0, 5.0, 0.0), 4.0,
                      0.1, 10.0, (0.0, 15.0, 2.0)),
    "nested_groups": ((-3.0, 4.0, 12.0), (0.0, -0.5, 0.5), 1.8,
                      -1.9, 4.0, (0.0, 3.5, 0.0)),
}


def _camera_rays(scene, seed):
    eye, look, sigma = RAYS[scene][:3]
    rs = np.random.default_rng(seed)
    o = (np.asarray(eye) + rs.uniform(-1.0, 1.0, (N_RAYS, 3)))
    tgt = np.asarray(look) + rs.normal(0.0, sigma, (N_RAYS, 3))
    time = rs.uniform(0.0, 1.0, N_RAYS).astype(np.float32)
    return o.astype(np.float32), _unit(tgt - o), time


def _shadow_rays(scene, seed):
    floor, half, light = RAYS[scene][3:]
    rs = np.random.default_rng(seed)
    o = np.stack([rs.uniform(-half, half, N_RAYS),
                  np.full(N_RAYS, floor),
                  rs.uniform(-half, half, N_RAYS)], 1)
    tgt = np.asarray(light) + rs.uniform(-1.0, 1.0, (N_RAYS, 3)) * (1, 0, 1)
    dist = np.linalg.norm(tgt - o, axis=1).astype(np.float32)
    time = rs.uniform(0.0, 1.0, N_RAYS).astype(np.float32)
    return o.astype(np.float32), _unit(tgt - o), dist - 1e-3, time


@pytest.mark.parametrize("scene", SCENES)
def test_scene_intersect_parity(compiled, scene):
    jsd, _, _, tsd = compiled[scene]
    o, d, time = _camera_rays(scene, 11)
    (jo, to), (jd, td) = _both_v3(o), _both_v3(d)
    ref = jtrace.scene_intersect(jsd, jo, jd, jnp.asarray(time), 1e-4,
                                 jnp.full((N_RAYS,), 1e30, jnp.float32))
    got = ttrace.scene_intersect(tsd, to, td, torch.from_numpy(time), 1e-4,
                                 torch.full((N_RAYS,), 1e30))
    valid = np.asarray(ref.valid)
    sid = np.asarray(ref.shape_id)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.shape_id.numpy(), sid)
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(ref.mat))
    mesh_hits = valid & (sid >= tsd.mesh_id0)
    assert valid.sum() > N_RAYS // 2 and mesh_hits.sum() >= N_RAYS // 32
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(ref.t)[valid],
                               rtol=1e-5)
    for c in "xyz":
        np.testing.assert_allclose(
            getattr(got.normal, c).numpy()[valid],
            np.asarray(getattr(ref.normal, c))[valid], atol=1e-5)
    np.testing.assert_array_equal(got.color_mod.numpy(),
                                  np.asarray(ref.color_mod))


@pytest.mark.parametrize("scene", SCENES)
def test_scene_occluded_parity(compiled, scene):
    jsd, _, _, tsd = compiled[scene]
    o, d, tmax, time = _shadow_rays(scene, 23)
    (jo, to), (jd, td) = _both_v3(o), _both_v3(d)
    ref, _ = jtrace.scene_occluded(jsd, jo, jd, jnp.asarray(time), 1e-4,
                                   jnp.asarray(tmax))
    got, _ = ttrace.scene_occluded(tsd, to, td, torch.from_numpy(time), 1e-4,
                                   torch.from_numpy(tmax))
    ref = np.asarray(ref)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert N_RAYS // 32 < ref.sum() < N_RAYS - N_RAYS // 32


def test_lane_times_move_the_shapes(compiled):
    """A moving scene reads each lane's time: the same rays at times 0 and
    1 see the moving shapes elsewhere."""
    _, _, _, tsd = compiled["stage7_scene2"]
    o, d, _ = _camera_rays("stage7_scene2", 5)
    _, to = _both_v3(o)
    _, td = _both_v3(d)
    tmax = torch.full((N_RAYS,), 1e30)
    h0 = ttrace.scene_intersect(tsd, to, td, 0.0, 1e-4, tmax)
    h1 = ttrace.scene_intersect(tsd, to, td, torch.ones(N_RAYS), 1e-4, tmax)
    assert not torch.equal(h0.shape_id, h1.shape_id)


def test_tiny_mesh_fold_matches_reference_brute_force(compiled):
    """The dense fold of one cube against the reference's dense XLA brute
    force on the same local rays: the same winners (first of tied minima,
    -1 on all-miss rows) and barycentrics."""
    jsd, _, _, tsd = compiled["stage7_scene2"]
    o = np.tile(np.asarray([0.5, 0.5, 6.0], np.float32), (N_RAYS, 1))
    d = _unit(np.random.default_rng(3).normal(0.0, 0.15, (N_RAYS, 3))
              + np.asarray([0.0, 0.0, -1.0]))
    (jo, to), (jd, td) = _both_v3(o), _both_v3(d)
    tmax = np.full(N_RAYS, 1e30, np.float32)
    tmax[::7] = 5.0  # some rays end before the cube
    cl0, n_cl = jsd.mesh_cl_ranges[3]
    tri0 = jsd.mesh_tri_ranges[3][0]
    ref = jmi._brute_force_mesh(jsd, cl0, n_cl, tri0, jo, jd, 1e-4,
                                jnp.asarray(tmax))
    got = tmi.mesh_fold_small(tsd, 3, to, td, 1e-4, torch.from_numpy(tmax))
    prim = np.asarray(ref[1])
    np.testing.assert_array_equal(got[1].numpy(), prim)
    hit = prim >= 0
    assert 0 < hit.sum() < N_RAYS and (prim[::7] == -1).all()
    for g, r in zip(got[:1] + got[2:4], ref[:1] + ref[2:4]):
        np.testing.assert_allclose(g.numpy()[hit], np.asarray(r)[hit],
                                   rtol=1e-6, atol=1e-6)


def _render_kw(width, height, spp, **kw):
    return dict(width=width, height=height, pixel_samples=spp,
                light_samples=1, max_depth=3, seed=1, **kw)


def _camera(pkg_cam, spec):
    return pkg_cam.make(30.0, *spec, focal_distance=16.0, lens_radius=0.0,
                        shutter_open=0.0, shutter_close=1.0)


# Stage 7b's spheres sit 30 units from the camera, where the float32 sphere
# quadratic (b*b - 4ac cancels) puts hit points up to ~5e-5 off the
# surface: farther than the 1e-4 shadow-ray epsilon allows, so a shadow ray
# leaving near the terminator hits its own sphere or not depending on the
# last bits of t. Those bits follow the compiler's fused multiply-adds: the
# reference's own render built at XLA's LLVM optimisation level 0 differs
# from its golden by 6.4% relative RMSE, on 2.1% of the pixels
# (tools/stage7b_knife_edge.py). Its render comparison therefore runs at a
# 1e-2 epsilon, far above that error; the golden check below bounds what
# the knife edge may change.
RENDERS = {
    "stage7_scene1": (jdemo.STAGE7_CAMERA, {}),
    "stage7_scene2": (jdemo.STAGE7_SCENE2_CAMERA, dict(ray_tmin=1e-2)),
}


@pytest.fixture(scope="module")
def renders(compiled):
    out = {}
    for name, (spec, extra) in RENDERS.items():
        jsd, _, _, tsd = compiled[name]
        kw = _render_kw(32, 32, 1, **extra)
        j_img, _, j_q = jpath.render_path_with_stats(
            jsd, JConfig(**kw), _camera(JCam, spec))
        t_img, _, t_q = tpath.render_path_with_stats(
            tsd, TConfig(**kw), _camera(TCam, spec))
        out[name] = (np.asarray(j_img, np.float32), int(j_q), t_img, int(t_q))
    return out


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / max(np.sqrt(np.mean(b ** 2)), 1e-20))


@pytest.mark.parametrize("scene", sorted(RENDERS))
def test_render_matches_reference(renders, scene):
    j_img, j_q, t_img, t_q = renders[scene]
    assert t_img.shape == j_img.shape == (32, 32, 3)
    err = _rel_rmse(t_img, j_img)
    assert err <= 0.005, f"relative RMSE {err:.4%} > 0.5%"
    assert j_img.max() > 0.0
    assert abs(t_q - j_q) <= 0.001 * j_q, (t_q, j_q)
    diag = diagnose(t_img)
    assert diag["nan_pixels"] == 0 and diag["negative_pixels"] == 0


def test_render_matches_reference_golden_stage7b():
    """The reference's own golden of stage 7b (96x64, 2x2 samples, depth
    3, seed 1, shutter 0..1, epsilon 1e-4), rendered by the port: at least
    96% of the pixels within 1e-3 of the golden (the reference's level-0
    build: 97.9%; the port: 97.7%) and every channel's mean within 5% (2.8%
    and 1.0%). An estimator fault (a MIS weight, a pdf, the emission gate)
    moves every lit pixel; the self-shadowing knife edge above moves a few
    terminator pixels by whole light samples."""
    golden = read_pfm(os.path.join(os.path.dirname(__file__), "goldens",
                                   "path_stage7b.pfm"))
    tsd = tdemo.stage7_scene2().compile("cpu")
    img = tpath.render_path(tsd, TConfig(**_render_kw(96, 64, 2)),
                            _camera(TCam, tdemo.STAGE7_SCENE2_CAMERA))
    assert img.shape == golden.shape
    close = np.abs(img - golden).max(axis=2) <= 1e-3
    assert close.mean() >= 0.96, f"{close.mean():.2%} of pixels agree"
    means = img.mean(axis=(0, 1)) / golden.mean(axis=(0, 1))
    assert np.all(np.abs(means - 1.0) <= 0.05), means
    diag = diagnose(img)
    assert diag["nan_pixels"] == 0 and diag["negative_pixels"] == 0


def test_tiny_fold_is_not_ported():
    with pytest.raises(ValueError, match="tiny_fold"):
        tdemo.stage7_scene2().compile("cpu", tiny_fold=True)


def test_xla_traversal_still_raises():
    """traversal='xla' compiles (tests/test_torch_xla.py holds the route);
    a traversal that neither package has still raises."""
    assert tdemo.stage7_scene2().compile("cpu", traversal="xla").traversal \
        == "xla"
    with pytest.raises(ValueError, match="traversal"):
        tdemo.stage7_scene2().compile("cpu", traversal="cuda")


def test_mesh_above_brute_force_size_raises(compiled):
    """A transformed mesh above 192 triangles is a traversal domain of its
    own (or, under traversal='xla', goes through the two-level pipeline);
    the dense fold refuses it."""
    _, _, _, tsd = compiled["stage7_scene1"]
    _, to = _both_v3(np.zeros((4, 3), np.float32))
    _, td = _both_v3(np.ones((4, 3), np.float32))
    with pytest.raises(ValueError, match="192"):
        tmi.mesh_fold_small(tsd, 1, to, td, 1e-4, 1e30)
