"""Port parity: the stage 1-4 integrators, the MWC generator, the phong
material and the stage-1 camera against rayito_tpu.

  * MWC streams bit-identical to ``rayito_tpu.ops.rng`` (the cases of
    test_rng.py), PhongMaterial rows equal; the stage-1 camera within four
    float32 ulps in under 5% of the lanes: PyTorch's CPU sqrt (a SLEEF
    vector routine, within 0.5001 ulp) rounds 50 of 4,096 of the camera's
    squared lengths one ulp off the correctly rounded root that XLA and
    numpy give; the basis's own normalisations add to it (measured: 2, 3
    and 2 ulps at most on the three cameras);
  * stage 1 (one plane, 1 spp, a colour lookup) bit-identical at 512x512;
  * stage 2 (two rect lights, 64 unstratified samples, chunked) within
    0.5% relative RMSE;
  * stage 3/4 is a float32 knife edge: a sphere ShapeLight's shadow ray
    ends exactly on the light (tmax = the distance to the sampled point),
    so whether the light's own near root falls below tmax is decided by
    the last bits of the arithmetic, and at the stage-3 epsilon (1e-5)
    the spheres shadow themselves near the terminator by the last bits of
    their hit points. XLA contracts multiply-adds inside the jitted pass
    and rounds sin/cos its own way, so the two packages' images differ by
    whole light samples there: 16.6% relative RMSE at 64x64, 2x2 pixel x
    2x2 light samples, 2,833 of 4,096 pixels off by more than 1e-3 (the
    reference built at XLA's LLVM -O0: 15.6%). So stage 3 is held
    (a) per query: on identical inputs every shadow-ray visibility bit
    agrees with the reference evaluated op by op, and with its jitted
    form outside the knife band; (b) by its image's channel means and its
    share of agreeing pixels; (c) its geometry, phong and rect-light
    shading without the sphere light at a 1e-2 epsilon, within 0.5%.
  * _material_shade on identical inputs within rtol 4e-6: the half vector
    is normalised through PyTorch's CPU sqrt (above), and the phong lobe
    pow(h.n, 16) turns its one ulp into 16 (measured 1.5e-6); a lobe that
    underflows may be a denormal on one side and 0 on the other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayito_tpu as jrt
import rayito_tpu_torch as trt
from rayito_tpu.models import camera as jcam
from rayito_tpu.models import demo as jdemo
from rayito_tpu.ops import rng as jrng
from rayito_tpu.ops.vec3 import V3 as JV3
from rayito_tpu.render import integrator as jint
from rayito_tpu.render import trace as jtrace
from rayito_tpu.utils.config import CONFIG_STAGE123 as J123
from rayito_tpu_torch.models import camera as tcam
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.models.scene import ARRAY_FIELDS
from rayito_tpu_torch.ops import rng as trng
from rayito_tpu_torch.ops.vec3 import V3 as TV3, dot
from rayito_tpu_torch.render import integrator as tint
from rayito_tpu_torch.render import trace as ttrace
from rayito_tpu_torch.utils.config import CONFIG_STAGE123 as T123
from rayito_tpu_torch.utils.image import diagnose

STAGE3_SMALL = dict(width=64, height=64, pixel_samples=2, light_samples=2)


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / max(np.sqrt(np.mean(b ** 2)), 1e-20))


def _jv(v: TV3) -> JV3:
    return JV3(*(jnp.asarray(c.numpy()) for c in (v.x, v.y, v.z)))


def _mwc_u32(rng, n, z, w, device=None):
    """n successive MWC outputs of one state (or a batch of states)."""
    state = rng.mwc_init(z, w) if device is None else rng.mwc_init(
        z, w, device)
    out = []
    for _ in range(n):
        state, v = rng.mwc_next_u32(state)
        out.append(np.asarray(v).astype(np.uint64))
    return np.stack(out)


MWC_CASES = {
    # test_rng.py's three cases: the default stream, a thousand floats,
    # a batch of three states
    "bit_parity": (64, jrng.MWC_Z0, jrng.MWC_W0),
    "float_range": (1000, jrng.MWC_Z0, jrng.MWC_W0),
    "vectorized": (1, [1, 2, 3], [10, 20, 30]),
}


@pytest.mark.parametrize("case", sorted(MWC_CASES))
def test_mwc_streams_match_reference(case):
    n, z, w = MWC_CASES[case]
    ref = _mwc_u32(jrng, n, z, w)
    got = _mwc_u32(trng, n, z, w, "cpu")
    np.testing.assert_array_equal(got, ref)
    if case == "float_range":
        fl = trng.u32_to_float01(torch.from_numpy(got.astype(np.int64)))
        np.testing.assert_array_equal(
            fl.numpy(), np.asarray(jrng.u32_to_float01(
                jnp.asarray(ref.astype(np.uint32)))))
        assert (fl >= 0).all() and (fl < 1).all()
        assert abs(float(fl.mean()) - 0.5) < 0.05
        state, f = trng.mwc_next_float(trng.mwc_init())
        j_state, j_f = jrng.mwc_next_float(jrng.mwc_init())
        assert float(f) == float(j_f) and int(state[0]) == int(j_state[0])


def test_phong_material_rows_match_reference():
    jsd = jdemo.stage3_scene().compile()
    arrays, static = tdemo.stage3_scene().compile_arrays()
    for field in ARRAY_FIELDS:
        ref = np.asarray(getattr(jsd, field))
        assert arrays[field].dtype == ref.dtype, field
        np.testing.assert_array_equal(arrays[field], ref, err_msg=field)
    assert static["light_kinds_host"] == jsd.light_kinds_host == (0, 1)
    m = trt.PhongMaterial((0.7, 0.9, 0.7), 16.0)
    assert (m.kind, m.param) == (4, 16.0)
    sd = tdemo.stage3_scene().compile("cpu")
    kind, _, param = ttrace.material_row(sd, torch.tensor([0, 1, 2, -1]))
    assert kind.tolist() == [0, 0, 4, 0] and param[2] == 16.0
    for name in ("STAGE1_CAMERA", "STAGE1_FOV", "STAGE23_CAMERA",
                 "STAGE23_FOV"):
        assert getattr(tdemo, name) == getattr(jdemo, name)


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("spec,fov", [
    (jdemo.STAGE1_CAMERA, 30.0),
    (jdemo.STAGE23_CAMERA, 45.0),
    (((1.0, 2.0, -3.0), (0.5, -1.0, 4.0), (0.2, 1.0, 0.1)), 60.0),
])
def test_stage1_camera_within_four_ulps(spec, fov):
    rs = np.random.default_rng(2)
    xu, yu = rs.uniform(0.0, 1.0, (2, 4096)).astype(np.float32)
    jo, jd = jcam.make_camera_ray_stage1(fov, *spec, xu, yu)
    to, td = tcam.make_camera_ray_stage1(fov, *spec, torch.from_numpy(xu),
                                         torch.from_numpy(yu))
    for j, t in ((jo, to), (jd, td)):
        for c in "xyz":
            ulps = _ulps(np.asarray(getattr(j, c)), getattr(t, c).numpy())
            assert ulps.max() <= 4 and (ulps > 0).mean() < 0.05, c


def test_stage1_bit_identical_at_512():
    jimg = jint.render_color(jdemo.stage1_scene().compile(), J123,
                             fov=jdemo.STAGE1_FOV, camera=jdemo.STAGE1_CAMERA)
    timg = tint.render_color(tdemo.stage1_scene().compile("cpu"), T123,
                             fov=tdemo.STAGE1_FOV, camera=tdemo.STAGE1_CAMERA)
    assert timg.shape == (512, 512, 3) and timg.dtype == np.float32
    np.testing.assert_array_equal(timg, np.asarray(jimg))
    assert (timg.max(axis=2) > 0).mean() > 0.4  # the plane fills the bottom


def _variant(pkg):
    """Stage 3 with the sphere light as a plain diffuse sphere: every
    shading path but the knife-edged sphere light."""
    s = pkg.Scene()
    blueish = pkg.DiffuseMaterial((0.9, 0.9, 1.0))
    s.add(pkg.Plane(position=(0.0, -2.0, 0.0), normal=(0.0, 1.0, 0.0),
                    material=blueish, bullseye=True))
    s.add(pkg.Sphere(position=(3.0, -1.0, 0.0), radius=1.0,
                     material=pkg.DiffuseMaterial((0.9, 0.7, 0.8))))
    s.add(pkg.Sphere(position=(-3.0, 0.0, -2.0), radius=2.0,
                     material=pkg.PhongMaterial((0.7, 0.9, 0.7), 16.0)))
    s.add(pkg.Sphere(position=(0.0, 0.0, 2.0), radius=1.0, material=blueish))
    s.add(pkg.RectangleLight(corner=(-2.5, 4.0, -2.5), side1=(5.0, 0.0, 0.0),
                             side2=(0.0, 0.0, 5.0), color=(1.0, 1.0, 1.0),
                             power=1.0))
    return s


DIRECT = {
    # name: (reference scene, port scene, config fields, spp override)
    "stage2": (jdemo.stage2_scene, tdemo.stage2_scene,
               dict(width=64, height=64, max_rays_per_pass=64 * 64 * 8), 64),
    "stage3_no_sphere_light": (lambda: _variant(jrt), lambda: _variant(trt),
                               dict(STAGE3_SMALL, ray_tmin=1e-2), None),
}


@pytest.mark.parametrize("name", sorted(DIRECT))
def test_direct_render_within_half_percent(name):
    jscene, tscene, kw, spp = DIRECT[name]
    jimg = np.asarray(jint.render_direct(
        jscene().compile(), dataclasses.replace(J123, **kw),
        fov=jdemo.STAGE23_FOV, camera=jdemo.STAGE23_CAMERA, spp=spp))
    timg = tint.render_direct(
        tscene().compile("cpu"), dataclasses.replace(T123, **kw),
        fov=tdemo.STAGE23_FOV, camera=tdemo.STAGE23_CAMERA, spp=spp)
    assert timg.shape == jimg.shape == (64, 64, 3)
    err = _rel_rmse(timg, jimg)
    assert err <= 0.005, f"relative RMSE {err:.4%} > 0.5%"
    assert jimg.max() > 0.0
    diag = diagnose(timg)
    assert diag["nan_pixels"] == 0 and diag["negative_pixels"] == 0


def test_stage3_image_held_by_means_and_agreeing_pixels():
    """Measured: channel means 0.50%, 0.46% and 0.24% below the
    reference's; 30.8% of the pixels within 1e-3 of it (the knife edge
    flips whole sphere-light samples elsewhere)."""
    jimg = np.asarray(jint.render_direct(
        jdemo.stage3_scene().compile(),
        dataclasses.replace(J123, **STAGE3_SMALL), fov=jdemo.STAGE23_FOV,
        camera=jdemo.STAGE23_CAMERA))
    timg = tint.render_direct(
        tdemo.stage3_scene().compile("cpu"),
        dataclasses.replace(T123, **STAGE3_SMALL), fov=tdemo.STAGE23_FOV,
        camera=tdemo.STAGE23_CAMERA)
    means = timg.mean(axis=(0, 1)) / jimg.mean(axis=(0, 1))
    assert np.all(np.abs(means - 1.0) <= 0.01), means
    close = np.abs(timg - jimg).max(axis=2) <= 1e-3
    assert close.mean() >= 0.25, f"{close.mean():.2%} of pixels agree"
    diag = diagnose(timg)
    assert diag["nan_pixels"] == 0 and diag["negative_pixels"] == 0


@pytest.fixture(scope="module")
def stage3_queries():
    """The first pass's camera hits and, per light and light sample, the
    shadow ray the port shoots (positions, directions, distances), on the
    stage-3 scene at 64x64."""
    cfg = dataclasses.replace(T123, **STAGE3_SMALL)
    tsd = tdemo.stage3_scene().compile("cpu")
    px, py = tint._pixel_grid(64, 64)
    si = torch.zeros_like(px)
    jx, jy = tint._subpixel_jitter(cfg, px, py, si, 2, 2)
    xu, yu = tint.screen_uv(cfg, px, py, jx, jy)
    o, d = tcam.make_camera_ray_stage1(45.0, *tdemo.STAGE23_CAMERA, xu, yu)
    hit = ttrace.scene_intersect(tsd, o, d, 0.0, cfg.ray_tmin, 1e30)
    pos = o + d * hit.t
    n = px.shape[0]
    rays = []
    for li in range(tsd.n_lights):
        perm = trng.hash_combine(px, py, si, trng.PURPOSE_LIGHT, li, 1)
        for k in range(4):
            u1, u2 = trng.cmj_sample_2d(torch.full((n,), k), 2, 2, perm)
            lp, _ = tint._sample_light_surface_direct(tsd, li, pos, u1, u2)
            tl = lp - pos
            dist = torch.sqrt(torch.clamp_min(dot(tl, tl), 1e-37))
            rays.append((li, tl / dist, dist))
    return tsd, jdemo.stage3_scene().compile(), hit, pos, d, rays


def _knife_band(sd, li, pos: TV3, d: TV3, dist):
    """Lanes whose shadow ray toward sphere light ``li`` is a knife edge in
    float32: a root of the light sphere's quadratic (float64) within
    1e-5 x dist of dist, or a grazing ray (discriminant within 1e-6 b^2
    of 0, either side)."""
    idx = sd.light_indices_host[li]
    c = sd.sph_center[idx].double().numpy()
    r = float(sd.sph_radius[idx])
    p = np.stack([pos.x.numpy(), pos.y.numpy(), pos.z.numpy()], 1)
    v = np.stack([d.x.numpy(), d.y.numpy(), d.z.numpy()], 1)
    oc = p.astype(np.float64) - c
    v = v.astype(np.float64)
    a = (v * v).sum(1)
    b = (v * oc).sum(1)
    disc = b * b - a * ((oc * oc).sum(1) - r * r)
    sq = np.sqrt(np.maximum(disc, 0.0))
    dd = dist.numpy().astype(np.float64)
    near = lambda t: np.abs(t - dd) <= 1e-5 * dd
    return (((disc >= 0) & (near((-b - sq) / a) | near((-b + sq) / a)))
            | (np.abs(disc) <= 1e-6 * b * b))


def test_stage3_visibility_bits_on_identical_inputs(stage3_queries):
    """Every shadow query of the first pass (2 lights x 2x2 samples), the
    same float32 rays through both packages' scene_intersect: the valid
    and shape-id bits agree in every lane op by op, and in every lane
    outside the knife band against the jitted reference."""
    tsd, jsd, hit, pos, _, rays = stage3_queries
    n = pos.x.shape[0]
    jitted = jax.jit(lambda o, d, tmax: jtrace.scene_intersect(
        jsd, o, d, jnp.zeros(n, jnp.float32), 1e-5, tmax))
    lit = hit.valid.numpy()
    flipped = 0
    for li, tl, dist in rays:
        got = ttrace.scene_intersect(tsd, pos, tl, 0.0, 1e-5, dist)
        args = (_jv(pos), _jv(tl), jnp.asarray(dist.numpy()))
        eager = jtrace.scene_intersect(jsd, args[0], args[1],
                                       jnp.zeros(n, jnp.float32), 1e-5,
                                       args[2])
        np.testing.assert_array_equal(got.valid.numpy()[lit],
                                      np.asarray(eager.valid)[lit])
        np.testing.assert_array_equal(got.shape_id.numpy()[lit],
                                      np.asarray(eager.shape_id)[lit])
        fused = jitted(*args)
        differ = (got.valid.numpy() != np.asarray(fused.valid)) & lit
        if tsd.light_kinds_host[li] == 0:  # rect light: no knife at tmax
            assert not differ.any()
            continue
        band = _knife_band(tsd, li, pos, tl, dist)
        assert not (differ & ~band).any(), int((differ & ~band).sum())
        flipped += int(differ.sum())
    assert flipped > 0  # the knife edge is real: the fused form flips bits


def test_material_shade_on_identical_inputs(stage3_queries):
    tsd, jsd, hit, _, d, rays = stage3_queries
    lit = hit.valid.numpy()
    assert (hit.mat.numpy()[lit] == 2).sum() > 50  # lanes on the phong sphere
    for _, tl, _ in rays:
        got = tint._material_shade(tsd, hit.mat, hit.normal, d, tl)
        ref = jint._material_shade(jsd, jnp.asarray(hit.mat.numpy()),
                                   _jv(hit.normal), _jv(d), _jv(tl))
        for c in "xyz":
            np.testing.assert_allclose(getattr(got, c).numpy()[lit],
                                       np.asarray(getattr(ref, c))[lit],
                                       rtol=4e-6, atol=1e-30)
