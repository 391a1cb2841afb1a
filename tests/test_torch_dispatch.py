"""Port parity: the reference's dispatch layer on the CPU.

On the card every pass of ``rayito_tpu_torch`` is a replayed CUDA graph
(``utils/graphs.py``; held in ``tests/test_torch_cuda.py``); here, on the
CPU, the same pass bodies run eagerly, and these tests hold what the
graphs need and what the dispatch decides against ``rayito_tpu``:

  * ``cmj_permute``'s cycle walk, on the CPU (stopping once every lane
    is in range) and as the card runs it (a fixed count of masked rounds,
    no host read): bit for bit against the reference's ``cmj_permute`` and
    the old walk that looped until every lane was in range (kept here as
    its oracle), for every ``num`` from 1 to 300 and 1,000 and 4,097,
    4,096 lanes x 8 seeded permutations each;
  * the camera as device data: ``make_rays`` at lens radius 0 and 0.2
    against the reference's (``tests/test_torch_ops.py``'s tolerance), and
    bit for bit against the old Python branch at lens radius 0;
  * ``_render_path_frame`` against one ``_render_path_pass`` per launch,
    bit for bit, on the reference's grid (20x16, band 4, rows 0, 8, 4, 12);
  * ``_dispatch_grid``'s groups against the reference's, both packages'
    ``_render_path_frame`` spied on: one group, a ragged ``group=3``
    split, and a frame where the 2^30-query cap binds;
  * ``render_path_with_stats`` against the reference's at 32x32 and 3x3
    pixel samples (a ragged tail chunk; the cycle walk at 9), unbanded and
    in bands with a shifted last band: images within the 0.5% relative
    RMSE of ``tests/test_golden_path.py``, queries 4 (in bands 6) fewer
    than the reference's, the FMA knife edge of three named lanes, pinned
    on the reference's own inputs; and the progressive render's bits and
    queries.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayito_tpu as rt
from rayito_tpu.models.camera import PerspectiveCamera as JCam
from rayito_tpu.ops import rng as jrng
from rayito_tpu.render import pathtracer as jpath
from rayito_tpu.utils.config import RenderConfig as JConfig
import rayito_tpu_torch as tt
from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
from rayito_tpu_torch.ops import rng as trng
from rayito_tpu_torch.ops.vec3 import normalize, sqrt_ieee
from rayito_tpu_torch.ops.warps import uniform_to_uniform_disk
from rayito_tpu_torch.render import pathtracer as tpath

NUMS = list(range(1, 301)) + [1000, 4097]
LANES = 4096
PERMS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread keeps the time steady on
    a loaded CPU (as tests/test_torch_items.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ cmj_permute


def _walk_oracle(i, num, permutation):
    """The port's former cycle walk: masked rounds until no lane is out of
    range, read on the host after each round."""
    i = trng.u32(i)
    permutation = trng.u32(permutation)
    w = (num - 1) & trng.MASK32
    for s in (1, 2, 4, 8, 16):
        w |= w >> s

    def round_fn(x):
        x = x ^ permutation
        x = trng._mul32(x, 0xE170893D)
        x = x ^ (permutation >> 16)
        x = x ^ ((x & w) >> 4)
        x = x ^ (permutation >> 8)
        x = trng._mul32(x, 0x0929EB3F)
        x = x ^ (permutation >> 23)
        x = x ^ ((x & w) >> 1)
        x = trng._mul32_t(x, 1 | (permutation >> 27))
        x = trng._mul32(x, 0x6935FA69)
        x = x ^ ((x & w) >> 11)
        x = trng._mul32(x, 0x74DCB303)
        x = x ^ ((x & w) >> 2)
        x = trng._mul32(x, 0x9E501CC3)
        x = x ^ ((x & w) >> 2)
        x = trng._mul32(x, 0xC860A3DF)
        x = x & w
        return x ^ (x >> 5)

    i = round_fn(i)
    while True:
        out = i >= num
        if not bool(out.any()):
            break
        i = torch.where(out, round_fn(i), i)
    return ((i + permutation) & trng.MASK32) % num


FIXED_LANES = 512  # per permutation, through the card's fixed rounds


@pytest.mark.parametrize(
    "nums", [NUMS[:-1][k::6] for k in range(6)] + [[4097]],
    ids=[f"every6th_from{k + 1}" for k in range(6)] + ["4097"])
def test_cmj_permute_matches_reference_and_walk(nums):
    """Every lane of every (num, permutation) bit for bit against the
    reference and the host-read walk; the result is a permutation of
    [0, num) for each permutation. The CPU's walk stops once every lane is
    in range; the card's runs all (w + 1) - num rounds
    (``fixed_rounds=True``), held here on the first FIXED_LANES lanes of
    each permutation (every distinct input below num = 512). The
    reference runs op by op (its cycle walk is integer arithmetic: the
    same bits as compiled, without 302 compiles)."""
    rs = np.random.default_rng(31)
    for num in nums:
        perms = rs.integers(0, 2**32, PERMS, dtype=np.uint64)
        i = np.tile(np.arange(LANES, dtype=np.uint32) % max(num, 1), PERMS)
        p = np.repeat(perms, LANES).astype(np.uint32)
        with jax.disable_jit():
            ref = np.asarray(jrng.cmj_permute(jnp.asarray(i), num,
                                              jnp.asarray(p)))
        ti, tp = torch.from_numpy(i.astype(np.int64)), torch.from_numpy(
            p.astype(np.int64))
        got = trng.cmj_permute(ti, num, tp).numpy()
        np.testing.assert_array_equal(got, ref.astype(np.int64),
                                      err_msg=f"num {num}")
        np.testing.assert_array_equal(
            got, _walk_oracle(ti, num, tp).numpy(), err_msg=f"num {num}")
        sel = (np.arange(PERMS)[:, None] * LANES
               + np.arange(min(num, FIXED_LANES))[None]).ravel()
        fixed = trng.cmj_permute(ti[sel], num, tp[sel], fixed_rounds=True)
        np.testing.assert_array_equal(fixed.numpy(), got[sel],
                                      err_msg=f"num {num}, fixed rounds")
        if num <= LANES:
            for k in range(PERMS):
                first = got[k * LANES:k * LANES + num]
                assert sorted(first.tolist()) == list(range(num)), num


# ----------------------------------------------------------------- camera


def _branch_rays(cam, xu, yu, lu, lv, tu):
    """The camera's former form: depth of field only behind a Python test
    of the lens radius (with the camera's correctly rounded root)."""
    sx = (xu - 0.5) * cam.tan_fov
    sy = (yu - 0.5) * cam.tan_fov
    direction = normalize(cam.forward + cam.right * sx + cam.up * sy)
    origin = cam.origin.broadcast_to(sx.shape)
    if float(cam.lens_radius) > 0.0:
        hs, vs = uniform_to_uniform_disk(lu, lv)
        hs, vs = hs * cam.lens_radius, vs * cam.lens_radius
        focus = origin + direction * (
            cam.focal_distance * sqrt_ieee(sx * sx + sy * sy + 1.0))
        origin = origin + cam.right * hs + cam.up * vs
        direction = normalize(focus - origin)
    return origin, direction, cam.time(tu).expand(sx.shape)


@pytest.mark.parametrize("lens_radius", [0.0, 0.2])
def test_make_rays_blends_depth_of_field(lens_radius):
    rs = np.random.default_rng(7)
    u = rs.uniform(0.0, 1.0, (5, 2048)).astype(np.float32)
    args = dict(focal_distance=12.0, lens_radius=lens_radius,
                shutter_open=0.25, shutter_close=0.75)
    spec = ((-2.0, 5.0, 15.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    jo, jd, jt = JCam.make(35.0, *spec, **args).make_rays(
        *(jnp.asarray(c) for c in u))
    cam = TCam.make(35.0, *spec, **args)
    tu = [torch.from_numpy(c.copy()) for c in u]
    o, d, t = cam.make_rays(*tu)
    tol = dict(rtol=1e-6, atol=1e-6)  # test_torch_ops.py's test_camera_rays
    for c in "xyz":
        np.testing.assert_allclose(getattr(o, c).numpy(),
                                   np.asarray(getattr(jo, c)), **tol)
        np.testing.assert_allclose(getattr(d, c).numpy(),
                                   np.asarray(getattr(jd, c)), **tol)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), **tol)
    bo, bd, bt = _branch_rays(cam, *tu)
    for got, want in ((o, bo), (d, bd)):
        for c in "xyz":
            assert torch.equal(getattr(got, c), getattr(want, c))
    assert torch.equal(t, bt)
    # the lens moves the origins only where it has a radius
    assert bool((o.x == cam.origin.x).all()) == (lens_radius == 0.0)


def test_camera_flat_round_trip():
    cam = TCam.make(35.0, (-2.0, 5.0, 15.0), (0.0, 0.0, 0.0),
                    (0.0, 1.0, 0.0), focal_distance=12.0, lens_radius=0.2,
                    shutter_open=0.25, shutter_close=0.75)
    flat = cam.flat()
    assert flat.shape == (17,) and flat.dtype == torch.float32
    back = TCam.from_flat(flat.clone())
    assert torch.equal(back.flat(), flat)
    assert back.to("cpu") is back and cam.device == torch.device("cpu")


# ---------------------------------------------------------------- dispatch


def _lit(pkg):
    """test_pathtracer.py's grid scene: a plane, a sphere, a rect light."""
    s = pkg.Scene()
    s.add(pkg.Plane((0, -2, 0), (0, 1, 0),
                    pkg.DiffuseMaterial((0.9, 0.8, 0.7))))
    s.add(pkg.Sphere((0.5, -1.0, 0.0), 1.0,
                     pkg.DiffuseMaterial((0.2, 0.6, 0.9))))
    s.add(pkg.RectangleLight((-2.5, 4.0, -2.5), (5.0, 0.0, 0.0),
                             (0.0, 0.0, 5.0), (1.0, 1.0, 1.0), 2.0))
    return s


def _shapes(pkg):
    """The lit scene with a glossy and a mirror sphere: every BRDF kind
    (the mirror's Dirac chains included)."""
    s = _lit(pkg)
    s.add(pkg.Sphere((-2.0, -1.2, 1.0), 0.8,
                     pkg.GlossyMaterial((0.3, 0.9, 0.3), 0.2)))
    s.add(pkg.Sphere((2.2, -1.3, -1.0), 0.7,
                     pkg.ReflectionMaterial((0.9, 0.9, 0.9))))
    return s


CAM = ((0.0, 5.0, 15.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))


def test_render_path_frame_equals_per_pass_loop():
    scene = _lit(tt).compile("cpu")
    cam = TCam.make(45.0, *CAM)
    cfg = tt.RenderConfig(width=20, height=16, pixel_samples=2,
                          light_samples=1, max_depth=2)
    band = 4
    si_mat = [[0, 1], [0, 1], [2, 3], [2, 3]]
    row0s = [0, 8, 4, 12]  # deliberately not sorted
    imgs, ovf, q = tpath._render_path_frame(scene, cfg, cam, si_mat, row0s,
                                            band)
    assert imgs.shape == (4, band, 20, 3) and ovf == 0
    q_s = 0
    for k in range(4):
        img, o1, q1 = tpath._render_path_pass(scene, cfg, cam, si_mat[k],
                                              row0s[k], band)
        assert torch.equal(imgs[k], img), k
        q_s += int(q1)
    assert int(q) == q_s > 0
    g_imgs, g_ovf, g_q = tpath._dispatch_grid(
        scene, cfg, cam, torch.tensor(si_mat, dtype=torch.int32),
        torch.tensor(row0s, dtype=torch.int32), band, band, group=3)
    np.testing.assert_array_equal(g_imgs, imgs.numpy())
    assert (g_ovf, g_q) == (0, q_s)


def _spy(monkeypatch, module, calls, torch_side):
    """Replace ``module._render_path_frame`` by a recorder of the launch
    grid slices it is handed (first sample index and first row of every
    launch), returning zero images."""
    def frame(scene, config, camera, si_mat, row0s, rows=0):
        si = np.asarray(si_mat)
        calls.append((si[:, 0].tolist(), np.asarray(row0s).tolist()))
        shape = (si.shape[0], rows or config.height, config.width, 3)
        if torch_side:
            return torch.zeros(shape), 0, torch.zeros((), dtype=torch.int64)
        return jnp.zeros(shape, jnp.float32), jnp.int32(0), jnp.int32(0)

    monkeypatch.setattr(module, "_render_path_frame", frame)


@pytest.mark.parametrize("case", ["one_group", "group3", "query_cap"])
def test_dispatch_grid_groups_match_reference(monkeypatch, case):
    kw = dict(width=20, height=16, pixel_samples=2, light_samples=1,
              max_depth=2)
    group, n_launch = None, 7
    if case == "group3":
        group = 3
    elif case == "query_cap":
        # ~1.1e9 worst-case queries per launch: (1 << 30) // q_est = 0,
        # so one launch per group
        kw.update(max_rays_per_pass=1 << 22, max_depth=8, light_samples=4)
        n_launch = 5
    si = np.arange(2 * n_launch, dtype=np.int32).reshape(n_launch, 2)
    r0 = (np.arange(n_launch, dtype=np.int32) * 3) % 16
    calls = {"ref": [], "port": []}
    _spy(monkeypatch, jpath, calls["ref"], False)
    _spy(monkeypatch, tpath, calls["port"], True)
    jpath._dispatch_grid(None, JConfig(**kw), None, jnp.asarray(si),
                         jnp.asarray(r0), 4, 4, group=group)
    imgs, ovf, q = tpath._dispatch_grid(None, tt.RenderConfig(**kw), None,
                                        torch.from_numpy(si),
                                        torch.from_numpy(r0), 4, 4,
                                        group=group)
    assert calls["port"] == calls["ref"]
    n_groups = {"one_group": 1, "group3": 3, "query_cap": 5}[case]
    assert len(calls["ref"]) == n_groups
    assert imgs.shape == (n_launch, 4, 20, 3) and (ovf, q) == (0, 0)


@pytest.mark.parametrize("banded", [False, True], ids=["chunks", "bands"])
def test_render_path_with_stats_matches_reference(banded):
    """32x32 at 3x3 pixel samples: unbanded, 4 samples per launch (two full
    chunks through the grid, a ragged tail of one); banded, 12-row bands
    (the third shifted up to row 20 and cropped), 27 launches."""
    kw = dict(width=32, height=32, pixel_samples=3, light_samples=1,
              max_depth=3, max_rays_per_pass=32 * 12 if banded else 4096)
    jimg, jovf, jq = jpath.render_path_with_stats(
        _shapes(rt).compile(), JConfig(**kw), JCam.make(45.0, *CAM))
    timg, tovf, tq = tpath.render_path_with_stats(
        _shapes(tt).compile("cpu"), tt.RenderConfig(**kw),
        TCam.make(45.0, *CAM))
    jimg = np.asarray(jimg, np.float32)
    err = float(np.sqrt(np.mean((timg - jimg) ** 2))
                / np.sqrt(np.mean(jimg ** 2)))
    assert err <= 0.005, f"relative RMSE {err:.4%} > 0.5%"
    # the FMA knife edge of three lanes (test_nine_spp_query_gap_lanes):
    # 25,387 queries against 25,391; in bands the row-20 lane is traced
    # twice (the shifted band's overlap), 29,133 against 29,139
    assert int(jq) - tq == (6 if banded else 4) and tq > 0
    assert tovf == int(jovf) == 0
    assert np.isfinite(timg).all() and timg.min() >= 0.0 and timg.max() > 0


def test_nine_spp_query_gap_lanes():
    """The 9-spp frame above issues 4 queries fewer than the reference's,
    on three lanes of 9,216 (sample 0 pixel (11, 20), sample 3 (12, 17),
    sample 4 (12, 18)), all from XLA's FMA contraction. The port's camera
    rays and bounce-0 sphere hits equal the reference's run op by op bit
    for bit; the jitted reference's camera direction is one ulp off on
    lanes 651 and 4684, and its hit on a sphere's grazing edge (the
    discriminant cancels) is 9e-6 to 4e-5 off on lanes 3628 and 4684 (how
    far moves with the shape of XLA's launch). One package's continuation ray then leaves from just inside the
    sphere and re-enters it at t = 1.2e-4 to 1.7e-4, past the 1e-4
    epsilon. Per lane, in the lanes' own 64-lane launch: the reference
    5, 5, 4 queries; the port on its own rays 3, 4, 3; on the reference's
    camera rays 5, 4, 3 (lane 651's whole gap was its camera ray)."""
    from rayito_tpu.render import trace as jtrace
    from rayito_tpu_torch.ops.vec3 import V3 as TV3
    from rayito_tpu_torch.render import trace as ttrace

    kw = dict(width=32, height=32, pixel_samples=3, light_samples=1,
              max_depth=3, max_rays_per_pass=4096)
    jcfg, tcfg = JConfig(**kw), tt.RenderConfig(**kw)
    jsd, tsd = _shapes(rt).compile(), _shapes(tt).compile("cpu")
    jcam, tcam = JCam.make(45.0, *CAM), TCam.make(45.0, *CAM)
    lanes = np.array([651, 3628, 4684])

    def grid(sel):
        return ((sel % 32).astype(np.int32), (sel % 1024 // 32).astype(
            np.int32), (sel // 1024).astype(np.int32))

    def j_rays(camera, px, py, si):
        """The reference pass's camera rays (pathtracer.py:427-443)."""
        ps, seed = jcfg.pixel_samples, np.uint32(jcfg.seed)
        pxu, pyu = px.astype(jnp.uint32), py.astype(jnp.uint32)
        jx, jy = jpath._subpixel_jitter(jcfg, px, py, si, ps, ps)
        xu, yu = jpath.screen_uv(jcfg, px, py, jx, jy)
        lu, lv = jrng.cmj_sample_2d(si.astype(jnp.uint32), ps, ps,
                                    jrng.hash_combine(
                                        pxu, pyu, jrng.PURPOSE_LENS, seed))
        tu = jrng.cmj_sample_1d(si.astype(jnp.uint32), ps * ps,
                                jrng.hash_combine(
                                    pxu, pyu, jrng.PURPOSE_TIME, seed))
        return camera.make_rays(xu, yu, lu, lv, tu)

    def bits(v):
        return np.stack([np.asarray(c, np.float32).view(np.int32)
                         for c in (v.x, v.y, v.z)])

    def t_of(a):
        return torch.from_numpy(np.asarray(a).copy())

    # camera rays: the port's equal the reference's op by op
    px, py, si = (jnp.asarray(a) for a in grid(lanes))
    jo, jd, jt = jax.jit(j_rays)(jcam, px, py, si)
    with jax.disable_jit():
        _, dd, _ = j_rays(jcam, px, py, si)
    _, td, _ = tpath._camera_rays(tcfg, tcam, *(t_of(a) for a in grid(
        lanes)))
    np.testing.assert_array_equal(bits(td), bits(dd))
    assert (bits(dd) != bits(jd)).any(axis=0).tolist() == [True, False,
                                                          True]
    # bounce-0 hits on the jitted reference's rays: the same, op by op
    tmax = jnp.full((3,), 1e30, jnp.float32)
    hj = jax.jit(lambda sd: jtrace.scene_intersect(
        sd, jo, jd, jt, jcfg.ray_tmin, tmax))(jsd)
    with jax.disable_jit():
        hd = jtrace.scene_intersect(jsd, jo, jd, jt, jcfg.ray_tmin, tmax)
    ht = ttrace.scene_intersect(
        tsd, TV3(*(t_of(c) for c in (jo.x, jo.y, jo.z))),
        TV3(*(t_of(c) for c in (jd.x, jd.y, jd.z))), t_of(jt),
        tcfg.ray_tmin, 1e30)
    np.testing.assert_array_equal(ht.t.numpy().view(np.int32),
                                  np.asarray(hd.t).view(np.int32))
    np.testing.assert_array_equal(bits(ht.normal), bits(hd.normal))
    gap = np.abs(np.asarray(hj.t) - np.asarray(hd.t))
    assert gap[0] == 0.0 and (gap[1:] > 5e-6).all(), gap  # ulp 9.5e-7

    # per-lane queries in the lanes' 64-lane launches (active masks)
    def per_lane(count):
        out = []
        for lane in lanes:
            sel = np.arange(lane // 64 * 64, lane // 64 * 64 + 64)
            act = sel == lane
            out.append(count(sel, act))
        return out

    wave = jax.jit(lambda sd, o, d, t, px, py, si, act: jpath.pathtrace_wave(
        sd, jcfg, o, d, t, px, py, si, active=act)[2])

    def ref(sel, act):
        g = [jnp.asarray(a) for a in grid(sel)]
        o, d, t = jax.jit(j_rays)(jcam, *g)
        return int(wave(jsd, o, d, t, *g, jnp.asarray(act)))

    def port(sel, act, own):
        g = [torch.from_numpy(a) for a in grid(sel)]
        if own:
            o, d, t = tpath._camera_rays(tcfg, tcam, *g)
        else:
            o, d, t = jax.jit(j_rays)(jcam, *(jnp.asarray(a)
                                              for a in grid(sel)))
            o, d, t = (TV3(*(t_of(c) for c in (o.x, o.y, o.z))),
                       TV3(*(t_of(c) for c in (d.x, d.y, d.z))), t_of(t))
        return int(tpath.pathtrace_wave(tsd, tcfg, o, d, t, *g,
                                        active=torch.from_numpy(act))[2])

    assert per_lane(ref) == [5, 5, 4]
    assert per_lane(lambda s, a: port(s, a, True)) == [3, 4, 3]
    assert per_lane(lambda s, a: port(s, a, False)) == [5, 4, 3]


def test_banded_render_equals_progressive():
    """The banded grid through _dispatch_grid and the progressive render's
    per-launch passes add the same images in the same order."""
    from rayito_tpu_torch.render import progressive as tprog

    scene = _shapes(tt).compile("cpu")
    cfg = tt.RenderConfig(width=32, height=32, pixel_samples=2,
                          light_samples=1, max_depth=2,
                          max_rays_per_pass=32 * 12)
    cam = TCam.make(45.0, *CAM)
    img, _, q = tpath.render_path_with_stats(scene, cfg, cam)
    pimg, stats = tprog.render_progressive(scene, cfg, cam)
    np.testing.assert_array_equal(img, pimg)
    assert stats.rays_traced == q
    cfg1 = dataclasses.replace(cfg, max_rays_per_pass=4096)
    np.testing.assert_array_equal(
        tpath.render_path_with_stats(scene, cfg1, cam)[0],
        tprog.render_progressive(scene, cfg1, cam)[0])
