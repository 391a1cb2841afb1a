"""Port parity: many shapes of one kind (40 spheres, 40 rects) and many
lights (16) against the JAX package on the CPU.

The scenes are those of the reference's own scale tests, rebuilt from
their seeds by each package from one definition
(``rayito_tpu_torch/models/demo.py``; the reference compiled with
traversal='pallas'): 40 spheres and 40 rect lights, with and without a
two-key translation on every third shape, and 8 rect + 8 sphere lights.

Above 24 shapes or 8 lights the reference rolls a loop over rows; the port
batches the rows of a kind into [rows, N] evaluations and takes the
``argmin``, and evaluates each lane's chosen light from per-lane gathers,
at every count. Checks:

  * against the reference: identical hits, shape ids, materials and
    occlusion bits; t to 2e-4 relative and normals to 6e-3 absolute, the
    reference's own budget between its rolled and unrolled forms;
  * batches of 64 and 16 rows against one row per batch (the fold shape by
    shape), and each lane's chosen light against the per-light functions
    evaluated for every light: everything bit for bit, since each element
    goes through the same float32 operations in both forms;
  * the 16-light render within 0.5% relative RMSE of the reference's;
  * two planted identical shapes resolve to the lower row, also when one
    of the two has a keyed transform and is a batch of its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayito_tpu as rt
from rayito_tpu.models.camera import PerspectiveCamera as JCam
from rayito_tpu.ops.vec3 import V3 as JV3
from rayito_tpu.render import pathtracer as jpath
from rayito_tpu.render import trace as jtrace
from rayito_tpu.utils.config import RenderConfig as JConfig
import rayito_tpu_torch as tt
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
from rayito_tpu_torch.ops.vec3 import V3 as TV3
from rayito_tpu_torch.render import lights as tlights
from rayito_tpu_torch.render import pathtracer as tpath
from rayito_tpu_torch.render import trace as ttrace
from rayito_tpu_torch.utils.config import RenderConfig as TConfig

N = 1024
TMIN = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions' many small ops spin threads on a loaded CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _many_spheres(pkg, motion):
    return tdemo.many_spheres_scene(motion, pkg=pkg)


def _many_rects(pkg, motion):
    return tdemo.many_rects_scene(motion, pkg=pkg)


def _sixteen_lights(pkg):
    return tdemo.sixteen_lights_scene(pkg=pkg)


SCENES = {"spheres": _many_spheres, "rects": _many_rects}


def _rays(n=N, seed=3):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-8, 8, (n, 3)).astype(np.float32)
    o[:, 2] += 14.0
    d = (rs.uniform(-6, 6, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _tv3(a):
    return TV3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                 for k in range(3)))


def _jv3(a):
    return JV3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _port_queries(tsd, o, d, time):
    hit = ttrace.scene_intersect(tsd, _tv3(o), _tv3(d), time, TMIN,
                                 torch.full((len(o),), 1e30))
    occ, _ = ttrace.scene_occluded(tsd, _tv3(o), _tv3(d), time, TMIN,
                                   torch.full((len(o),), 10.0))
    return hit, occ


def _assert_hits_equal(a, b):
    for name in ("t", "valid", "shape_id", "mat", "color_mod"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for c in "xyz":
        assert torch.equal(getattr(a.normal, c), getattr(b.normal, c)), c


@pytest.mark.parametrize("motion", [False, True], ids=["static", "motion"])
@pytest.mark.parametrize("kind", sorted(SCENES))
def test_many_shapes_match_reference(kind, motion):
    jsd = SCENES[kind](rt, motion).compile(traversal="pallas")
    tsd = SCENES[kind](tt, motion).compile("cpu")
    assert max(tsd.n_spheres, tsd.n_rects) == 40
    assert tsd.has_motion == motion
    o, d = _rays()
    jtime = jnp.full((N,), 0.4, jnp.float32)
    ref = jtrace.scene_intersect(jsd, _jv3(o), _jv3(d), jtime, TMIN,
                                 jnp.full((N,), 1e30, jnp.float32))
    ref_occ, _ = jtrace.scene_occluded(jsd, _jv3(o), _jv3(d), jtime, TMIN,
                                       jnp.full((N,), 10.0, jnp.float32))
    got, got_occ = _port_queries(tsd, o, d, torch.full((N,), 0.4))
    valid = np.asarray(ref.valid)
    assert valid.sum() > N // 8
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.shape_id.numpy(),
                                  np.asarray(ref.shape_id))
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(ref.mat))
    np.testing.assert_array_equal(got_occ.numpy(), np.asarray(ref_occ))
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(ref.t)[valid],
                               rtol=2e-4)
    for c in "xyz":
        np.testing.assert_allclose(
            getattr(got.normal, c).numpy()[valid],
            np.asarray(getattr(ref.normal, c))[valid], atol=6e-3)


@pytest.mark.parametrize("motion", [False, True], ids=["static", "motion"])
@pytest.mark.parametrize("kind", sorted(SCENES))
def test_batched_fold_equals_per_shape_fold(kind, motion, monkeypatch):
    """Batches of 64 rows and of 16 (which splits the table) against one
    row per batch, the fold shape by shape: bit for bit."""
    tsd = SCENES[kind](tt, motion).compile("cpu")
    o, d = _rays(seed=4)
    time = torch.from_numpy(
        np.random.default_rng(6).uniform(0, 1, N).astype(np.float32))
    assert ttrace.ROLL_CHUNK == 64
    rolled, rolled_occ = _port_queries(tsd, o, d, time)
    monkeypatch.setattr(ttrace, "ROLL_CHUNK", 16)
    chunked, chunked_occ = _port_queries(tsd, o, d, time)
    monkeypatch.setattr(ttrace, "ROLL_CHUNK", 1)
    plain, plain_occ = _port_queries(tsd, o, d, time)
    assert plain.valid.sum() > N // 8
    assert N // 16 < plain_occ.sum() < N
    for hit, occ in ((rolled, rolled_occ), (chunked, chunked_occ)):
        _assert_hits_equal(hit, plain)
        assert torch.equal(occ, plain_occ)


def _tied_scene(kind):
    """40 shapes; shape X stands twice (row 3 keyed, row 30 in world
    space) and shape Y twice (row 10 in world space, row 35 keyed; a keyed
    row is a batch of its own between two world-space runs). The
    keyed copies carry a constant translation of (1, 0, 0), their local
    geometry shifted back by it; with ray origins and centres on a grid of
    eighths every subtraction is exact, so the copies tie bit for bit."""
    rs = np.random.default_rng(21)
    mat = tt.DiffuseMaterial((0.5, 0.5, 0.5))
    shift = tt.Transform()
    shift.set_translation(0.0, (1.0, 0.0, 0.0))
    shift.set_translation(1.0, (1.0, 0.0, 0.0))

    def shape(pos, keyed):
        local = (pos[0] - 1.0, pos[1], pos[2]) if keyed else pos
        if kind == "spheres":
            s = tt.Sphere(local, 1.0, mat)
        else:
            s = tt.RectangleLight(local, (1.5, 0.0, 0.0), (0.0, 1.5, 0.0),
                                  (1.0, 1.0, 1.0), 1.0)
        if keyed:
            s.transform = shift
        return s

    x_pos, y_pos = (-2.0, 0.5, 0.0), (2.0, 0.5, 0.0)
    planted = {3: (x_pos, True), 30: (x_pos, False),
               10: (y_pos, False), 35: (y_pos, True)}
    b = tt.Scene()
    for i in range(40):
        if i in planted:
            b.add(shape(*planted[i]))
        else:  # far behind the planted ones
            far = (float(rs.integers(-40, 40)) / 8.0,
                   float(rs.integers(-40, 40)) / 8.0, -20.0 - i)
            b.add(shape(far, False))
    return b.compile("cpu"), x_pos, y_pos


@pytest.mark.parametrize("kind", ["rects", "spheres"])
def test_identical_shapes_resolve_to_the_lower_row(kind, monkeypatch):
    tsd, x_pos, y_pos = _tied_scene(kind)
    assert tsd.has_motion
    n = 256
    rs = np.random.default_rng(22)
    o = np.zeros((n, 3), np.float32)
    o[:, 0] = rs.integers(-16, 16, n) / 8.0
    o[:, 1] = rs.integers(0, 16, n) / 8.0
    o[:, 2] = 12.0
    centre = np.where(np.arange(n)[:, None] % 2 == 0, x_pos, y_pos)
    tgt = centre + rs.uniform(0.1, 0.6, (n, 3)) * (1, 1, 0)
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    time = torch.full((n,), 0.5)
    hit, _ = _port_queries(tsd, o, d, time)
    id0 = tsd.sphere_id0 if kind == "spheres" else tsd.rect_id0
    want = torch.where(torch.arange(n) % 2 == 0, id0 + 3, id0 + 10)
    assert hit.valid.all()
    assert torch.equal(hit.shape_id, want.to(torch.int32))
    monkeypatch.setattr(ttrace, "ROLL_CHUNK", 1)
    plain, _ = _port_queries(tsd, o, d, time)
    _assert_hits_equal(hit, plain)


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / max(np.sqrt(np.mean(b ** 2)), 1e-20))


LIGHT_CFG = dict(width=20, height=14, pixel_samples=1, light_samples=1,
                 max_depth=2)
LIGHT_CAM = (40.0, (0, 3, 10), (0, 0, 0), (0, 1, 0))


def test_sixteen_light_render_matches_reference():
    """32x32, depth 2. The pixels that differ are far plane points lit by
    a sphere light: the shadow ray ends on the light's own sphere, and at
    20 to 3000 units the sphere quadratic decides lit or self-shadowed by
    the last bits of t (ROADMAP Queue 3)."""
    jsd = _sixteen_lights(rt).compile(traversal="pallas")
    tsd = _sixteen_lights(tt).compile("cpu")
    assert tsd.n_lights == 16
    cfg = dict(LIGHT_CFG, width=32, height=32)
    j_img, _, j_q = jpath.render_path_with_stats(jsd, JConfig(**cfg),
                                                 JCam.make(*LIGHT_CAM))
    t_img, _, t_q = tpath.render_path_with_stats(tsd, TConfig(**cfg),
                                                 TCam.make(*LIGHT_CAM))
    j_img = np.asarray(j_img, np.float32)
    assert np.isfinite(t_img).all() and j_img.max() > 1e-3
    err = _rel_rmse(t_img, j_img)
    assert err <= 0.005, f"relative RMSE {err:.4%} > 0.5%"
    assert abs(int(t_q) - int(j_q)) <= 0.001 * int(j_q), (t_q, j_q)


@pytest.mark.parametrize("scene", ["sixteen_lights", "forty_rect_lights",
                                   "forty_moving_rect_lights"])
def test_chosen_light_nee_equals_per_light_loop(scene):
    """Each lane's chosen light from per-lane gathers against every light
    evaluated by the per-light functions and selected: sample, analytic
    hit, hit pdf and emitted colour bit for bit. The 40-rect scenes have no
    sphere light (the absent kind's empty table is never touched), and in
    the moving one every third light has a keyed transform and is evaluated
    apart."""
    tsd = {"sixteen_lights": lambda: _sixteen_lights(tt),
           "forty_rect_lights": lambda: _many_rects(tt, False),
           "forty_moving_rect_lights": lambda: _many_rects(tt, True),
           }[scene]().compile("cpu")
    rs = np.random.default_rng(17)
    pos = _tv3(rs.uniform(-6, 6, (N, 3)).astype(np.float32))
    _, d = _rays(seed=18)
    d = _tv3(-d)
    u1, u2, u3, time = (torch.from_numpy(rs.uniform(0, 1, N).astype(np.float32))
                        for _ in range(4))
    t = torch.from_numpy(rs.uniform(0.5, 9.0, N).astype(np.float32))
    light_idx = torch.from_numpy(
        rs.integers(0, tsd.n_lights, N).astype(np.int32))
    emitted = tlights.light_emitted_rolled(tsd, light_idx)
    chosen = (*tlights.sample_chosen_light_rolled(tsd, light_idx, pos, time,
                                                  u1, u2, u3, TMIN),
              *tlights.light_hit_analytic_rolled(tsd, light_idx, pos, d, time,
                                                 TMIN),
              tlights.light_intersect_pdf_rolled(tsd, light_idx, pos, d, t, d,
                                                 time),
              emitted)
    hits = 0
    for li in range(tsd.n_lights):
        per = (*tlights.sample_light(tsd, li, pos, None, time, u1, u2, u3,
                                     TMIN),
               *tlights.light_hit_analytic(tsd, li, pos, d, time, TMIN),
               tlights.light_intersect_pdf(tsd, li, pos, d, t, d, time),
               tlights.light_emitted(tsd, li))
        mine = light_idx == li
        assert mine.any()
        hits += int((per[5] & mine).sum())
        for k, (got, want) in enumerate(zip(chosen, per)):
            pairs = ([(getattr(got, c), getattr(want, c)) for c in "xyz"]
                     if isinstance(got, TV3) else [(got, want)])
            for g, w in pairs:
                np.testing.assert_array_equal(
                    g[mine].numpy(), w.expand(N)[mine].numpy(),
                    err_msg=f"light {li}, result {k}")
    assert hits > 0
