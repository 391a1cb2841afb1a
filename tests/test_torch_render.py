"""Port parity: the stage-6 slice end to end on the CPU.

``stage6_scene`` with the procedural bumpy stand-in at n=8 (768 mesh
triangles plus the inline box), compiled by each package: the reference
with the main path's kernel settings (traversal='pallas' in interpret
mode, traverse_mt='bw_closest'), the port with its defaults.

  * scene_intersect / scene_occluded on 512 seeded rays: the checks of
    test_pallas_scene.py (identical hit, shape and material; t to 1e-5
    relative; normals to 1e-5);
  * render_path at 32x32, one sample, depth 3: relative RMSE <= 0.5%
    against the reference render (the rule of test_golden_path.py),
    issued-query counts within 0.1%, no NaN or negative pixel.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rayito_tpu.models import demo as jdemo
from rayito_tpu.models.camera import PerspectiveCamera as JCam
from rayito_tpu.ops.vec3 import V3 as JV3
from rayito_tpu.render import pathtracer as jpath
from rayito_tpu.render import trace as jtrace
from rayito_tpu.utils.config import RenderConfig as JConfig
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
from rayito_tpu_torch.ops.vec3 import V3 as TV3
from rayito_tpu_torch.render import pathtracer as tpath
from rayito_tpu_torch.render import trace as ttrace
from rayito_tpu_torch.utils.config import RenderConfig as TConfig
from rayito_tpu_torch.utils.image import diagnose

JAX_COMPILE = dict(traversal="pallas", traverse_mt="bw_closest",
                   tiny_fold=False)
N_RAYS = 512


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("obj") / "bumpy8.obj")
    tdemo.write_bumpy_standin(path, n=8)
    return (jdemo.stage6_scene(path).compile(**JAX_COMPILE),
            tdemo.stage6_scene(path).compile("cpu"))


def _rays(seed):
    """Origins around the stage-6 camera aimed at the mesh and the box."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-4.0, 4.0, (N_RAYS, 3)).astype(np.float32)
    o[:, 1] += 4.0
    o[:, 2] += 10.0
    tgt = rs.normal(0.0, 1.5, (N_RAYS, 3)).astype(np.float32)
    tgt[: N_RAYS // 2, 1] -= 1.5  # half toward the box and the floor
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _both_v3(a):
    return (JV3(*(jnp.asarray(a[:, k]) for k in range(3))),
            TV3(*(torch.from_numpy(a[:, k].copy()) for k in range(3))))


def test_scene_intersect_parity(scenes):
    js, ts = scenes
    o, d = _rays(11)
    (jo, to), (jd, td) = _both_v3(o), _both_v3(d)
    ref = jtrace.scene_intersect(js, jo, jd, jnp.zeros(N_RAYS), 1e-4,
                                 jnp.full((N_RAYS,), 1e30, jnp.float32))
    got = ttrace.scene_intersect(ts, to, td, None, 1e-4,
                                 torch.full((N_RAYS,), 1e30))
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.shape_id.numpy(),
                                  np.asarray(ref.shape_id))
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(ref.mat))
    mesh_hits = valid & (np.asarray(ref.shape_id) >= ts.mesh_id0)
    assert valid.sum() > N_RAYS // 2 and mesh_hits.sum() > N_RAYS // 16
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(ref.t)[valid],
                               rtol=1e-5)
    for c in "xyz":
        np.testing.assert_allclose(
            getattr(got.normal, c).numpy()[valid],
            np.asarray(getattr(ref.normal, c))[valid], atol=1e-5)
    np.testing.assert_array_equal(got.color_mod.numpy(),
                                  np.asarray(ref.color_mod))


def test_scene_occluded_parity(scenes):
    js, ts = scenes
    o, d = _rays(23)
    (jo, to), (jd, td) = _both_v3(o), _both_v3(d)
    tmax = np.random.default_rng(24).uniform(2.0, 14.0, N_RAYS)
    tmax = tmax.astype(np.float32)
    ref, _ = jtrace.scene_occluded(js, jo, jd, jnp.zeros(N_RAYS), 1e-4,
                                   jnp.asarray(tmax))
    got, _ = ttrace.scene_occluded(ts, to, td, None, 1e-4,
                                   torch.from_numpy(tmax))
    ref = np.asarray(ref)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert N_RAYS // 8 < ref.sum() < N_RAYS - N_RAYS // 8


@pytest.fixture(scope="module")
def renders(scenes):
    js, ts = scenes
    kw = dict(width=32, height=32, pixel_samples=1, light_samples=1,
              max_depth=3, aspect_correction=True)
    cam = dict(focal_distance=16.0, lens_radius=0.0)
    j_img, _, j_q = jpath.render_path_with_stats(
        js, JConfig(**kw), JCam.make(30.0, *jdemo.STAGE6_CAMERA, **cam))
    t_img, _, t_q = tpath.render_path_with_stats(
        ts, TConfig(**kw), TCam.make(30.0, *tdemo.STAGE6_CAMERA, **cam))
    return np.asarray(j_img, np.float32), int(j_q), t_img, int(t_q)


def test_render_path_matches_reference(renders):
    j_img, _, t_img, _ = renders
    assert t_img.shape == j_img.shape == (32, 32, 3)
    err = float(np.sqrt(np.mean((t_img - j_img) ** 2))
                / max(np.sqrt(np.mean(j_img ** 2)), 1e-20))
    assert err <= 0.005, f"relative RMSE {err:.4%} > 0.5%"
    assert j_img.max() > 0.0


def test_render_path_queries_and_diagnostics(renders):
    _, j_q, t_img, t_q = renders
    assert abs(t_q - j_q) <= 0.001 * j_q, (t_q, j_q)
    # three bounces of 1024 camera lanes, plus shadow queries
    assert t_q > 1024
    diag = diagnose(t_img)
    assert diag["nan_pixels"] == 0 and diag["negative_pixels"] == 0
    assert np.isfinite(t_img).all()
