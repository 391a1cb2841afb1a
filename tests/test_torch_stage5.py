"""Port parity: stage 5 (bullseye plane, four spheres, a rect light and a
sphere ShapeLight; no mesh, so no traversal kernel) held to the reference's
committed golden.

  * the port at the golden's configuration (96x64, 2x2 samples, depth 3,
    seed 1, the stage-5 camera at 30 degrees, shutter 0..1) against
    ``tests/goldens/path_stage5.pfm``: relative RMSE <= 0.5%, the rule of
    test_golden_path.py; two renders bit-identical;
  * a 32x32 render against the reference's own: <= 0.5%, query counts
    within 0.1%;
  * the scene's tables bit-identical to the reference's;
  * the port's PFM reader against the reference's.
"""

import os

import numpy as np
import pytest
import torch

from rayito_tpu.models import demo as jdemo
from rayito_tpu.models.camera import PerspectiveCamera as JCam
from rayito_tpu.render import pathtracer as jpath
from rayito_tpu.utils.config import RenderConfig as JConfig
from rayito_tpu.utils.image import read_pfm as j_read_pfm
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
from rayito_tpu_torch.models.scene import ARRAY_FIELDS
from rayito_tpu_torch.render import pathtracer as tpath
from rayito_tpu_torch.render import trace as ttrace
from rayito_tpu_torch.utils.config import RenderConfig as TConfig
from rayito_tpu_torch.utils.image import diagnose, read_pfm

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "path_stage5.pfm")
JAX_COMPILE = dict(traversal="pallas", traverse_mt="bw_closest",
                   tiny_fold=False)


def _kw(width, height, spp):
    return dict(width=width, height=height, pixel_samples=spp,
                light_samples=1, max_depth=3, seed=1)


def _camera(cam_cls, spec):
    return cam_cls.make(30.0, *spec, focal_distance=16.0, lens_radius=0.0,
                        shutter_open=0.0, shutter_close=1.0)


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / max(np.sqrt(np.mean(b ** 2)), 1e-20))


@pytest.fixture(scope="module")
def golden_render():
    tsd = tdemo.stage5_scene().compile("cpu")
    cam = _camera(TCam, tdemo.STAGE5_CAMERA)
    img, _, q = tpath.render_path_with_stats(tsd, TConfig(**_kw(96, 64, 2)),
                                             cam)
    again = tpath.render_path(tsd, TConfig(**_kw(96, 64, 2)), cam)
    return img, int(q), again


def test_stage5_camera_and_scene_match_reference():
    assert tdemo.STAGE5_CAMERA == jdemo.STAGE5_CAMERA
    jsd = jdemo.stage5_scene().compile(**JAX_COMPILE)
    arrays, static = tdemo.stage5_scene().compile_arrays()
    for field in ARRAY_FIELDS:
        ref = np.asarray(getattr(jsd, field))
        assert arrays[field].dtype == ref.dtype, field
        np.testing.assert_array_equal(arrays[field], ref, err_msg=field)
    assert static["light_kinds_host"] == jsd.light_kinds_host == (0, 1)
    assert not static["has_motion"] and static["ktab_xf"] == ()


def test_read_pfm_matches_reference_reader():
    got, ref = read_pfm(GOLDEN), j_read_pfm(GOLDEN)
    assert got.shape == (64, 96, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_stage5_within_half_percent_of_golden(golden_render):
    img, _, _ = golden_render
    golden = read_pfm(GOLDEN)
    assert img.shape == golden.shape
    err = _rel_rmse(img, golden)
    assert err <= 0.005, f"relative RMSE {err:.4%} > 0.5%"
    diag = diagnose(img)
    assert diag["nan_pixels"] == 0 and diag["negative_pixels"] == 0


def test_stage5_two_renders_bit_identical(golden_render):
    img, q, again = golden_render
    np.testing.assert_array_equal(img, again)
    # three bounces of 96 x 64 x 4 camera lanes at most, plus NEE queries
    assert q > 96 * 64 * 4


def test_stage5_calls_no_traversal_wrapper(monkeypatch):
    """No mesh: the render reaches neither the traversal nor the winner-row
    gather, on any device."""
    def refuse(*a, **k):
        raise AssertionError("stage 5 reached a kernel wrapper")

    monkeypatch.setattr(ttrace, "traverse", refuse)
    monkeypatch.setattr(ttrace, "gather_rows_t", refuse)
    img = tpath.render_path(tdemo.stage5_scene().compile("cpu"),
                            TConfig(**_kw(16, 16, 1)),
                            _camera(TCam, tdemo.STAGE5_CAMERA))
    assert img.max() > 0.0


def test_stage5_render_matches_reference_render():
    jsd = jdemo.stage5_scene().compile(**JAX_COMPILE)
    tsd = tdemo.stage5_scene().compile("cpu")
    kw = _kw(32, 32, 1)
    j_img, _, j_q = jpath.render_path_with_stats(
        jsd, JConfig(**kw), _camera(JCam, jdemo.STAGE5_CAMERA))
    t_img, _, t_q = tpath.render_path_with_stats(
        tsd, TConfig(**kw), _camera(TCam, tdemo.STAGE5_CAMERA))
    j_img, j_q, t_q = np.asarray(j_img, np.float32), int(j_q), int(t_q)
    assert t_img.shape == j_img.shape == (32, 32, 3)
    err = _rel_rmse(t_img, j_img)
    assert err <= 0.005, f"relative RMSE {err:.4%} > 0.5%"
    assert j_img.max() > 0.0
    assert abs(t_q - j_q) <= 0.001 * j_q, (t_q, j_q)
    assert torch.isfinite(torch.from_numpy(t_img)).all()
