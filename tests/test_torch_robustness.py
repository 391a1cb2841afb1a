"""Shape-polymorphism and degenerate-input probes of the port, on the CPU.

The twin of ``tests/test_robustness.py``: the port pads wavefronts, chunks
samples and row bands, and draws every sample through per-lane streams;
each has off-by-one surface. These tests render odd resolutions, a 1x1
frame and an EMPTY scene end to end through the port's public API and
require finite, correctly shaped output; a frame cut into row bands whose
height does not divide the frame's must equal the same frame in one
launch, bit for bit. On the card ``chip_smoke.py`` captures and replays
the same kinds of pass (one lane, no mesh and no light, 'xla' below 256
lanes).
"""

import dataclasses

import numpy as np
import pytest

import rayito_tpu_torch as tt
from rayito_tpu_torch.models.camera import PerspectiveCamera
from rayito_tpu_torch.render.integrator import render_color
from rayito_tpu_torch.render.pathtracer import render_path
from rayito_tpu_torch.utils.config import RenderConfig


def _cam():
    return PerspectiveCamera.make(
        45.0, (0.0, 5.0, 15.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)
    )


def _tiny_scene():
    s = tt.Scene()
    s.add(tt.Plane((0, -2, 0), (0, 1, 0), tt.DiffuseMaterial((0.9, 0.9, 1.0))))
    s.add(tt.RectangleLight((-2.5, 4.0, -2.5), (5.0, 0.0, 0.0),
                            (0.0, 0.0, 5.0), (1.0, 1.0, 1.0), 1.0))
    return s.compile("cpu")


@pytest.mark.parametrize("w, h", [(17, 13), (1, 1), (3, 64)])
def test_odd_resolutions_path_trace(w, h):
    cfg = RenderConfig(width=w, height=h, pixel_samples=1, light_samples=1,
                       max_depth=2)
    img = render_path(_tiny_scene(), cfg, _cam())
    assert img.shape == (h, w, 3)
    assert np.isfinite(img).all()
    assert (img >= 0).all()
    assert img.max() > 0  # the plane is lit


def test_odd_resolution_banded_path():
    """The row-band branch (n_pix > max_rays_per_pass) at a height that
    the band does not divide (band 7, 23 = 3 * 7 + 2): the shifted last
    band overlaps correctly, bit for bit against one launch."""
    scene = _tiny_scene()
    cfg = RenderConfig(width=32, height=23, pixel_samples=1,
                       light_samples=1, max_depth=2,
                       max_rays_per_pass=32 * 7)
    a = render_path(scene, cfg, _cam())
    assert a.shape == (23, 32, 3)
    assert np.isfinite(a).all()
    one = dataclasses.replace(cfg, max_rays_per_pass=1 << 20)
    np.testing.assert_array_equal(a, render_path(scene, one, _cam()))


def test_empty_scene_renders_black():
    scene = tt.Scene().compile("cpu")
    cfg = RenderConfig(width=9, height=5, pixel_samples=1, light_samples=1,
                       max_depth=2)
    img = render_path(scene, cfg, _cam())
    assert img.shape == (5, 9, 3)
    np.testing.assert_array_equal(img, np.zeros_like(img))


def test_empty_scene_render_color():
    """The stage-1 render of the empty scene (tuple camera, per its
    signature): finite, and black, since nothing is hit."""
    scene = tt.Scene().compile("cpu")
    img = render_color(
        scene,
        RenderConfig(width=9, height=5, pixel_samples=1, light_samples=1,
                     max_depth=1),
        fov=30.0,
        camera=((0.0, 5.0, 15.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
    )
    assert img.shape == (5, 9, 3)
    assert np.isfinite(img).all()
    np.testing.assert_array_equal(img, np.zeros_like(img))
