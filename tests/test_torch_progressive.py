"""Port parity: progressive rendering with checkpoint/resume, and the
frame's lanes sharded over several devices.

  * a render interrupted after its first chunks and resumed from its
    checkpoint equals the uninterrupted render bit for bit (the case of
    test_progressive_cli.py);
  * a checkpoint whose digest differs (another seed; one written by the
    JAX package) is refused, and the render starts fresh;
  * the progressive render equals render_path_with_stats bit for bit,
    unbanded and in row bands, with the same issued-query count;
  * the port's progressive render against the JAX package's on stage 5 at
    32x24 within 0.5% relative RMSE;
  * the on_preview feed (the case of test_viewer.py);
  * sharded over [cpu] * n for n = 1, 2, 3: the unsharded render's bits,
    also with a ragged tail of padding lanes, and a checkpoint written
    sharded resumed unsharded.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from rayito_tpu.models import demo as jdemo
from rayito_tpu.models.camera import PerspectiveCamera as JCam
from rayito_tpu.render import progressive as jprog
from rayito_tpu.utils.config import RenderConfig as JConfig
from rayito_tpu_torch import DiffuseMaterial
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
from rayito_tpu_torch.parallel import sharding as tshard
from rayito_tpu_torch.render import pathtracer as tpath
from rayito_tpu_torch.render import progressive as tprog
from rayito_tpu_torch.utils.config import RenderConfig as TConfig

CPU = torch.device("cpu")


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / max(np.sqrt(np.mean(b ** 2)), 1e-20))


@pytest.fixture(scope="module")
def stage5():
    return (tdemo.stage5_scene().compile("cpu"),
            TCam.make(30.0, *tdemo.STAGE5_CAMERA))


@pytest.fixture(scope="module")
def boxed():
    """Stage 5 with the inline box mesh: the traversal's plain versions
    run in every render (test_sharding.py's scene). 41 x 23 x 4 = 3,772
    lanes: not a multiple of 3."""
    b = tdemo.stage5_scene()
    b.add(tdemo.inline_box_mesh(DiffuseMaterial((0.8, 0.3, 0.1))))
    return (b.compile("cpu"),
            TCam.make(30.0, (0.0, 5.0, 15.0), (0.0, 0.0, 0.0),
                      (0.0, 1.0, 0.0)),
            TConfig(width=41, height=23, pixel_samples=2, light_samples=1,
                    max_depth=3))


def test_checkpoint_resume_bit_identical(stage5, tmp_path):
    scene, cam = stage5
    cfg = TConfig(width=32, height=24, pixel_samples=4, light_samples=1,
                  max_depth=2, max_rays_per_pass=32 * 24 * 4)
    ck = str(tmp_path / "ck.npz")
    img_full, stats = tprog.render_progressive(scene, cfg, cam)
    assert stats.samples_done == 16 and stats.rays_traced > 0

    def interrupt(st):
        if st.samples_done >= 8:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        tprog.render_progressive(scene, cfg, cam, checkpoint_path=ck,
                                 on_progress=interrupt)
    assert os.path.exists(ck)
    with np.load(ck) as saved:
        assert sorted(saved.files) == ["acc", "digest", "samples_done",
                                       "seed", "spp_total"]
        assert int(saved["samples_done"]) == 8
    img_res, st = tprog.render_progressive(scene, cfg, cam,
                                           checkpoint_path=ck)
    np.testing.assert_array_equal(img_full, img_res)
    assert st.samples_done == 16


def test_digest_mismatch_starts_fresh(stage5, tmp_path, capsys):
    scene, cam = stage5
    cfg = TConfig(width=16, height=12, pixel_samples=2, light_samples=1,
                  max_depth=1)
    ck = str(tmp_path / "ck.npz")
    img, _ = tprog.render_progressive(scene, cfg, cam, checkpoint_path=ck)
    cfg2 = dataclasses.replace(cfg, seed=99)
    fresh, _ = tprog.render_progressive(scene, cfg2, cam)
    capsys.readouterr()
    img2, stats2 = tprog.render_progressive(scene, cfg2, cam,
                                            checkpoint_path=ck)
    assert "starting fresh" in capsys.readouterr().err
    assert stats2.samples_done == 4  # every sample rendered anew
    np.testing.assert_array_equal(img2, fresh)
    assert not np.array_equal(img2, img)


STAGE5_KW = dict(width=32, height=24, pixel_samples=2, light_samples=1,
                 max_depth=3, seed=1)


@pytest.fixture(scope="module")
def jax_stage5(tmp_path_factory):
    """The JAX package's progressive stage-5 render and its checkpoint."""
    ck = str(tmp_path_factory.mktemp("jax") / "jax.npz")
    img, stats = jprog.render_progressive(
        jdemo.stage5_scene().compile(traversal="pallas", tiny_fold=False),
        JConfig(**STAGE5_KW), JCam.make(30.0, *jdemo.STAGE5_CAMERA),
        checkpoint_path=ck)
    return np.asarray(img, np.float32), stats, ck


def test_checkpoint_of_the_jax_package_is_refused(stage5, jax_stage5,
                                                  capsys):
    """The reference's digest hashes its jax tree leaves; the port's hashes
    its own tensors, so a reference checkpoint never resumes here."""
    scene, cam = stage5
    ck = jax_stage5[2]
    capsys.readouterr()
    img, stats = tprog.render_progressive(scene, TConfig(**STAGE5_KW), cam,
                                          checkpoint_path=ck)
    assert "starting fresh" in capsys.readouterr().err
    assert stats.samples_done == 4
    np.testing.assert_array_equal(
        img, tprog.render_progressive(scene, TConfig(**STAGE5_KW), cam)[0])


def test_digest_covers_scene_camera_and_config(stage5):
    scene, cam = stage5
    cfg = TConfig(width=16, height=12)
    d = tprog.render_inputs_digest(scene, cfg, cam)
    assert d == tprog.render_inputs_digest(scene, cfg, cam)
    assert d != tprog.render_inputs_digest(
        scene, cfg, TCam.make(31.0, *tdemo.STAGE5_CAMERA))
    assert d != tprog.render_inputs_digest(
        scene, dataclasses.replace(cfg, max_depth=4), cam)
    moved = dataclasses.replace(scene, sph_radius=scene.sph_radius * 2)
    assert d != tprog.render_inputs_digest(moved, cfg, cam)


@pytest.mark.parametrize("budget", [41 * 23 * 4, 41 * 10],
                         ids=["unbanded", "banded"])
def test_progressive_equals_render_path_with_stats(boxed, budget):
    """41x23 at 4 spp: one launch of all samples, or 10-row bands per
    sample (the last band shifted up and cropped)."""
    scene, cam, cfg = boxed
    cfg = dataclasses.replace(cfg, max_rays_per_pass=budget)
    ref, _, q_ref = tpath.render_path_with_stats(scene, cfg, cam)
    img, stats = tprog.render_progressive(scene, cfg, cam)
    np.testing.assert_array_equal(img, ref)
    assert stats.rays_traced == q_ref
    assert img.max() > 0.0


def test_progressive_matches_reference_on_stage5(stage5, jax_stage5):
    scene, cam = stage5
    j_img, j_st, _ = jax_stage5
    t_img, t_st = tprog.render_progressive(scene, TConfig(**STAGE5_KW), cam)
    err = _rel_rmse(t_img, j_img)
    assert err <= 0.005, f"relative RMSE {err:.4%} > 0.5%"
    assert t_st.samples_done == j_st.samples_done == 4
    assert abs(t_st.rays_traced - j_st.rays_traced) <= 0.001 * j_st.rays_traced


def test_on_preview_feed():
    """render_progressive drives on_preview with the running mean image
    after every chunk (the viewer's feed)."""
    import rayito_tpu_torch as rt

    b = rt.Scene()
    b.add(rt.Plane((0, -1, 0), (0, 1, 0), rt.DiffuseMaterial((0.7, 0.7, 0.7))))
    b.add(rt.RectangleLight((-1, 4, -1), (2, 0, 0), (0, 0, 2),
                            (1.0, 1.0, 1.0), 4.0))
    cam = TCam.make(40.0, (0, 2, 6), (0, 0, 0), (0, 1, 0))
    cfg = TConfig(width=8, height=6, pixel_samples=2, light_samples=1,
                  max_depth=2, max_rays_per_pass=8 * 6)
    seen = []
    img, stats = tprog.render_progressive(
        b.compile("cpu"), cfg, cam,
        on_preview=lambda im, st: seen.append((im.copy(), st.samples_done)))
    assert [s for _, s in seen] == [1, 2, 3, 4]
    np.testing.assert_allclose(seen[-1][0], img, rtol=1e-6)
    assert seen[0][0].shape == (6, 8, 3) and seen[0][0].max() > 0.0


@pytest.mark.parametrize("n_dev", [1, 2, 3])
def test_sharded_equals_unsharded(boxed, n_dev):
    """3,772 lanes over n CPU devices: one launch, then a 400-lane budget
    per device (launches of 400 n lanes; on three devices a 172-lane tail
    padded with two inactive lanes): the unsharded bits and query count
    every time."""
    scene, cam, cfg = boxed
    ref, _, q_ref = tpath.render_path_with_stats(scene, cfg, cam)
    mesh = tshard.make_mesh([CPU] * n_dev)
    for budget in (cfg.max_rays_per_pass, 400):
        small = dataclasses.replace(cfg, max_rays_per_pass=budget)
        img, ovf, q = tshard.render_path_sharded_with_stats(scene, small, cam,
                                                            mesh)
        np.testing.assert_array_equal(img, ref)
        assert (ovf, q) == (0, q_ref)
    np.testing.assert_array_equal(
        tshard.render_path_sharded(scene, small, cam, mesh), ref)


def test_sharded_lane_layout():
    """Lanes 5-13 of a 4x3 frame, then two padding lanes: pixel and
    sample 0, inactive."""
    px, py, si, active = tshard._lane_pixel_arrays(5, 14, 4, 12, 11)
    assert px.tolist() == [1, 2, 3, 0, 1, 2, 3, 0, 1, 0, 0]
    assert py.tolist() == [1, 1, 1, 2, 2, 2, 2, 0, 0, 0, 0]
    assert si.tolist() == [0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0]
    assert active.tolist() == [True] * 9 + [False] * 2
    assert tshard.make_mesh(["cpu", "cpu"]) == [CPU, CPU]


def test_sharded_checkpoint_resumes_unsharded(boxed, tmp_path):
    """Interrupted after the first chunk on three devices, resumed on
    none: the uninterrupted render's bits (the digest covers the render
    inputs, not the execution layout)."""
    scene, cam, cfg = boxed
    small = dataclasses.replace(cfg, max_rays_per_pass=41 * 23 // 3 + 1)
    ref = tprog.render_progressive(scene, small, cam)[0]
    ck = str(tmp_path / "sharded.npz")

    def interrupt(st):
        raise KeyboardInterrupt

    mesh = tshard.make_mesh([CPU] * 3)
    with pytest.raises(KeyboardInterrupt):
        tprog.render_progressive(scene, small, cam, checkpoint_path=ck,
                                 on_progress=interrupt, mesh=mesh)
    with np.load(ck) as saved:
        assert int(saved["samples_done"]) == 1
    img, st = tprog.render_progressive(scene, small, cam, checkpoint_path=ck)
    assert st.samples_done == 4
    np.testing.assert_array_equal(img, ref)
    np.testing.assert_array_equal(
        tprog.render_progressive(scene, small, cam, mesh=mesh)[0], ref)
