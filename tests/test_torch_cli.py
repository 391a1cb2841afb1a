"""Port parity: image I/O, the live viewer and the command line.

  * each image writer writes the reference's bytes; read_ppm, tone_map,
    rmse_8bit and diagnostic_colors give the reference's arrays;
  * the viewer cases of test_viewer.py, and encode_png's bytes;
  * apply_knobs coerces as the reference's does;
  * build_scene names the reference's eight scenes with their cameras,
    fields of view and integrators;
  * ``python -m rayito_tpu_torch.cli --device cpu --scene stage1`` in a
    subprocess with no PYTHONPATH writes the PPM that render_color gives
    and imports neither jax nor rayito_tpu; with no card and no
    ``--device cpu`` the CLI exits non-zero, naming the missing card;
  * the CLI's --sharded and --checkpoint runs write the plain run's bytes.
"""

import argparse
import json
import os
import struct
import subprocess
import sys
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from rayito_tpu import cli as jcli
from rayito_tpu.utils import image as jimage
from rayito_tpu.utils import viewer as jviewer
from rayito_tpu_torch import cli as tcli
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.render import integrator as tint
from rayito_tpu_torch.utils import image as timage
from rayito_tpu_torch.utils import viewer as tviewer
from rayito_tpu_torch.utils.config import RenderConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hdr(seed, shape=(7, 5, 3)):
    rs = np.random.default_rng(seed)
    img = rs.normal(0.5, 0.8, shape).astype(np.float32)
    img[0, 0, 0] = np.nan
    img[1, 1] = -0.25
    return img


@pytest.mark.parametrize("writer", ["write_ppm", "write_pfm"])
def test_writers_write_the_reference_bytes(writer, tmp_path):
    img = np.nan_to_num(_hdr(3)) * 37.5
    paths = []
    for mod in (jimage, timage):
        paths.append(str(tmp_path / f"{mod.__name__}.out"))
        getattr(mod, writer)(paths[-1], img)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    if writer == "write_pfm":
        np.testing.assert_array_equal(timage.read_pfm(paths[1]), img)
    else:
        np.testing.assert_array_equal(timage.read_ppm(paths[1]),
                                      jimage.read_ppm(paths[0]))
        np.testing.assert_array_equal(timage.read_ppm(paths[1]),
                                      timage.quantize_ppm(img))


def test_read_ppm_header_comments_and_errors(tmp_path):
    data = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    p = tmp_path / "c.ppm"
    p.write_bytes(b"P6\n# a comment\n3  2\n#another\n255\n" + data.tobytes())
    np.testing.assert_array_equal(timage.read_ppm(str(p)), data)
    np.testing.assert_array_equal(jimage.read_ppm(str(p)), data)
    (tmp_path / "a.ppm").write_bytes(b"P3\n1 1\n255\n0 0 0\n")
    with pytest.raises(ValueError, match="binary PPM"):
        timage.read_ppm(str(tmp_path / "a.ppm"))
    (tmp_path / "m.ppm").write_bytes(b"P6\n1 1\n65535\n\0\0\0\0\0\0")
    with pytest.raises(ValueError, match="maxval"):
        timage.read_ppm(str(tmp_path / "m.ppm"))


@pytest.mark.parametrize("fn", ["tone_map", "rmse_8bit",
                                "diagnostic_colors", "diagnose"])
def test_image_functions_match_reference(fn):
    img = _hdr(5)
    if fn == "tone_map":
        for exposure, gamma in ((0.0, 2.2), (1.5, 1.0), (-2.0, 2.4)):
            np.testing.assert_array_equal(
                timage.tone_map(np.nan_to_num(img), exposure, gamma),
                jimage.tone_map(np.nan_to_num(img), exposure, gamma))
    elif fn == "rmse_8bit":
        a, b = (timage.quantize_ppm(np.nan_to_num(x))
                for x in (img, _hdr(6)))
        got = timage.rmse_8bit(a, b)
        assert got == jimage.rmse_8bit(a, b) and got > 0.0
        assert timage.rmse_8bit(a, a) == 0.0
    elif fn == "diagnostic_colors":
        got = timage.diagnostic_colors(img)
        np.testing.assert_array_equal(got, jimage.diagnostic_colors(img))
        np.testing.assert_array_equal(got[0, 0], [0.0, 0.0, 1.0])
        np.testing.assert_array_equal(got[1, 1], [0.0, 1.0, 0.0])
    else:
        assert timage.diagnose(img) == jimage.diagnose(img)


def _decode_png(data: bytes):
    """A validating decoder for the encoder's own output."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, w, h, idat = 8, None, None, b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        (crc,) = struct.unpack(">I", data[pos + 8 + ln:pos + 12 + ln])
        assert crc == (zlib.crc32(tag + payload) & 0xFFFFFFFF)
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            assert (depth, ctype) == (8, 2)
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + ln
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * 3 + 1)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_png_roundtrip_and_reference_bytes():
    img = np.random.default_rng(0).integers(0, 256, (7, 13, 3),
                                            dtype=np.uint8)
    png = tviewer.encode_png(img)
    assert png == jviewer.encode_png(img)
    np.testing.assert_array_equal(_decode_png(png), img)


class _Stats:
    samples_done, samples_total = 3, 16
    seconds, rays_traced = 1.5, 1000
    mrays_per_sec = 0.000667


def _get(url):
    return urllib.request.urlopen(url, timeout=10).read()


def test_viewer_serves_frames_and_stats():
    v = tviewer.LiveViewer(port=0)
    try:
        img = np.zeros((4, 6, 3), np.float32)
        img[:, :, 0] = 0.5
        v.update(img, _Stats())
        base = f"http://127.0.0.1:{v.port}"
        assert b"progressive render" in _get(base + "/")
        decoded = _decode_png(_get(base + "/frame.png"))
        assert decoded.shape == (4, 6, 3)
        assert decoded[:, :, 0].min() > 100  # the tone-mapped red channel
        st = json.loads(_get(base + "/stats.json"))
        assert st["samples_done"] == 3 and st["samples_total"] == 16
        with pytest.raises(urllib.error.HTTPError):
            _get(base + "/nothing")
    finally:
        v.close()


def test_viewer_interactive_knobs_roundtrip():
    v = tviewer.LiveViewer(port=0, knobs={"width": 640, "exposure": 0.0})
    try:
        base = f"http://127.0.0.1:{v.port}"
        assert json.loads(_get(base + "/knobs.json")) == {"width": 640,
                                                         "exposure": 0.0}
        assert b"knobs.json" in _get(base + "/")
        body = json.dumps({"width": "320", "exposure": "1.5",
                           "bogus": "1"}).encode()
        req = urllib.request.Request(base + "/render", data=body,
                                     method="POST")
        assert urllib.request.urlopen(req, timeout=10).status == 200
        sub = v.wait_knobs()
        assert sub["width"] == "320" and sub["exposure"] == "1.5"
        assert v.knobs == {"width": "320", "exposure": "1.5"}
        v.set_state("rendering")
        assert json.loads(_get(base + "/stats.json"))["state"] == "rendering"
        bad = urllib.request.Request(base + "/render", data=b"[1]",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=10)
        assert e.value.code == 400
    finally:
        v.close()


def test_viewer_knobs_disabled_by_default():
    v = tviewer.LiveViewer(port=0)
    try:
        base = f"http://127.0.0.1:{v.port}"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/knobs.json")
        assert e.value.code == 404
        req = urllib.request.Request(base + "/render", data=b"{}",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 404
    finally:
        v.close()


def _namespace():
    return argparse.Namespace(
        width=640, height=480, pixel_samples=2, light_samples=1, depth=3,
        focal_distance=16.0, lens_radius=0.0, shutter=(0.0, 1.0),
        exposure=0.0, gamma=2.2)


def test_apply_knobs_coercion():
    req = {"width": "320", "depth": "8", "fov": "45", "shutter_open": "0.25",
           "shutter_close": "0.75", "gamma": "junk", "pixel_samples": "0",
           "light_samples": "17", "height": "99999", "lens_radius": "0.5",
           "exposure": "-1", "unknown": "9"}
    ns, ref = _namespace(), _namespace()
    fov = tcli.apply_knobs(ns, 30.0, req)
    assert fov == jcli.apply_knobs(ref, 30.0, req) == 45.0
    assert vars(ns) == vars(ref)
    assert ns.width == 320 and ns.depth == 8
    assert ns.shutter == (0.25, 0.75)
    assert ns.gamma == 2.2  # junk ignored
    assert ns.pixel_samples == 2 and ns.light_samples == 1  # out of range
    assert ns.height == 480 and ns.lens_radius == 0.5
    assert tcli._KNOB_MAX == jcli._KNOB_MAX


@pytest.mark.parametrize("name", ["stage1", "stage2", "stage3", "stage4",
                                  "stage5", "stage6", "stage7", "stage7b"])
def test_build_scene_names_the_reference_scenes(name, tmp_path):
    obj = str(tmp_path / "b.obj")
    tdemo.write_bumpy_standin(obj, n=2)
    t_scene, t_cam, t_fov, t_mode = tcli.build_scene(name, obj)
    j_scene, j_cam, j_fov, j_mode = jcli.build_scene(name, obj)
    assert (t_cam, t_fov, t_mode) == (j_cam, j_fov, j_mode)
    for kind in ("planes", "spheres", "rect_lights", "meshes"):
        assert len(getattr(t_scene, kind)) == len(getattr(j_scene, kind))


def test_unknown_scene_exits():
    with pytest.raises(SystemExit, match="unknown scene"):
        tcli.build_scene("stage9", "x.obj")


def test_cli_without_a_card_refuses_to_run(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "o.ppm")
    with pytest.raises(SystemExit, match="CUDA card") as e:
        tcli.main(["--scene", "stage1", "-o", out])
    assert e.value.code not in (0, None)
    assert not os.path.exists(out)


def test_cli_subprocess_stage1_imports_no_jax(tmp_path):
    """``python -m`` with no PYTHONPATH: the PPM is render_color's at the
    CLI's config; ``-X importtime`` lists every module the run imported."""
    out = str(tmp_path / "s1.ppm")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "rayito_tpu_torch.cli",
         "--device", "cpu", "--scene", "stage1", "--width", "32",
         "--height", "24", "-o", out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "device=cpu" in proc.stderr and "nan=0" in proc.stderr
    modules = {line.rsplit("|", 1)[-1].strip()
               for line in proc.stderr.splitlines()
               if line.startswith("import time:")}
    assert "rayito_tpu_torch.render.integrator" in modules
    foreign = sorted(m for m in modules
                     if m.split(".")[0] in ("jax", "jaxlib", "rayito_tpu"))
    assert foreign == []
    cfg = RenderConfig(width=32, height=24, pixel_samples=2)
    img = tint.render_color(tdemo.stage1_scene().compile("cpu"), cfg,
                            fov=tdemo.STAGE1_FOV, camera=tdemo.STAGE1_CAMERA)
    np.testing.assert_array_equal(timage.read_ppm(out),
                                  timage.quantize_ppm(img))


def test_cli_sharded_and_resumed_write_the_same_bytes(tmp_path,
                                                      monkeypatch):
    """Stage 5 at 48x32, 4 spp, depth 2, one sample per launch: plain,
    --sharded (over the one CPU device), and a run stopped after its first
    sample and resumed from its checkpoint write the same PFM bytes."""
    import functools

    from rayito_tpu_torch.render import progressive
    from rayito_tpu_torch.utils import config

    monkeypatch.setattr(config, "RenderConfig", functools.partial(
        RenderConfig, max_rays_per_pass=48 * 32))
    base = ["--device", "cpu", "--scene", "stage5", "--width", "48",
            "--height", "32", "--depth", "2", "--pfm"]
    outs = {}
    for label, extra in (("plain", []), ("sharded", ["--sharded"])):
        outs[label] = str(tmp_path / f"{label}.pfm")
        assert tcli.main(base + ["-o", outs[label]] + extra) == 0
    ck = str(tmp_path / "ck.npz")
    real = progressive.render_progressive

    def stop(st):
        raise KeyboardInterrupt

    monkeypatch.setattr(progressive, "render_progressive",
                        lambda *a, **kw: real(*a, **dict(kw, on_progress=stop)))
    with pytest.raises(KeyboardInterrupt):
        tcli.main(base + ["-o", str(tmp_path / "x.pfm"), "--checkpoint", ck])
    monkeypatch.setattr(progressive, "render_progressive", real)
    with np.load(ck) as saved:
        assert int(saved["samples_done"]) == 1
    outs["resumed"] = str(tmp_path / "resumed.pfm")
    assert tcli.main(base + ["-o", outs["resumed"], "--checkpoint", ck]) == 0
    data = {}
    for k, v in outs.items():
        with open(v, "rb") as f:
            data[k] = f.read()
    assert data["plain"] == data["sharded"] == data["resumed"]


def test_collect_device_ops_keeps_the_device_kernels():
    """collect_device_ops keeps each device row of a profile, the csrc
    kernels' __global__ symbols and PyTorch's kernels alike, with its
    total µs and count as the profiler gave them, and drops the host
    rows."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from rayito_tpu_torch.utils.profiling import collect_device_ops

    def row(key, us, count, device=DeviceType.CUDA):
        return SimpleNamespace(key=key, self_device_time_total=us,
                               count=count, device_type=device)

    rows = [
        row("cluster_masks_kernel(float const*, ...)", 500.0, 18),
        row("blocks_fold_kernel(int const*, ...)", 4000.0, 18),
        row("analytic_fold_kernel(void const*, ...)", 300.0, 9),
        row("ray_unsort_kernel(int const*, ...)", 40.0, 6),
        row("void at::native::vectorized_elementwise_kernel<4, ...>", 9000.0,
            20000),
        row("void at::native::radixSortKVInPlace<...>", 400.0, 36),
        row("aten::add", 1e6, 20000, DeviceType.CPU),
        row("cudaLaunchKernel", 2e5, 300, DeviceType.CPU),
    ]
    prof = SimpleNamespace(key_averages=lambda: rows)
    ops = collect_device_ops(prof)
    assert ops == {r.key: (r.self_device_time_total, r.count)
                   for r in rows[:6]}
