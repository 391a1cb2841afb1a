"""Package-level contracts of rayito_tpu_torch.

  * the port runs its CPU slice (a stage-6 and a moving stage-7 render)
    without importing jax or rayito_tpu;
  * the reference's TPU-only scheduling options are rejected loudly;
  * a kernel wrapper runs its plain version only for CPU tensors: other
    devices raise, and a library that cannot be built raises;
  * ``cuda_lib.SIGNATURES`` declares exactly the ``extern "C"`` entries of
    ``csrc/*.cu``, each with as many parameters as its definition.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.models.scene import UNPORTED_KNOBS, SceneData
from rayito_tpu_torch.ops.vec3 import V3
from rayito_tpu_torch.render import traverse as tv
from rayito_tpu_torch.utils import cuda_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SLICE = r"""
import sys
import numpy as np
from rayito_tpu_torch.models.camera import PerspectiveCamera
from rayito_tpu_torch.models.demo import (STAGE6_CAMERA, STAGE7_CAMERA,
                                          stage6_scene, stage7_scene1,
                                          write_bumpy_standin)
from rayito_tpu_torch.ops import quaternion, transform
from rayito_tpu_torch.render import mesh_intersect
from rayito_tpu_torch.render.pathtracer import render_path_with_stats
from rayito_tpu_torch.utils.config import RenderConfig
write_bumpy_standin(sys.argv[1], n=4)
cfg = RenderConfig(width=16, height=16, pixel_samples=1, light_samples=1,
                   max_depth=2, aspect_correction=True)
for build, spec, shutter in ((stage6_scene, STAGE6_CAMERA, 0.0),
                             (stage7_scene1, STAGE7_CAMERA, 1.0)):
    scene = build(sys.argv[1]).compile("cpu")
    cam = PerspectiveCamera.make(30.0, *spec, focal_distance=16.0,
                                 lens_radius=0.0, shutter_close=shutter)
    img, _, q = render_path_with_stats(scene, cfg, cam)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and q > 256
assert scene.has_motion and scene.ktab_small
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "rayito_tpu"))
print("FOREIGN", bad)
"""


def test_cpu_slice_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _SLICE, str(tmp_path / "b4.obj")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FOREIGN []" in proc.stdout, proc.stdout


@pytest.fixture(scope="module")
def box_scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("obj") / "b2.obj")
    tdemo.write_bumpy_standin(path, n=2)
    return tdemo.stage6_scene(path)


@pytest.mark.parametrize("knob,value", [
    *((k, 1) for k in sorted(UNPORTED_KNOBS)),
    ("traverse_mt", "mxu"),
])
def test_tpu_only_options_raise(box_scene, knob, value):
    kw = {knob: value}
    with pytest.raises(ValueError, match=knob.split("_")[-1]):
        box_scene.compile("cpu", **kw)


def test_traversal_xla_is_not_ported(box_scene):
    """traversal='xla' is ported now (tests/test_torch_xla.py holds it to
    the reference): it compiles with the pipeline's tables; a traversal
    neither package has raises."""
    xla = box_scene.compile("cpu", traversal="xla")
    assert xla.traversal == "xla" and xla.sc_rows.shape[1] == 128
    with pytest.raises(ValueError, match="xla"):
        box_scene.compile("cpu", traversal="cuda")
    assert isinstance(box_scene.compile("cpu"), SceneData)


def _kernel_calls(dev):
    soat = torch.zeros((1, 2048, 8), device=dev)
    box = torch.zeros((8, 128), device=dev)
    masks = torch.zeros((16, 4), dtype=torch.int32, device=dev)
    tri = torch.zeros((1, 16, 128), device=dev)
    slices = torch.zeros((1, 4, 8), device=dev)
    table = torch.zeros((8, 16), device=dev)
    idx = torch.zeros((4,), dtype=torch.int32, device=dev)
    items = torch.full((12,), -1, dtype=torch.int32, device=dev)
    n_steps = torch.zeros((), dtype=torch.int32, device=dev)
    return {
        "cluster_masks": lambda: tv.cluster_masks(soat, box, 1e-4),
        "traverse_blocks": lambda: tv.traverse_blocks(masks, soat, tri, 1e-4,
                                                      slices=slices),
        "gather_rows_t": lambda: tv.gather_rows_t(table, idx),
        "traverse_items": lambda: tv.traverse_items(
            items, n_steps, soat.view(16, 128, 8), tri, 1e-4, slices=slices),
        "build_items": lambda: tv.build_items(masks, 4, 64, 8),
        "cluster_pipeline": lambda: tv.cluster_pipeline(
            idx, n_steps, V3(*soat[0, :4, :3].t()), V3(*soat[0, :4, 3:6].t()),
            soat[0, :4, 6], 1e-4, soat[0, :4, :1], torch.zeros(
                (1, 128), device=dev), torch.zeros((16, 512), device=dev),
            1, 16, 0),
    }


@pytest.mark.parametrize("name", ["cluster_masks", "traverse_blocks",
                                  "gather_rows_t", "traverse_items",
                                  "build_items", "cluster_pipeline"])
def test_wrappers_take_the_plain_version_only_on_the_cpu(name):
    cuda_lib.reset_launch_counts()
    _kernel_calls("cpu")[name]()  # plain version: no launch counted
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        _kernel_calls("meta")[name]()
    assert all(fn.launches == 0 for fn in cuda_lib.KERNELS)


def test_unbuildable_library_raises(monkeypatch, tmp_path):
    """With no nvcc, loading the kernels raises; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_lib, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_lib, "LIB_PATH", str(tmp_path / "lib.so"))
    cuda_lib.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_lib.library()
    finally:
        cuda_lib.library.cache_clear()


def test_signatures_declare_every_c_entry():
    """The ctypes declarations and the sources agree: every ``extern "C"``
    entry of csrc/*.cu is in SIGNATURES with its parameter count, and
    SIGNATURES names nothing else."""
    entry = re.compile(r'extern "C"\s+int\s+(\w+)\s*\(([^)]*)\)')
    found = {}
    for f in sorted(os.listdir(cuda_lib.CSRC)):
        if f.endswith(".cu"):
            with open(os.path.join(cuda_lib.CSRC, f)) as src:
                for name, params in entry.findall(src.read()):
                    assert name not in found, f"{name} defined twice"
                    found[name] = len([p for p in params.split(",")
                                       if p.strip() not in ("", "void")])
    assert found == {name: len(argtypes)
                     for name, argtypes in cuda_lib.SIGNATURES.items()}
