"""The scalar-division audit (``utils/div_audit.py``) on the CPU.

On a CUDA tensor PyTorch divides by a Python number (or a 0-d CPU tensor)
through its reciprocal, which rounds twice where the CPU and the reference
round once; the port divides by a 0-d tensor on the lanes' device instead
(``ops/vec3.div_scalar``). The audit sees the same ops on the CPU as on the
card, so here it holds that one path pass of stage 6 and of stage 7b (the
camera rays, the samplers, the BRDFs, the tiny-mesh fold) divides by no
scalar, and that it catches the forms it is meant to catch. It also holds
the port's quotients to the reference's as JAX runs it op by op: the
reference's compiled form differs (XLA rewrites a division by a constant
as a multiply by its reciprocal, and on the CPU contracts ``1 - a * b``
into an FMA); ``python tests/test_torch_div_audit.py`` counts by how much.
"""

import jax
import numpy as np
import pytest
import torch

from rayito_tpu_torch.models import demo
from rayito_tpu_torch.models.camera import PerspectiveCamera
from rayito_tpu_torch.ops.vec3 import div_scalar
from rayito_tpu_torch.render import pathtracer as pt
from rayito_tpu_torch.utils.config import RenderConfig
from rayito_tpu_torch.utils.div_audit import ScalarDivisions


def test_audit_flags_scalar_divisors():
    x = torch.arange(1.0, 5.0)
    with ScalarDivisions() as audit:
        x / 3.0
        x / 2  # a power of two is exact either way, but is flagged too
        x.clone().div_(7.0)
        torch.floor_divide(x, 3.0)
        torch.arange(4) / 3  # an integer dividend, a float quotient
    assert sum(audit.found.values()) == 5
    assert set(audit.found) == {"?"}  # call sites outside the port
    with ScalarDivisions() as audit:
        x / torch.full((), 3.0)  # a 0-d divisor on the lanes' device
        div_scalar(x, 3.0)
        x / x
        torch.arange(4) // 3  # integers: exact
        1.0 / x  # one IEEE reciprocal on both devices: listed
    assert not audit.found
    assert sum(audit.reciprocals.values()) == 1
    assert "reciprocals" in audit.summary()


def test_div_scalar_divides():
    x = torch.arange(1.0, 200.0)
    assert torch.equal(div_scalar(x, 3), x / 3.0)  # the CPU divides
    assert div_scalar(x, 480).dtype == torch.float32


@pytest.mark.parametrize("stage", ["stage6", "stage7b"])
def test_path_pass_has_no_scalar_division(stage, tmp_path):
    """One path pass on the CPU, 16x12 at 2x2 samples, depth 3: no
    division by a scalar anywhere on it (the reciprocals are listed)."""
    if stage == "stage6":
        obj = str(tmp_path / "bumpy8.obj")
        demo.write_bumpy_standin(obj, n=8)
        scene, spec, shutter = (demo.stage6_scene(obj), demo.STAGE6_CAMERA,
                                {})
    else:
        scene, spec = demo.stage7_scene2(), demo.STAGE7_SCENE2_CAMERA
        shutter = dict(shutter_open=0.0, shutter_close=1.0)
    cfg = RenderConfig(width=16, height=12, pixel_samples=2, light_samples=1,
                       max_depth=3, max_rays_per_pass=16 * 12)
    cam = PerspectiveCamera.make(30.0, *spec, focal_distance=16.0,
                                 lens_radius=0.0, **shutter)
    sd = scene.compile("cpu")
    with ScalarDivisions() as audit:
        img, _, queries = pt.render_path_with_stats(sd, cfg, cam)
    assert not audit.found, audit.summary()
    assert audit.reciprocals and int(queries) > 0


def _division_sites():
    """The CLI's 640x480 screen coordinates at seeded jitter and Lambert's
    pdf of 2^20 seeded direction triples, each as (the port's on the CPU,
    the reference's op by op, the reference's under jax.jit), float32."""
    from rayito_tpu.ops import brdf as jbrdf
    from rayito_tpu.ops.vec3 import V3 as JV3
    from rayito_tpu.render import integrator as jint
    from rayito_tpu.utils.config import RenderConfig as JConfig
    from rayito_tpu_torch.ops import brdf as tbrdf
    from rayito_tpu_torch.ops.vec3 import V3
    from rayito_tpu_torch.render import integrator as tint

    kw = dict(width=640, height=480, pixel_samples=2, light_samples=1,
              max_depth=3)
    jcfg, tcfg = JConfig(**kw), RenderConfig(**kw)
    rs = np.random.default_rng(0)
    py, px = np.meshgrid(np.arange(480, dtype=np.int32),
                         np.arange(640, dtype=np.int32), indexing="ij")
    px, py = px.ravel(), py.ravel()
    jx, jy = rs.random((2, px.size), dtype=np.float32)
    uv = lambda *a: jint.screen_uv(jcfg, *a)  # noqa: E731
    port = tint.screen_uv(tcfg, *(torch.from_numpy(a) for a in
                                  (px, py, jx, jy)))
    with jax.disable_jit():
        eager = uv(px, py, jx, jy)
    jitted = jax.jit(uv)(px, py, jx, jy)
    out = {"screen_uv": [np.concatenate([np.asarray(c) for c in f])
                         for f in (port, eager, jitted)]}
    vecs = rs.standard_normal((3, 3, 1 << 20)).astype(np.float32)
    pdf = lambda a, b, n: jbrdf.lambert_evaluate_sa(  # noqa: E731
        JV3(*a), JV3(*b), JV3(*n))[1]
    port = tbrdf.lambert_evaluate_sa(
        *(V3(*(torch.from_numpy(c) for c in v)) for v in vecs))[1]
    with jax.disable_jit():
        eager = pdf(*vecs)
    out["lambert_pdf"] = [np.asarray(port), np.asarray(eager),
                          np.asarray(jax.jit(pdf)(*vecs))]
    return out


def test_port_divides_as_the_reference_does_op_by_op():
    """The port's quotients (0-d divisors on the lanes' device, one IEEE
    division each) equal the reference's under jax.disable_jit bit for bit:
    the CLI's screen coordinates and Lambert's pdf."""
    for name, (port, eager, _) in _division_sites().items():
        assert np.array_equal(port.view(np.int32), eager.view(np.int32)), name


if __name__ == "__main__":
    for name, (port, eager, jitted) in _division_sites().items():
        bits = lambda a, b: int((a.view(np.int32)  # noqa: E731
                                 != b.view(np.int32)).sum())
        print(f"{name}: {port.size} values; the port against the reference "
              f"op by op {bits(port, eager)} differing, against the "
              f"reference under jax.jit {bits(port, jitted)}")
