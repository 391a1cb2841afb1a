"""Port parity: the draw sets and the correctly rounded roots, on the CPU.

The integrators draw every sample of a bounce, of the camera and of a
direct-lighting pass as one draw set (``ops/rng.py`` ``cmj_draws``: one
launch of ``csrc/cmj.cu``'s ``cmj_draws_kernel`` on the card, held against
``cmj_draws_plain`` there by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``). Here, on the CPU:

  * ``cmj_draws_plain`` on the plans of ``pathtrace_wave``
    (``bounce_draws``), ``_camera_rays`` (``camera_draws``) and
    ``render_direct`` (``subpixel_draw``, ``direct_light_draws``) equals
    the reference's ``rayito_tpu.ops.rng`` draws bit for bit (op by op
    under ``jax.disable_jit``), on 512 seeded lanes at pixel samples
    {1, 2, 3, 12} x light samples {1, 2};
  * it equals the same draws made one by one through the single draws,
    with int32 and int64 lanes;
  * the plan's encoding: its rows, its split into launches of at most
    MAX_PLAN_SEEDS seeds and MAX_PLAN_DRAWS draws, and what it refuses;
  * the kernel's magic-number divisions (``magic_divisor``, its
    arithmetic run in numpy uint64 as the kernel runs it in uint32) equal
    ``//`` and ``%`` on the pattern sizes the renderers use and on 10,000
    seeded divisors up to 2^32 - 1;
  * ``ops/vec3.sqrt_ieee`` equals numpy's float32 root bit for bit on
    seeded values, and the audit (``utils/div_audit.py``) finds no float32
    root outside it on one CPU pass of stage 6, stage 7, stage 7b, stage 3
    and the 'xla' route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayito_tpu.ops import rng as jrng
from rayito_tpu_torch.models import demo
from rayito_tpu_torch.models.camera import PerspectiveCamera
from rayito_tpu_torch.ops import rng as trng
from rayito_tpu_torch.ops.vec3 import sqrt_ieee
from rayito_tpu_torch.render import integrator as tint
from rayito_tpu_torch.render import pathtracer as tpath
from rayito_tpu_torch.utils.config import RenderConfig
from rayito_tpu_torch.utils.div_audit import ScalarDivisions

LANES = 512
PATTERNS = [(ps, ls) for ps in (1, 2, 3, 12) for ls in (1, 2)]
MASK32 = 0xFFFFFFFF


def _plans(ps, ls):
    """{name: plan} of the renderers at (ps, ls): the camera's, bounces 0
    and 2 with three lights, one without lights, and a direct pass's
    subpixel draw (stratified and stage 2's (64, 1)) and light loop over
    two lights."""
    cfg = RenderConfig(width=64, height=48, pixel_samples=ps,
                       light_samples=ls, seed=7)
    return {"camera": tpath.camera_draws(cfg),
            "bounce0": tpath.bounce_draws(cfg, 3, 0),
            "bounce2": tpath.bounce_draws(cfg, 3, 2),
            "bounce_dark": tpath.bounce_draws(cfg, 0, 1),
            "direct_subpixel": (tint.subpixel_draw(cfg, ps, ps),
                                tint.subpixel_draw(cfg, 64, 1)),
            "direct_lights": tint.direct_light_draws(cfg, 2)}


def _lanes(ps, ls, dtype=np.int32):
    rs = np.random.default_rng(100 * ps + ls)
    px = rs.integers(0, 640, LANES)
    py = rs.integers(0, 480, LANES)
    si = rs.integers(0, ps * ps, LANES)
    return [a.astype(dtype) for a in (px, py, si)]


def _jax_draws(plan, px, py, si):
    """The plan through the reference's draws: each seed hash_combine of
    its operands, each sample of the index si * mul + add in uint32."""
    lanes = dict(zip(trng.LANE_OPERANDS, (px, py, si)))
    rows = []
    for dr in plan:
        h = jrng.hash_combine(*(lanes[v] if isinstance(v, str)
                                else np.uint32(v & MASK32) for v in dr.seed))
        idx = (jrng.u32(si) * jnp.uint32(dr.index_mul & MASK32)
               + jnp.uint32(dr.index_add & MASK32))
        if dr.ny:
            rows += jrng.cmj_sample_2d(idx, dr.nx, dr.ny, h)
        else:
            rows.append(jrng.cmj_sample_1d(idx, dr.nx, h))
    return np.stack([np.asarray(r, np.float32) for r in rows])


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("ps, ls", PATTERNS)
def test_draw_sets_match_reference(ps, ls):
    px, py, si = _lanes(ps, ls)
    t = [torch.from_numpy(a) for a in (px, py, si)]
    j = [jnp.asarray(a.astype(np.uint32)) for a in (px, py, si)]
    for name, plan in _plans(ps, ls).items():
        got = trng.cmj_draws(plan, *t)
        assert got.shape == (sum(2 if d.ny else 1 for d in plan), LANES)
        with jax.disable_jit():
            want = _jax_draws(plan, *j)
        np.testing.assert_array_equal(_bits(got), _bits(want),
                                      err_msg=f"{name} at {ps}x{ls}")


@pytest.mark.parametrize("dtype", [np.int32, np.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("ps, ls", [(1, 1), (2, 2), (3, 1), (12, 2)])
def test_draw_sets_equal_single_draws(ps, ls, dtype):
    """Each draw's rows equal hash_combine then cmj_sample_* of that draw
    alone, at the rows draw_rows gives it."""
    px, py, si = (torch.from_numpy(a) for a in _lanes(ps, ls, dtype))
    lanes = {"px": px, "py": py, "si": si}
    for name, plan in _plans(ps, ls).items():
        got = trng.cmj_draws_plain(plan, px, py, si)
        for dr, row in zip(plan, trng.draw_rows(plan)):
            h = trng.hash_combine(*(
                lanes[v] if isinstance(v, str) else v for v in dr.seed))
            if dr.ny:
                want = trng.cmj_sample_2d(si, dr.nx, dr.ny, h,
                                          dr.index_mul, dr.index_add)
            else:
                want = (trng.cmj_sample_1d(si, dr.nx, h, dr.index_mul,
                                           dr.index_add),)
            for k, w in enumerate(want):
                assert torch.equal(got[row + k].view(torch.int32),
                                   w.view(torch.int32)), (name, dr, k)


def test_plan_rows_and_launches():
    """Rows in plan order (two per 2-D draw); the encoding groups draws by
    seed and splits a set at MAX_PLAN_SEEDS seeds or MAX_PLAN_DRAWS draws,
    a seed's draws continuing in the next launch; the renderers' sets fit
    one launch at the light samples they use."""
    cfg = RenderConfig(width=8, height=8, pixel_samples=2, light_samples=2)
    plan = tpath.bounce_draws(cfg, 2, 1)
    assert trng.draw_rows(plan) == [6 * (k // 4) + (0, 1, 3, 4)[k % 4]
                                    for k in range(16)] + [24]
    launches, rows = trng._encode(plan)
    assert rows == 26 and len(launches) == 1 and launches[0].n_seeds == 5
    assert len(trng._encode(tpath.camera_draws(cfg))[0]) == 1
    assert len(trng._encode(tint.direct_light_draws(
        RenderConfig(width=8, height=8, light_samples=4), 2))[0]) == 1
    # ten seeds of fifteen 2-D draws: 64 + 64 + 22 draws, 5 + 5 + 2 seeds
    big = tuple(trng.Draw(("px", k % 10), 3, 3) for k in range(150))
    launches, rows = trng._encode(big)
    assert rows == 300
    assert [p.n_seeds for p in launches] == [5, 5, 2]
    assert [sum(p.seed[k].n_draws for k in range(p.n_seeds))
            for p in launches] == [64, 64, 22]
    seed = launches[0].seed[1]
    assert (seed.n_ops, seed.src, seed.imm[1]) == (2, 1, 1)  # px, then 1
    px = torch.arange(16, dtype=torch.int32)
    assert torch.equal(trng.cmj_draws(big, px, px, px % 9),
                       trng.cmj_draws_plain(big, px, px, px % 9))


def test_plan_refuses_bad_draws():
    x = torch.zeros(4, dtype=torch.int32)
    for bad in (trng.Draw(("px",), 0), trng.Draw(("px",), 2, -1),
                trng.Draw(("px",), 1 << 16, 1 << 16),
                trng.Draw(("px", "pz"), 2), trng.Draw((1,) * 7, 2)):
        with pytest.raises(ValueError, match="cmj_draws"):
            trng.cmj_draws((bad,), x, x, x)
    with pytest.raises(TypeError, match="Draw"):
        trng.cmj_draws(((("px",), 2),), x, x, x)
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        trng.cmj_draws((trng.Draw(("px",), 2),), x, meta, x)


def _udiv_magic(n, d, m, l):
    """The kernel's div_magic in numpy uint64 (every value below 2^32)."""
    n = n.astype(np.uint64)
    t = (n * np.uint64(m)) >> np.uint64(32)
    return (t + ((n - t) >> np.uint64(min(l, 1)))) >> np.uint64(max(l - 1, 0))


def test_magic_division_is_exact():
    rs = np.random.default_rng(3)
    sizes = {n for ps in (1, 2, 3, 4, 12) for ls in (1, 2, 4)
             for n in (ps, ps * ps, ps * ls, (ps * ls) ** 2)} | {64, 1}
    divisors = sorted(sizes) + [int(d) for d in rs.integers(
        1, 2**32, 10_000, dtype=np.uint64)] + [2**31, 2**31 + 1, 2**32 - 1]
    for d in divisors:
        d_, m, l = trng.magic_divisor(d)
        assert d_ == d and 0 < m < 2**32 and 2**l >= d > 2**l // 2
        n = np.concatenate([
            rs.integers(0, 2**32, 256, dtype=np.uint64),
            np.array([0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d,
                      2**32 - 1, 2**32 - 2, (2**32 - 1) // d * d,
                      (2**32 - 1) // d * d - 1], np.uint64)])
        n = n[n < 2**32]
        q = _udiv_magic(n, d, m, l)
        assert np.array_equal(q, n // np.uint64(d)), d
        assert np.array_equal(n - q * np.uint64(d), n % np.uint64(d)), d
    with pytest.raises(ValueError):
        trng.magic_divisor(0)
    with pytest.raises(ValueError):
        trng.magic_divisor(2**32)


def test_sqrt_ieee_is_numpy_float32_root():
    rs = np.random.default_rng(17)
    x = np.concatenate([
        rs.uniform(0.01, 100.0, 1 << 20),
        rs.uniform(0.0, 1.0, 1 << 16) ** 8,  # near 0: subnormal roots' inputs
        np.exp(rs.uniform(-80.0, 80.0, 1 << 16)),
        [0.0, 1e-45, 1e-38, 1.0, 2.0, 3.4e38, np.inf]]).astype(np.float32)
    got = sqrt_ieee(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.sqrt(x).view(np.int32))


def test_audit_lists_roots_outside_sqrt_ieee():
    x = torch.arange(1.0, 5.0)
    with ScalarDivisions() as audit:
        torch.sqrt(x)
        sqrt_ieee(x)
        torch.sqrt(x.double())  # not float32
    assert sum(audit.sqrts.values()) == 1 and set(audit.sqrts) == {"?"}
    assert "outside sqrt_ieee" in audit.summary()


def _pass(stage, tmp_path):
    """One small CPU render of ``stage`` (a callable)."""
    cfg = RenderConfig(width=16, height=12, pixel_samples=2, light_samples=1,
                       max_depth=3, max_rays_per_pass=16 * 12)
    if stage == "stage3":
        sd = demo.stage3_scene().compile("cpu")
        return lambda: tint.render_direct(sd, cfg, fov=demo.STAGE23_FOV,
                                          camera=demo.STAGE23_CAMERA)
    obj = str(tmp_path / "bumpy8.obj")
    demo.write_bumpy_standin(obj, n=8)
    shutter, kw = {}, {}
    if stage in ("stage6", "xla"):
        scene, spec = demo.stage6_scene(obj), demo.STAGE6_CAMERA
        kw = {"traversal": "xla"} if stage == "xla" else {}
    elif stage == "stage7":
        scene, spec = demo.stage7_scene1(obj), demo.STAGE7_CAMERA
        shutter = dict(shutter_open=0.0, shutter_close=1.0)
    else:
        scene, spec = demo.stage7_scene2(), demo.STAGE7_SCENE2_CAMERA
        shutter = dict(shutter_open=0.0, shutter_close=1.0)
    cam = PerspectiveCamera.make(30.0, *spec, focal_distance=16.0,
                                 lens_radius=0.2, **shutter)
    sd = scene.compile("cpu", **kw)
    return lambda: tpath.render_path_with_stats(sd, cfg, cam)


@pytest.mark.parametrize("stage",
                         ["stage6", "stage7", "stage7b", "stage3", "xla"])
def test_no_float32_root_outside_sqrt_ieee(stage, tmp_path):
    """One CPU pass (16x12, 2x2 samples, depth 3, a lens so depth of field
    runs): every float32 root is sqrt_ieee's."""
    render = _pass(stage, tmp_path)
    with ScalarDivisions() as audit:
        render()
    assert not audit.sqrts, audit.summary()
