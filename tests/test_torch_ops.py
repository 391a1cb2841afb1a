"""Port parity: rayito_tpu_torch.ops and the camera against rayito_tpu.

The same numpy inputs (fixed seeds) go through both packages. Integer
streams (seed hash, CMJ permutations and samples) must be bit-identical;
float ops agree to rtol = atol = 1e-6 (the two compilers may round
transcendentals differently by an ulp or two), with two stated exceptions:

  * outputs that pass through ``torch.cos`` take atol = 2e-4 (TRIG). In
    a process that also runs JAX, PyTorch's CPU float32 cos now and then
    returns values off by up to 1.5e-4 for arguments above 3.5 rad (seen in
    about one run in three; torch.sin and JAX stay within 5e-7 of a
    float64 evaluation). The port's formula is not at fault, and the GPU
    does not use that CPU kernel;
  * the glossy lobe's pdf takes rtol = 5e-5: pow(n.h, e) with e up to 100
    turns one ulp of n.h into ~100 ulp, and both packages sit 1.2e-5 from
    a float64 evaluation on the worst input here.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rayito_tpu.models.camera import PerspectiveCamera as JCam
from rayito_tpu.ops import brdf as jb
from rayito_tpu.ops import intersect as ji
from rayito_tpu.ops import mis as jm
from rayito_tpu.ops import rng as jr
from rayito_tpu.ops import samplers as js
from rayito_tpu.ops import warps as jw
from rayito_tpu.ops.vec3 import V3 as JV3
from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
from rayito_tpu_torch.ops import brdf as tb
from rayito_tpu_torch.ops import intersect as ti
from rayito_tpu_torch.ops import mis as tm
from rayito_tpu_torch.ops import rng as tr
from rayito_tpu_torch.ops import samplers as ts
from rayito_tpu_torch.ops import warps as tw
from rayito_tpu_torch.ops.vec3 import V3 as TV3

TOL = dict(rtol=1e-6, atol=1e-6)
TRIG = dict(rtol=1e-6, atol=2e-4)


def _u32(seed, n=4096):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)


def _j(a):
    # a private copy: the jax array never aliases numpy memory that the
    # torch side reads
    return jnp.array(np.array(a), copy=True)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint64
                            else a.copy())


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), **(tol or TOL))


def _v3(rows):
    """[3, N] float32 numpy -> (jax V3, torch V3)."""
    rows = np.asarray(rows, np.float32)
    return (JV3(*(_j(r) for r in rows)),
            TV3(*(torch.from_numpy(r.copy()) for r in rows)))


def _unit(seed, n):
    v = np.random.default_rng(seed).normal(size=(3, n)).astype(np.float32)
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def _eq_v3(a, b, **tol):
    for c in "xyz":
        _close(getattr(a, c), getattr(b, c), **tol)


# ---------------------------------------------------------------- streams


def test_hash_combine_bit_exact():
    a, b, c = _u32(1), _u32(2), _u32(3)
    h_j = jr.hash_combine(_j(a.astype(np.uint32)), _j(b.astype(np.uint32)),
                          jr.PURPOSE_BRDF, np.uint32(2), _j(c.astype(np.uint32)))
    h_t = tr.hash_combine(_t(a), _t(b), tr.PURPOSE_BRDF, 2, _t(c))
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j).astype(np.int64))


@pytest.mark.parametrize("num", [1, 2, 3, 4, 7, 16, 100, 1024])
def test_cmj_permute_bit_exact(num):
    i = _u32(5) % num
    perm = _u32(6)
    p_j = jr.cmj_permute(_j(i.astype(np.uint32)), num, _j(perm.astype(np.uint32)))
    p_t = tr.cmj_permute(_t(i), num, _t(perm))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j).astype(np.int64))
    assert (p_t.numpy() < num).all()


@pytest.mark.parametrize("n", [1, 4, 9, 64])
def test_cmj_sample_1d_bit_exact(n):
    idx, perm = _u32(7) % n, _u32(8)
    s_j = jr.cmj_sample_1d(_j(idx.astype(np.uint32)), n, _j(perm.astype(np.uint32)))
    s_t = tr.cmj_sample_1d(_t(idx), n, _t(perm))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("nx,ny", [(1, 1), (2, 2), (3, 5), (8, 8)])
def test_cmj_sample_2d_bit_exact(nx, ny):
    idx, perm = _u32(9) % (nx * ny), _u32(10)
    a_j, b_j = jr.cmj_sample_2d(_j(idx.astype(np.uint32)), nx, ny,
                                _j(perm.astype(np.uint32)))
    a_t, b_t = tr.cmj_sample_2d(_t(idx), nx, ny, _t(perm))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


def test_u32_to_float01_bit_exact():
    x = _u32(11)
    np.testing.assert_array_equal(
        tr.u32_to_float01(_t(x)).numpy(),
        np.asarray(jr.u32_to_float01(_j(x.astype(np.uint32)))),
    )


@pytest.mark.parametrize("kind", ["random", "stratified", "cmj"])
def test_samplers_bit_exact(kind):
    idx, perm = _u32(12) % 12, _u32(13)
    s_j = js.sample_2d(kind, _j(idx.astype(np.uint32)), 3, 4,
                       _j(perm.astype(np.uint32)))
    s_t = ts.sample_2d(kind, _t(idx), 3, 4, _t(perm))
    for a, b in zip(s_j, s_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        ts.sample_1d(kind, _t(idx), 12, _t(perm)).numpy(),
        np.asarray(js.sample_1d(kind, _j(idx.astype(np.uint32)), 12,
                                _j(perm.astype(np.uint32)))),
    )


# ------------------------------------------------------------- float ops


def _uv(seed, n=4096):
    u = np.random.default_rng(seed).random((2, n), dtype=np.float32)
    u[:, :4] = [[0.5, 0.0, 0.25, 0.999], [0.5, 0.0, 0.75, 0.001]]
    return u


@pytest.mark.parametrize("name", [
    "concentric_sample_disk", "uniform_to_sphere", "uniform_to_uniform_disk",
    "uniform_to_cosine_hemisphere",
])
def test_warps(name):
    u = _uv(14)
    a = getattr(jw, name)(_j(u[0]), _j(u[1]))
    b = getattr(tw, name)(_t(u[0]), _t(u[1]))
    if isinstance(a, JV3):
        _eq_v3(a, b, **TRIG)
    else:
        for x, y in zip(a, b):
            _close(x, y, **TRIG)


def test_cone_warp_and_pdf():
    u = _uv(15)
    ctm = np.random.default_rng(16).uniform(-0.2, 1.0, u.shape[1]).astype(np.float32)
    ctm[:3] = [1.0, 0.0, 0.999999]
    _eq_v3(jw.uniform_to_cone(_j(u[0]), _j(u[1]), _j(ctm)),
           tw.uniform_to_cone(_t(u[0]), _t(u[1]), _t(ctm)), **TRIG)
    _close(jw.uniform_cone_pdf(_j(ctm)), tw.uniform_cone_pdf(_t(ctm)),
           rtol=1e-6, atol=0)


def _brdf_inputs(seed, n=4096):
    rs = np.random.default_rng(seed)
    kind = rs.integers(0, 5, n).astype(np.int32)
    rough = rs.choice(np.float32([0.1, 0.3, 0.6]), n)
    exponent = np.where(kind == 1, 1.0 / (rough * rough), 1.0).astype(np.float32)
    normal = _unit(seed + 1, n)
    outgoing = _unit(seed + 2, n)
    incoming = _unit(seed + 3, n)
    incoming[:, :64] = -outgoing[:, :64]  # near-mirror configurations
    return kind, exponent, normal, outgoing, incoming


def test_brdf_evaluate_sa():
    kind, ex, n, o, i = _brdf_inputs(17)
    (jn, tn), (jo, to), (ji_, ti_) = _v3(n), _v3(o), _v3(i)
    f_j, p_j = jb.evaluate_sa(_j(kind), _j(ex), ji_, jo, jn)
    f_t, p_t = tb.evaluate_sa(_t(kind), _t(ex), ti_, to, tn)
    _close(f_j, f_t, rtol=1e-5, atol=1e-6)
    _close(p_j, p_t, rtol=1e-5, atol=1e-6)
    assert (np.asarray(f_j) > 0).sum() > 500
    np.testing.assert_array_equal(np.asarray(f_j) > 0, f_t.numpy() > 0)


def test_brdf_sample_sa():
    kind, ex, n, o, _ = _brdf_inputs(18)
    u = _uv(19)
    (jn, tn), (jo, to) = _v3(n), _v3(o)
    i_j, f_j, p_j = jb.sample_sa(_j(kind), _j(ex), jo, jn, _j(u[0]), _j(u[1]))
    i_t, f_t, p_t = tb.sample_sa(_t(kind), _t(ex), to, tn, _t(u[0]), _t(u[1]))
    _eq_v3(i_j, i_t, rtol=1e-5, atol=TRIG["atol"])
    _close(f_j, f_t, rtol=1e-4, atol=1e-6)
    _close(p_j, p_t, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(p_j) > 0, p_t.numpy() > 0)


def test_brdf_pdf_sa_and_emitter():
    kind, ex, n, o, i = _brdf_inputs(20)
    kind[:] = np.where(kind == 3, 3, kind)
    (jn, tn), (jo, to), (ji_, ti_) = _v3(n), _v3(o), _v3(i)
    _close(jb.pdf_sa(_j(kind), _j(ex), ji_, jo, jn),
           tb.pdf_sa(_t(kind), _t(ex), ti_, to, tn), rtol=5e-5, atol=1e-6)
    em = np.full_like(kind, 3)
    _, f_t, p_t = tb.sample_sa(_t(em), _t(ex), to, tn, _t(ex * 0), _t(ex * 0))
    assert not f_t.any() and not p_t.any()


def test_power_and_balance_heuristics():
    rs = np.random.default_rng(21)
    a, b = rs.random((2, 4096), dtype=np.float32) * 10
    a[:8] = 0.0
    b[:4] = 0.0
    _close(jm.power_heuristic(1.0, _j(a), 1.0, _j(b)),
           tm.power_heuristic(1.0, _t(a), 1.0, _t(b)))
    _close(jm.balance_heuristic(1.0, _j(a), 1.0, _j(b)),
           tm.balance_heuristic(1.0, _t(a), 1.0, _t(b)))


def _rays(seed, n=4096):
    """Origins around z = 6 aimed at random points near the origin."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-3, 3, (3, n)).astype(np.float32)
    o[2] += 6.0
    d = rs.normal(0, 1.0, (3, n)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d, rs.uniform(1.0, 20.0, n).astype(np.float32)


def _c3(v):
    return (JV3(*(jnp.float32(x) for x in v)),
            TV3(*(torch.tensor(float(x), dtype=torch.float32) for x in v)))


@pytest.mark.parametrize("shape", ["plane", "sphere", "rect", "triangle"])
def test_intersect(shape):
    o, d, tcur = _rays(22)
    (jo, to), (jd, td) = _v3(o), _v3(d)
    jt_, tt_ = _j(tcur), _t(tcur)
    if shape == "plane":
        nrm = np.float32([0.2, 0.9, 0.1])
        pos, nrm = _c3((0.0, -1.0, 0.0)), _c3(nrm / np.linalg.norm(nrm))
        a = ji.plane_intersect(jo, jd, 1e-4, jt_, pos[0], nrm[0])
        b = ti.plane_intersect(to, td, 1e-4, tt_, pos[1], nrm[1])
    elif shape == "sphere":
        c = _c3((0.3, 0.1, -0.4))
        a = ji.sphere_intersect(jo, jd, 1e-4, jt_, c[0], jnp.float32(1.7))
        b = ti.sphere_intersect(to, td, 1e-4, tt_, c[1],
                                torch.tensor(1.7, dtype=torch.float32))
    elif shape == "rect":
        cs = [_c3((-1.5, -0.5, -1.0)), _c3((3.0, 0.0, 0.5)), _c3((0.0, 2.0, 0.3))]
        a = ji.rect_intersect(jo, jd, 1e-4, jt_, *(c[0] for c in cs))
        b = ti.rect_intersect(to, td, 1e-4, tt_, *(c[1] for c in cs))
        _eq_v3(a[2], b[2])
    else:
        vs = np.random.default_rng(23).uniform(-2, 2, (3, 3, o.shape[1]))
        jv, tv = zip(*(_v3(v) for v in vs))
        a = ji.triangle_intersect(jo, jd, 1e-4, jt_, *jv)
        b = ti.triangle_intersect(to, td, 1e-4, tt_, *tv)
        _close(a[2], b[2], rtol=1e-5, atol=1e-6)  # beta
        _close(a[3], b[3], rtol=1e-5, atol=1e-6)  # gamma
    np.testing.assert_array_equal(b[1].numpy(), np.asarray(a[1]))
    hit = np.asarray(a[1])
    assert hit.sum() > 50
    _close(np.asarray(a[0])[hit], b[0].numpy()[hit])


def test_camera_rays():
    jc = JCam.make(30.0, (-2.0, 5.0, 15.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    tc = TCam.make(30.0, (-2.0, 5.0, 15.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    u = _uv(24)
    o_j, d_j, t_j = jc.make_rays(_j(u[0]), _j(u[1]), _j(u[0]), _j(u[1]), _j(u[0]))
    o_t, d_t, t_t = tc.make_rays(_t(u[0]), _t(u[1]), _t(u[0]), _t(u[1]), _t(u[0]))
    _eq_v3(o_j, o_t)
    _eq_v3(d_j, d_t)
    _close(t_j, t_t)
