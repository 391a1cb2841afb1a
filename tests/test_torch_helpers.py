"""Port parity: the public helpers of ``ops/`` and ``accel/bvh.py`` that the
renderer's main path does not call, against the reference's on seeded
inputs (the projected-solid-angle BRDF forms, ``is_dirac``, the stage-3/4
shading terms, the slab test and the bullseye rings, the uniform
hemisphere, the vector helpers, and the BVH's node boxes and order).

Tolerances: 2e-6 relative and 1e-6 absolute where the reference's XLA may
contract a multiply-add into one FMA and PyTorch rounds twice; outputs
through cos and sin take atol 2e-4 (test_torch_ops.py: in a process that
also runs JAX, PyTorch's CPU cos errs by up to 1.5e-4 above 3.5 rad);
booleans, integers and the BVH exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayito_tpu.accel import bvh as jbvh
from rayito_tpu.ops import brdf as jbrdf
from rayito_tpu.ops import intersect as jint
from rayito_tpu.ops import vec3 as jv
from rayito_tpu.ops import warps as jwarps
from rayito_tpu_torch.accel import bvh as tbvh
from rayito_tpu_torch.ops import brdf as tbrdf
from rayito_tpu_torch.ops import intersect as tint
from rayito_tpu_torch.ops import vec3 as tv
from rayito_tpu_torch.ops import warps as twarps

N = 4096


def _u(rs, lo=-1.0, hi=1.0, n=N):
    return rs.uniform(lo, hi, n).astype(np.float32)


def _v3(rs, lo=-1.0, hi=1.0, unit=False):
    a = rs.uniform(lo, hi, (3, N)).astype(np.float32)
    if unit:
        a = (a / np.linalg.norm(a, axis=0)).astype(np.float32)
    return (jv.V3(*(jnp.asarray(c) for c in a)),
            tv.V3(*(torch.from_numpy(c.copy()) for c in a)))


def _close(got, ref, rtol=2e-6, atol=1e-6):
    if isinstance(got, tv.V3):
        for c in "xyz":
            _close(getattr(got, c), getattr(ref, c), rtol, atol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _material_lanes(rs):
    kind = rs.integers(0, 5, N).astype(np.int32)
    exponent = rs.uniform(1.0, 60.0, N).astype(np.float32)
    return ((jnp.asarray(kind), jnp.asarray(exponent)),
            (torch.from_numpy(kind), torch.from_numpy(exponent)))


@pytest.mark.parametrize("fn", ["evaluate_psa", "pdf_psa", "sample_psa"])
def test_psa_forms_match_reference(fn):
    rs = np.random.default_rng(1)
    (jk, je), (tk, te) = _material_lanes(rs)
    (jn, tn), (jo, to) = _v3(rs, unit=True), _v3(rs, unit=True)
    if fn == "sample_psa":
        u1, u2 = _u(rs, 0.0, 1.0), _u(rs, 0.0, 1.0)
        ref = jbrdf.sample_psa(jk, je, jo, jn, jnp.asarray(u1),
                               jnp.asarray(u2))
        got = tbrdf.sample_psa(tk, te, to, tn, torch.from_numpy(u1),
                               torch.from_numpy(u2))
        _close(got[0], ref[0], atol=2e-4)
        got, ref = got[1:], ref[1:]
    else:
        ji, ti = _v3(rs, unit=True)
        ref = getattr(jbrdf, fn)(jk, je, ji, jo, jn)
        got = getattr(tbrdf, fn)(tk, te, ti, to, tn)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        # the 1/|n.i| blow-up of grazing lanes: compare relative there
        _close(g, r, rtol=5e-5, atol=2e-4)
    np.testing.assert_array_equal(tbrdf.is_dirac(tk).numpy(),
                                  np.asarray(jbrdf.is_dirac(jk)))


def test_shade_terms_match_reference():
    rs = np.random.default_rng(2)
    (jn, tn), (ji, ti), (jl, tl) = (_v3(rs, unit=True) for _ in range(3))
    expo = _u(rs, 1.0, 64.0)
    _close(tbrdf.lambert_shade(tn, tl), jbrdf.lambert_shade(jn, jl))
    _close(tbrdf.phong_shade(tn, ti, tl, torch.from_numpy(expo)),
           jbrdf.phong_shade(jn, ji, jl, jnp.asarray(expo)), rtol=5e-5)


def test_aabb_and_bullseye_match_reference():
    rs = np.random.default_rng(3)
    jo, to = _v3(rs, -4.0, 4.0)
    d = rs.normal(size=(3, N)).astype(np.float32)
    d[:, ::16] = 0.0  # axis-parallel rays: 0 * inf on the box planes
    d[2, ::16] = 1.0
    with np.errstate(divide="ignore"):
        inv = (1.0 / d).astype(np.float32)
    jinv = jv.V3(*(jnp.asarray(c) for c in inv))
    tinv = tv.V3(*(torch.from_numpy(c.copy()) for c in inv))
    lo = rs.uniform(-2.0, 0.0, 3).astype(np.float32)
    hi = lo + rs.uniform(0.5, 2.0, 3).astype(np.float32)
    box = [(jv.V3(*map(float, b)), tv.V3(*map(float, b))) for b in (lo, hi)]
    t1 = _u(rs, 1.0, 9.0)
    ref = jint.aabb_intersect(jo, jinv, 1e-4, jnp.asarray(t1), box[0][0],
                              box[1][0])
    got = tint.aabb_intersect(to, tinv, 1e-4, torch.from_numpy(t1),
                              box[0][1], box[1][1])
    assert 0 < int(ref[0].sum()) < N
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, r in zip(got[1:], ref[1:]):  # no multiply-add: bit for bit
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    jp, tp = _v3(rs, -30.0, 30.0)
    plane = (jv.V3(0.5, -2.0, 1.0), tv.V3(0.5, -2.0, 1.0))
    ring = tint.bullseye_ring(tp, plane[1]).numpy()
    np.testing.assert_array_equal(ring,
                                  np.asarray(jint.bullseye_ring(jp, plane[0])))
    assert 0 < ring.sum() < N


def test_uniform_to_hemisphere_matches_reference():
    rs = np.random.default_rng(4)
    u1, u2 = _u(rs, 0.0, 1.0), _u(rs, 0.0, 1.0)
    got = twarps.uniform_to_hemisphere(torch.from_numpy(u1),
                                       torch.from_numpy(u2))
    _close(got, jwarps.uniform_to_hemisphere(jnp.asarray(u1),
                                             jnp.asarray(u2)), atol=2e-4)
    assert (got.z >= 0).all()


def test_vector_helpers_match_reference():
    rs = np.random.default_rng(5)
    (ja, ta), (jb, tb) = _v3(rs, -3.0, 3.0), _v3(rs, -3.0, 3.0)
    t = _u(rs, 0.0, 1.0)
    _close(tv.length(ta), jv.length(ja))
    _close(tv.length2(ta), jv.length2(ja))
    _close(tv.lerp(ta, tb, torch.from_numpy(t)),
           jv.lerp(ja, jb, jnp.asarray(t)))
    _close(tv.reflect(ta, tb), jv.reflect(ja, jb), atol=1e-5)
    for fn in ("min_components", "max_components"):
        got, ref = getattr(tv, fn)(ta, tb), getattr(jv, fn)(ja, jb)
        for c in "xyz":
            np.testing.assert_array_equal(getattr(got, c).numpy(),
                                          np.asarray(getattr(ref, c)))
    frame_t = tv.make_coordinate_space_tangent(ta, tb)
    frame_j = jv.make_coordinate_space_tangent(ja, jb)
    for g, r in zip(frame_t, frame_j):
        _close(g, r, atol=1e-5)
    _close(tv.to_local_frame(ta, *frame_t), jv.to_local_frame(ja, *frame_j),
           atol=1e-5)
    # the frame is orthonormal and to_local_frame inverts from_local_frame
    x, y, z = frame_t
    back = tv.from_local_frame(tv.to_local_frame(ta, x, y, z), x, y, z)
    _close(back, jv.V3(*(np.asarray(getattr(ja, c)) for c in "xyz")),
           atol=1e-5)


@pytest.mark.parametrize("n_tris", [1, 2, 97, 768])
def test_build_bvh_matches_reference(n_tris):
    rs = np.random.default_rng(n_tris)
    v0 = rs.uniform(-5.0, 5.0, (n_tris, 3)).astype(np.float32)
    v1 = v0 + rs.uniform(-0.5, 0.5, (n_tris, 3)).astype(np.float32)
    v2 = v0 + rs.uniform(-0.5, 0.5, (n_tris, 3)).astype(np.float32)
    if n_tris == 97:
        v0[::3] = v1[::3] = v2[::3] = 1.0  # coincident boxes: median splits
    ref = jbvh.build_bvh(v0, v1, v2)
    got = tbvh.build_bvh(v0, v1, v2)
    for k in ("nodes_min", "nodes_max", "prim", "prim_order"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)
        assert getattr(got, k).dtype == getattr(ref, k).dtype, k
    assert got.depth == ref.depth
    assert sorted(got.prim_order.tolist()) == list(range(n_tris))
    np.testing.assert_array_equal(tbvh.bvh_prim_order(v0, v1, v2),
                                  jbvh.bvh_prim_order(v0, v1, v2))
