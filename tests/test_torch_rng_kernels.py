"""Port parity: the sample streams and the tiny-mesh fold, the two kernels
whose plain versions were the reference's XLA regions, on the CPU.

``hash_combine``, ``cmj_sample_1d`` and ``cmj_sample_2d`` (``ops/rng.py``,
the single draws) are torch ops on every device, and the draw-set
kernel's plain version draws through them; on a CPU tensor
``fold_small`` (``render/mesh_intersect.py``) runs its plain version. The
kernels themselves (``csrc/cmj.cu``, ``csrc/fold_small.cu``) are held
against those on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here, against
``rayito_tpu`` (op by op under ``jax.disable_jit``, so XLA contracts
nothing and walks the cycle in a Python loop):

  * every draw of the path's patterns at pixel samples {1, 2, 3, 12} x
    light samples {1, 2} (the camera's, one bounce's light loop at the flat
    index si * nls + lsi given as a multiplier and addend, the
    continuation sample, stages 2-3's per-light draws of six hash operands
    at a constant index, stage 2's (64, 1) pattern), with int32 and with
    int64 operands, bit for bit;
  * the immediate operand forms: an all-int hash stays a host value, 0-d
    tensors serve every lane, and the index multiplier and addend wrap at
    2^32 as the reference's uint32 arithmetic does;
  * ``mesh_fold_small`` on stage 7b's 12-triangle cube (whose last quad is
    doubled) and on a 192-triangle mesh of 96 triangles twice, against
    ``_brute_force_mesh``: t and prim bit for bit, beta and gamma where
    prim >= 0;
  * what the wrappers refuse, and the kernel registry.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayito_tpu as rt
import rayito_tpu.models.demo as jdemo
from rayito_tpu.ops import rng as jrng
from rayito_tpu.ops.vec3 import V3 as JV3
from rayito_tpu.render import mesh_intersect as jmi
import rayito_tpu_torch as tt
from rayito_tpu_torch.models import demo as tdemo
from rayito_tpu_torch.ops import rng as trng
from rayito_tpu_torch.ops.vec3 import V3 as TV3
from rayito_tpu_torch.render import mesh_intersect as tmi
from rayito_tpu_torch.utils import cuda_lib

LANES = 256
SEED = 1
PATTERNS = [(ps, ls) for ps in (1, 2, 3, 12) for ls in (1, 2)]


class _Jax:
    """The reference's draws, the flat index computed in uint32."""

    hash_combine = staticmethod(jrng.hash_combine)

    @staticmethod
    def _index(index, mul, add):
        return jrng.u32(index) * jnp.uint32(mul) + jnp.uint32(add)

    @staticmethod
    def cmj_sample_1d(index, n, perm, mul=1, add=0):
        return jrng.cmj_sample_1d(_Jax._index(index, mul, add), n, perm)

    @staticmethod
    def cmj_sample_2d(index, nx, ny, perm, mul=1, add=0):
        return jrng.cmj_sample_2d(_Jax._index(index, mul, add), nx, ny, perm)


def _draws(m, full, px, py, si, ps, ls):
    """Every draw of the path's patterns at (ps, ls) through ``m``;
    ``full(k)`` is a constant index of every lane."""
    nls = ls * ls
    out = []
    h = m.hash_combine(px, py, trng.PURPOSE_SUBPIXEL, SEED)
    out += [h, *m.cmj_sample_2d(si, ps, ps, h)]
    h = m.hash_combine(px, py, trng.PURPOSE_TIME, SEED)
    out += [h, m.cmj_sample_1d(si, ps * ps, h)]
    hs = m.hash_combine(px, py, trng.PURPOSE_LIGHT_SELECT, 2, SEED)
    hl = m.hash_combine(px, py, trng.PURPOSE_LIGHT, 2, SEED)
    out += [hs, hl]
    for lsi in range(nls):
        out += [m.cmj_sample_1d(si, (ps * ls) ** 2, hs, nls, lsi),
                *m.cmj_sample_2d(si, ps * ls, ps * ls, hl, nls, lsi)]
    h = m.hash_combine(px, py, trng.PURPOSE_BOUNCE, 2, SEED)
    out += [h, *m.cmj_sample_2d(si, ps, ps, h)]
    h = m.hash_combine(px, py, si, trng.PURPOSE_LIGHT, 3, SEED)
    for k in range(nls):
        out += m.cmj_sample_2d(full(k), ls, ls, h)
    out += m.cmj_sample_2d(si, 64, 1, h)
    return out


def _assert_same(got, ref, what):
    got, ref = got.numpy(), np.asarray(ref)
    if ref.dtype == np.uint32:
        np.testing.assert_array_equal(got, ref.astype(np.int64), err_msg=what)
    else:
        np.testing.assert_array_equal(got.view(np.int32),
                                      ref.astype(np.float32).view(np.int32),
                                      err_msg=what)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("ps, ls", PATTERNS)
def test_path_patterns_match_reference(ps, ls, dtype):
    rs = np.random.default_rng(ps * 10 + ls)
    px = rs.integers(0, 640, LANES).astype(np.int32)
    py = rs.integers(0, 480, LANES).astype(np.int32)
    si = rs.integers(0, ps * ps, LANES).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    got = _draws(trng, lambda k: torch.full((LANES,), k, dtype=dtype),
                 t(px), t(py), t(si), ps, ls)
    j = lambda a: jnp.asarray(a.astype(np.uint32))  # noqa: E731
    with jax.disable_jit():
        ref = _draws(_Jax, lambda k: j(np.full(LANES, k)), j(px), j(py),
                     j(si), ps, ls)
    assert len(got) == len(ref)
    for k, (g, r) in enumerate(zip(got, ref)):
        _assert_same(g, r, f"output {k}")


def test_all_immediate_hash_stays_a_host_value():
    """Operands that are all ints give a CPU tensor, the reference's bits;
    0-d tensors beside [N] tensors serve every lane."""
    vals = (3, 4, trng.PURPOSE_LENS, 0xFFFFFFFF, -5)
    got = trng.hash_combine(*vals)
    assert got.device.type == "cpu" and got.dim() == 0
    ref = jrng.hash_combine(*(np.uint32(v & 0xFFFFFFFF) for v in vals))
    assert int(got) == int(ref)
    px = np.arange(LANES, dtype=np.int32)
    got = trng.hash_combine(torch.from_numpy(px), torch.tensor(7),
                            trng.PURPOSE_BRDF,
                            torch.tensor(-2, dtype=torch.int32))
    ref = jrng.hash_combine(jnp.asarray(px.astype(np.uint32)), 7,
                            trng.PURPOSE_BRDF, np.uint32(2**32 - 2))
    _assert_same(got, ref, "0-d operands")


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
def test_index_multiplier_and_addend_wrap(dtype):
    """index * mul + add in uint32: a multiplier and an addend that wrap at
    2^32, on raw indices spread over all of uint32 (negative as int32)
    whose wrapped index is in range, against the reference's uint32
    arithmetic; mul 1 and add 0 leave the index as it is."""
    rs = np.random.default_rng(5)
    mul, add = 0x9E3779B1, 0xFFFFFFF0
    inv = pow(mul, -1, 2**32)
    perm = rs.integers(0, 2**32, LANES, dtype=np.uint64).astype(np.uint32)
    tp, jp = torch.from_numpy(perm.astype(np.int64)), jnp.asarray(perm)

    def raw(num):
        """(wrapped index in [0, num), the raw index that gives it)."""
        want = rs.integers(0, num, LANES, dtype=np.uint64)
        got = ((want - np.uint64(add)) % 2**32 * np.uint64(inv)) % 2**32
        assert (got > 2**31).any()  # the multiply-add wraps
        return want.astype(np.uint32), got.astype(np.uint32)

    t = lambda a: torch.from_numpy(a.view(np.int32)).to(dtype)  # noqa
    with jax.disable_jit():
        for n in (1, 7, 64, 300):
            want, i = raw(n)
            _assert_same(trng.cmj_sample_1d(t(i), n, tp, mul, add),
                         jrng.cmj_sample_1d(jnp.asarray(want), n, jp),
                         f"1-D {n}")
            _assert_same(trng.cmj_sample_1d(t(want), n, tp),
                         jrng.cmj_sample_1d(jnp.asarray(want), n, jp),
                         f"1-D {n}, mul 1")
        for nx, ny in ((1, 1), (3, 5), (24, 24)):
            want, i = raw(nx * ny)
            got = trng.cmj_sample_2d(t(i), nx, ny, tp, mul, add)
            ref = _Jax.cmj_sample_2d(jnp.asarray(i), nx, ny, jp, mul, add)
            for g, r in zip(got, ref):
                _assert_same(g, r, f"2-D {nx}x{ny}")


def test_wrappers_refuse_mixed_devices_and_shapes():
    """Tensors on more than one device raise (as the traversal wrappers
    do), and so do tensor operands of different shapes on the card's
    path; the kernel's operand record is cmj.cu's 24-byte Operand."""
    x = torch.zeros(4, dtype=torch.int32)
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        trng.hash_combine(x, meta)
    with pytest.raises(ValueError, match="one CUDA device"):
        trng.cmj_sample_2d(x, 2, 2, meta)
    with pytest.raises(ValueError, match="different shapes"):
        trng._lanes("hash_combine", (x, torch.zeros(5, dtype=torch.int32)))
    vals, shape = trng._lanes("cmj_sample_1d", (x, torch.tensor(3), 5))
    assert shape == (4,) and len(vals) == 3 and vals[2] == 5
    assert ctypes.sizeof(trng._Operand) == 24
    assert trng._operand("hash_combine", torch.tensor(3)).stride == 0
    assert trng._operand("hash_combine", -1).imm == 0xFFFFFFFF
    with pytest.raises(ValueError, match="int32 or int64"):
        trng._operand("hash_combine", torch.zeros(2))
    sd = tdemo.stage7_scene2().compile("cpu")
    f = x.float()
    ray = TV3(f, f, f)
    with pytest.raises(ValueError, match="fold_small"):  # best or occluded
        tmi.fold_small(sd, ray, ray, f, 1e-4, f)
    with pytest.raises(ValueError, match="fold_small"):  # lanes of [N]
        tmi.fold_small(sd, ray, ray, f[:3], 1e-4, f,
                       occluded=torch.zeros(4, dtype=torch.bool))


def test_kernel_registry_lists_eight_kernels():
    """Every hand kernel counts its launches: the sample streams under
    one name whichever wrapper launched, the tiny-mesh fold, the two
    shading kernels (since the bounce's shading became kernels), the
    analytic fold (since the analytic shapes of a query became one
    kernel) and the traversal's plumbing around the coherence sort
    (ray_pack, ray_reorder, ray_unsort): fourteen names, the eight of the
    name and those six."""
    # the shading wrappers register when render/shade.py is imported,
    # which the other modules this file imports do not do
    import rayito_tpu_torch.render.shade  # noqa: F401

    names = sorted(fn.__name__ for fn in cuda_lib.KERNELS)
    assert names == ["analytic_fold", "bounce_prepare", "bounce_resolve",
                     "build_items", "cluster_masks", "cluster_pipeline",
                     "cmj", "fold_small", "gather_rows_t", "ray_pack",
                     "ray_reorder", "ray_unsort", "traverse_blocks",
                     "traverse_items"]
    cuda_lib.reset_launch_counts()
    trng.hash_combine(torch.arange(4), 1)
    z = torch.zeros(4)
    sd = tdemo.stage7_scene2().compile("cpu")
    tmi.fold_small(sd, TV3(z, z, z), TV3(z, z, z + 1.0), z, 1e-4, z,
                   occluded=torch.zeros(4, dtype=torch.bool))
    from rayito_tpu_torch.render import trace as ttrace
    ttrace.analytic_fold(sd, TV3(z, z, z), TV3(z, z, z + 1.0), z, 1e-4, z)
    from rayito_tpu_torch.render import traverse as ttraverse
    box = torch.zeros((8, 32))
    _, perm, _ = ttraverse.prepare_rays(TV3(z, z, z), TV3(z, z, z + 1.0), z,
                                        box, 1e-4, sb=8)
    ttraverse.ray_unsort(torch.zeros(8, dtype=torch.int32), None, perm, 4)
    assert all(fn.launches == 0 for fn in cuda_lib.KERNELS)  # plain on the CPU


# ---------------------------------------------------------- mesh_fold_small


def _twin_mesh(pkg, tris):
    """A scene holding one tiny transformed mesh of the triangles ``tris``
    [T, 3, 3] (a translated copy, so it is folded densely)."""
    s = pkg.Scene()
    verts = tris.reshape(-1, 3).astype(np.float32)
    mesh = pkg.TriangleMesh(
        vertices=verts,
        indices=np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3),
        material=pkg.DiffuseMaterial((0.8, 0.3, 0.1)))
    mesh.transform.set_translation(0.0, (0.25, 0.0, 0.0))
    s.add(mesh)
    return s


def _mesh_192():
    """96 seeded triangles about the origin, then the same 96 again: every
    hit of the first half ties with its copy 96 rows on."""
    rs = np.random.default_rng(7)
    c = rs.uniform(-1.0, 1.0, (96, 1, 3))
    tris = (c + rs.normal(0.0, 0.4, (96, 3, 3))).astype(np.float32)
    return np.concatenate([tris, tris])


def _rays(rs, n, target):
    o = np.tile(np.asarray([0.3, 0.2, 6.0], np.float32), (n, 1))
    d = rs.normal(0.0, 0.12, (n, 3)) + (np.asarray(target) - o[0])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.full(n, 1e30, np.float32)
    tmax[::7] = 3.0  # some rays end before the mesh
    return o, d, tmax


@pytest.mark.parametrize("mesh", ["stage7b_cube", "tied_192"])
def test_mesh_fold_small_matches_brute_force(mesh):
    """The dense fold (on the CPU its plain version) against the
    reference's _brute_force_mesh on the same local rays, op by op: t and
    prim bit for bit on every lane (the first of tied minima, -1 on an
    all-miss lane), beta and gamma where prim >= 0."""
    if mesh == "stage7b_cube":
        js, ts, mi = jdemo.stage7_scene2(), tdemo.stage7_scene2(), 3
        target = (0.5, 0.5, 0.5)
    else:
        tris = _mesh_192()
        js, ts, mi = _twin_mesh(rt, tris), _twin_mesh(tt, tris), 0
        target = (0.0, 0.0, 0.0)
    jsd = js.compile(traversal="pallas", tiny_fold=False)
    tsd = ts.compile("cpu")
    assert mi in tsd.ktab_small
    cl0, n_cl = jsd.mesh_cl_ranges[mi]
    tri0 = jsd.mesh_tri_ranges[mi][0]
    o, d, tmax = _rays(np.random.default_rng(3), 512, target)
    jv = lambda a: JV3(*(jnp.asarray(a[:, k]) for k in range(3)))  # noqa
    tv3 = lambda a: TV3(*(torch.from_numpy(a[:, k].copy())  # noqa: E731
                          for k in range(3)))
    with jax.disable_jit():
        ref = jmi._brute_force_mesh(jsd, cl0, n_cl, tri0, jv(o), jv(d), 1e-4,
                                    jnp.asarray(tmax))
    got = tmi.mesh_fold_small(tsd, mi, tv3(o), tv3(d), 1e-4,
                              torch.from_numpy(tmax))
    prim = np.asarray(ref[1])
    hit = prim >= 0
    assert 0 < hit.sum() < prim.shape[0] and (prim[::7] == -1).all()
    np.testing.assert_array_equal(got[1].numpy(), prim)
    _assert_same(got[0], ref[0], "t")
    for k, what in ((2, "beta"), (3, "gamma")):
        np.testing.assert_array_equal(
            got[k].numpy()[hit].view(np.int32),
            np.asarray(ref[k])[hit].astype(np.float32).view(np.int32),
            err_msg=what)
    if mesh == "tied_192":  # every winner is the first of its twins
        rows = tsd.tri_vert_rows[tri0:tri0 + n_cl * 48, :9].numpy()
        for j in np.unique(prim[hit] - tri0):
            twins = np.flatnonzero((rows == rows[j]).all(axis=1))
            assert len(twins) == 2 and twins[0] == j, (j, twins)
