"""Port parity: quaternions, keyed TRS transforms and transform chains
(rayito_tpu_torch.ops.quaternion / ops.transform and the Transform key
mutators) against rayito_tpu on the same seeded inputs.

The port evaluates the same float32 expressions in the same order, so the
quaternion and transform results agree to a few float32 ulps (2e-6
absolute on unit-scale values: XLA on the CPU may contract a multiply and
an add into one FMA where PyTorch rounds twice). Host-side key management
(find_or_insert_key, set_*, translate, scale, rotate) is plain Python in
both and compares exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rayito_tpu as rt
import rayito_tpu_torch as tt
from rayito_tpu.ops import quaternion as jq
from rayito_tpu.ops import transform as jx
from rayito_tpu.ops.vec3 import V3 as JV3
from rayito_tpu_torch.ops import quaternion as tq
from rayito_tpu_torch.ops import transform as tx
from rayito_tpu_torch.ops.vec3 import V3 as TV3

N = 256
ATOL = 2e-6


def _close(got, ref, atol=ATOL, rtol=2e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=rtol)


def _v3(a):
    return (JV3(*(jnp.asarray(a[:, k]) for k in range(3))),
            TV3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3))))


def _quat(a):
    j = jq.Quat(jnp.asarray(a[:, 0]), _v3(a[:, 1:])[0])
    t = tq.Quat(torch.from_numpy(np.ascontiguousarray(a[:, 0])),
                _v3(a[:, 1:])[1])
    return j, t


def _close_v3(got, ref, **kw):
    for c in "xyz":
        _close(getattr(got, c).numpy(), getattr(ref, c), **kw)


def _close_quat(got, ref, **kw):
    _close(got.w.numpy(), ref.w, **kw)
    _close_v3(got.v, ref.v, **kw)


@pytest.fixture(scope="module")
def quats():
    rs = np.random.default_rng(7)
    a = rs.normal(size=(N, 4)).astype(np.float32)
    b = rs.normal(size=(N, 4)).astype(np.float32)
    v = rs.normal(size=(N, 3)).astype(np.float32)
    t = rs.uniform(-0.25, 1.25, N).astype(np.float32)
    return a, b, v, t


@pytest.mark.parametrize("op", ["conjugate", "norm2", "normalize",
                                "multiply", "multiply_buggy",
                                "rotate_vector", "nlerp", "slerp",
                                "to_axis_angle", "from_axis_angle",
                                "from_euler_zyx"])
def test_quaternion_ops_match_reference(quats, op):
    a, b, v, t = quats
    (ja, ta), (jb, tb) = _quat(a), _quat(b)
    (jv, tv) = _v3(v)
    jt, tt_ = jnp.asarray(t), torch.from_numpy(t)
    if op in ("conjugate", "normalize"):
        _close_quat(getattr(tq, op)(ta), getattr(jq, op)(ja))
    elif op == "norm2":
        _close(tq.norm2(ta).numpy(), jq.norm2(ja), rtol=1e-5)
    elif op in ("multiply", "multiply_buggy"):
        _close_quat(getattr(tq, op)(ta, tb), getattr(jq, op)(ja, jb),
                    atol=1e-5, rtol=1e-5)
    elif op == "rotate_vector":
        ja_n, ta_n = jq.normalize(ja), tq.normalize(ta)
        _close_v3(tq.rotate_vector(ta_n, tv), jq.rotate_vector(ja_n, jv),
                  atol=1e-5)
    elif op in ("nlerp", "slerp"):
        ja_n, jb_n = jq.normalize(ja), jq.normalize(jb)
        ta_n, tb_n = tq.normalize(ta), tq.normalize(tb)
        _close_quat(getattr(tq, op)(ta_n, tb_n, tt_),
                    getattr(jq, op)(ja_n, jb_n, jt), atol=1e-5)
    elif op == "to_axis_angle":
        axis_t, ang_t = tq.to_axis_angle(ta)
        axis_j, ang_j = jq.to_axis_angle(ja)
        _close(ang_t.numpy(), ang_j, atol=1e-5)
        _close_v3(axis_t, axis_j, atol=1e-4)
    elif op == "from_axis_angle":
        _close_quat(tq.from_axis_angle(tv, tt_ * 6.0),
                    jq.from_axis_angle(jv, jt * 6.0), atol=1e-6)
    else:
        _close_quat(tq.from_euler_zyx(tv.x, tv.y, tv.z),
                    jq.from_euler_zyx(jv.x, jv.y, jv.z))


def test_multiply_buggy_differs_from_hamilton(quats):
    """The reference renderer's aliasing bug changes the vector part."""
    a, b, _, _ = quats
    (_, ta), (_, tb) = _quat(a), _quat(b)
    good, bad = tq.multiply(ta, tb), tq.multiply_buggy(ta, tb)
    assert torch.equal(good.w, bad.w)
    assert not torch.allclose(good.v.x, bad.v.x)


def test_identity_quaternion_is_a_noop(quats):
    _, _, v, _ = quats
    _, tv = _v3(v)
    r = tq.rotate_vector(tq.identity(), tv)
    for c in "xyz":
        assert torch.equal(getattr(r, c), getattr(tv, c))


def _tables(n_keys, seed):
    """Keyed tables of 3 slots with up to ``n_keys`` keys each (slot 0 the
    identity, slot 1 n_keys keys, slot 2 two keys padded with the last)."""
    rs = np.random.default_rng(seed)
    k = n_keys
    times = np.zeros((3, k), np.float32)
    trans = np.zeros((3, k, 3), np.float32)
    scale = np.ones((3, k, 3), np.float32)
    rot = np.zeros((3, k, 4), np.float32)
    rot[..., 0] = 1.0
    nkeys = np.array([1, k, min(2, k)], np.int32)
    for s in (1, 2):
        m = nkeys[s]
        times[s, :m] = np.sort(rs.uniform(0.0, 1.0, m)).astype(np.float32)
        trans[s, :m] = rs.normal(size=(m, 3))
        scale[s, :m] = rs.uniform(0.5, 2.0, (m, 3))
        q = rs.normal(size=(m, 4))
        rot[s, :m] = q / np.linalg.norm(q, axis=1, keepdims=True)
        times[s, m:] = times[s, m - 1]
        trans[s, m:] = trans[s, m - 1]
        scale[s, m:] = scale[s, m - 1]
        rot[s, m:] = rot[s, m - 1]
    return times, trans, scale, rot, nkeys


def _lane_times(seed):
    """Times before, inside and after every key range, and exact keys."""
    rs = np.random.default_rng(seed)
    t = rs.uniform(-0.5, 1.5, N).astype(np.float32)
    t[:8] = [0.0, 1.0, -1.0, 2.0, 0.5, 0.25, 0.75, 1e-7]
    return t


@pytest.mark.parametrize("n_keys", [1, 2, 3, 4])
@pytest.mark.parametrize("slot", [0, 1, 2, "lanes"])
def test_eval_transform_matches_reference(n_keys, slot):
    tabs = _tables(n_keys, 10 + n_keys)
    time = _lane_times(n_keys)
    if slot == "lanes":
        ids = np.random.default_rng(3).integers(0, 3, N).astype(np.int32)
        j_id, t_id = jnp.asarray(ids), torch.from_numpy(ids)
    else:
        j_id, t_id = slot, slot
    ref = jx.eval_transform(*(jnp.asarray(a) for a in tabs), j_id,
                            jnp.asarray(time))
    got = tx.eval_transform(*(torch.from_numpy(a) for a in tabs), t_id,
                            torch.from_numpy(time))
    _close_v3(got[0], ref[0])
    _close_v3(got[1], ref[1])
    _close_quat(got[2], ref[2])


def test_eval_transform_pegs_to_end_keys():
    """Outside the key range the transform is the end key exactly."""
    tabs = _tables(3, 5)
    time = torch.tensor([-3.0, 7.0], dtype=torch.float32)
    tr, sc, ro = tx.eval_transform(*(torch.from_numpy(a) for a in tabs), 1,
                                   time)
    trans, scale, rot = tabs[1][1], tabs[2][1], tabs[3][1]
    for lane, key in ((0, 0), (1, 2)):
        assert [float(getattr(tr, c)[lane]) for c in "xyz"] == \
            trans[key].tolist()
        assert [float(getattr(sc, c)[lane]) for c in "xyz"] == \
            scale[key].tolist()
    assert abs(float(ro.w[1]) - rot[2, 0]) < 1e-6


def _chain_tables():
    """Slots 1 <- 2 <- 3 (a depth-3 chain under the root) and slot 4 at
    the root, each with two or three keys."""
    rs = np.random.default_rng(21)
    x, k = 5, 3
    times = np.tile(np.array([0.0, 0.4, 1.0], np.float32), (x, 1))
    trans = rs.normal(size=(x, k, 3)).astype(np.float32)
    scale = rs.uniform(0.5, 2.0, (x, k, 3)).astype(np.float32)
    q = rs.normal(size=(x, k, 4))
    rot = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    trans[0], scale[0], rot[0] = 0.0, 1.0, (1.0, 0.0, 0.0, 0.0)
    nkeys = np.array([1, 3, 2, 3, 2], np.int32)
    parent = np.array([-1, -1, 1, 2, -1], np.int32)
    return (times, trans, scale, rot, nkeys), parent


@pytest.mark.parametrize("slot", [1, 3, 4])
def test_chain_helpers_match_reference(slot):
    tabs, parent = _chain_tables()
    time = _lane_times(9)
    rs = np.random.default_rng(slot)
    (jo, to), (jd, td), (jp, tp) = (
        _v3(rs.normal(size=(N, 3)).astype(np.float32)) for _ in range(3))
    ref_links = jx.eval_chain(*(jnp.asarray(a) for a in tabs),
                              jnp.asarray(parent), 3, slot,
                              jnp.asarray(time))
    links = tx.eval_chain(*(torch.from_numpy(a) for a in tabs),
                          tuple(parent.tolist()), slot,
                          torch.from_numpy(time))
    assert len(links) == {1: 1, 3: 3, 4: 1}[slot]
    ro, rd, rrot = jx.ray_to_local_chain(ref_links, jo, jd)
    go, gd, grot = tx.ray_to_local_chain(links, to, td)
    _close_v3(go, ro, atol=1e-5, rtol=1e-5)
    _close_v3(gd, rd, atol=1e-5, rtol=1e-5)
    _close_quat(grot, rrot, atol=1e-5)
    for name in ("from_local_point_chain", "from_local_vector_chain",
                 "from_local_normal_chain", "to_local_point_chain",
                 "to_local_vector_chain"):
        _close_v3(getattr(tx, name)(links, tp),
                  getattr(jx, name)(ref_links, jp), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["point", "vector", "normal"])
def test_to_from_local_round_trip(kind):
    """from_local(to_local(x)) is x: one link, and through a chain."""
    tabs, parent = _chain_tables()
    time = torch.from_numpy(_lane_times(4))
    rs = np.random.default_rng(8)
    _, x = _v3(rs.normal(size=(N, 3)).astype(np.float32))
    t_tabs = [torch.from_numpy(a) for a in tabs]
    link = tx.eval_transform(*t_tabs, 3, time)
    back = getattr(tx, f"from_local_{kind}")(
        getattr(tx, f"to_local_{kind}")(x, *link), *link)
    _close_v3(back, x, atol=1e-5, rtol=1e-4)
    if kind != "normal":
        links = tx.eval_chain(*t_tabs, tuple(parent.tolist()), 3, time)
        back = getattr(tx, f"from_local_{kind}_chain")(
            links, getattr(tx, f"to_local_{kind}_chain")(links, x))
        _close_v3(back, x, atol=1e-4, rtol=1e-4)


def _mutations(pkg):
    """The cases of the reference's mutator test, on one package."""
    tr = pkg.Transform()
    tr.translate(0.0, (0.0, -2.0, -2.0))
    tr.rotate(1.0, (np.cos(np.pi / 8), 0.0, np.sin(np.pi / 8), 0.0))
    tr2 = pkg.Transform()
    tr2.set_translation(0.0, (0.0, 0.0, 0.0))
    tr2.set_translation(1.0, (4.0, 0.0, 0.0))
    tr2.set_scaling(0.25, (2.0, 2.0, 2.0))
    tr2.set_rotation(-1.0, (0.0, 1.0, 0.0, 0.0))
    tr2.scale(0.5, (1.0, 3.0, 1.0))
    tr3 = pkg.Transform()
    q = (np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0)
    tr3.rotate(0.0, q).rotate(0.0, q)
    return tr, tr2, tr3


def test_transform_mutators_match_reference():
    for a, b in zip(_mutations(tt), _mutations(rt)):
        assert a.times == b.times
        for field in ("translations", "scales", "rotations"):
            assert [tuple(map(float, k)) for k in getattr(a, field)] == \
                [tuple(map(float, k)) for k in getattr(b, field)], field
        assert a.is_identity() == b.is_identity()
    tr, tr2, tr3 = _mutations(tt)
    assert tr.times == [0.0, 1.0] and tr.translations[1] == (0.0, -2.0, -2.0)
    assert tr2.times == [-1.0, 0.0, 0.25, 0.5, 1.0]
    np.testing.assert_allclose(tr3.rotations[0], (0.0, 0.0, 1.0, 0.0),
                               atol=1e-7)
    assert tt.Transform().is_identity() and not tr3.is_identity()
