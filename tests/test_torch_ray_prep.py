"""The traversal's plumbing kernels' wrappers on the CPU
(``rayito_tpu_torch/render/traverse.py``: ``ray_pack``, ``ray_reorder``,
``ray_unsort`` and ``prepare_rays`` around the coherence sort).

  * ``prepare_rays`` equals the plumbing as it was written before the
    split into the three wrappers (kept below as ``_unsplit_prepare``), bit
    for bit: rows, permutation, live steps and the live-ray counter, on a
    ragged launch, an exact one, a launch of exactly 2^17 lanes (the
    packed sort) and one past it (the stable sort), with and without the
    sort, the live prefix and tracing, and with a scalar tmax;
  * ``ray_unsort_plain`` equals the former inline scatter of
    ``traverse()`` (``_unsplit_unsort``) for closest and any hits, with and
    without t and the sort;
  * each wrapper takes its plain twin for CPU tensors and counts no
    launch; a wrong dtype, rank, width or length raises before anything
    runs;
  * ``traverse()`` calls each wrapper once per call (``ray_reorder`` not
    without the sort).

The kernels against their plain twins on the card are in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from rayito_tpu_torch.ops.vec3 import V3
from rayito_tpu_torch.render import traverse as tv
from rayito_tpu_torch.utils import tracing

SB = 2048
MISS = 1 << 30


def _unsplit_prepare(o, d, tmax, cl_box, tmin, sort_rays=True, sb=SB,
                     live_prefix=True):
    """prepare_rays as one plain function, before the split into ray_pack,
    the sort and ray_reorder."""
    n = o.x.shape[0]
    dev = cl_box.device
    n_steps = max(1, -(-n // sb))
    n_tot = n_steps * sb
    soa8 = torch.zeros((n_tot, 8), dtype=torch.float32, device=dev)
    soa8[n:, 3:6] = 1.0
    for k, comp in enumerate((o.x, o.y, o.z, d.x, d.y, d.z)):
        soa8[:n, k] = comp
    soa8[:n, 6] = tmax
    if not sort_rays and not tracing.enabled():
        return soa8.view(n_steps, sb, 8), None, None
    col = lambda k: soa8[:, k]
    key = tv.coherence_key(col(0), col(1), col(2), col(3), col(4), col(5),
                           col(6), cl_box, float(tmin))
    if live_prefix or tracing.enabled():
        live_cnt = (key < MISS).sum(dtype=torch.int32)
        tracing.count("traverse.live_rays", live_cnt)
    if not sort_rays:
        return soa8.view(n_steps, sb, 8), None, None
    n_live = None
    if live_prefix:
        n_live = ((live_cnt + sb - 1) // sb).to(torch.int32).reshape(1)
    lane_ids = torch.arange(n_tot, dtype=torch.int32, device=dev)
    if n_tot <= (1 << 17):
        packed = ((key >> 17) << 17) | lane_ids
        perm = torch.sort(packed).values & ((1 << 17) - 1)
    else:
        perm = torch.sort(key, stable=True).indices.to(torch.int32)
    return soa8[perm].view(n_steps, sb, 8), perm, n_live


def _unsplit_unsort(t_bn, p_bn, perm, n, any_hit, want_t):
    """traverse()'s unsort as it was written inline."""
    if any_hit and not want_t:
        p_bn = torch.where(p_bn >= 0, 0, -1).to(torch.int32)
    if perm is not None:
        prim = torch.empty_like(p_bn)
        prim[perm.long()] = p_bn
        if want_t:
            t = torch.empty_like(t_bn)
            t[perm.long()] = t_bn
    else:
        prim, t = p_bn, t_bn
    return (t[:n] if want_t else None), prim[:n]


def _boxes(rs, c=96, pads=32):
    """A [8, c + pads] box table, the pad columns at the 1e30 point."""
    lo = rs.uniform(-20, 19, (3, c)).astype(np.float32)
    hi = lo + rs.uniform(0.1, 2.0, (3, c)).astype(np.float32)
    box = np.concatenate([lo, hi, np.zeros((2, c), np.float32)], axis=0)
    pad = np.zeros((8, pads), np.float32)
    pad[:6] = 1e30
    return torch.from_numpy(np.concatenate([box, pad], axis=1))


def _rays(n, seed=3):
    """n seeded rays at the boxes, with the edge lanes the key must keep:
    zero direction components (1 / 0 = inf, 0 * inf = NaN), origins on a
    box plane, NaN and infinite components, tmax 0, tmin, NaN and inf."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-30, 30, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, np.inf, np.float32)
    tmax[n // 2:] = rs.uniform(0.5, 60.0, n - n // 2)
    k = min(n, 64)
    d[:k // 4, 0] = 0.0
    d[k // 4:k // 2, 1] = -0.0
    o[:k // 8, 1] = 0.0
    o[k // 2:k // 2 + 2] = np.nan
    d[k // 2 + 2:k // 2 + 4, 2] = np.inf
    tmax[k // 2 + 4:k // 2 + 8] = [0.0, 1e-4, np.nan, -1.0]
    box = _boxes(rs)
    v = lambda a: V3(*(torch.from_numpy(a[:, i].copy()) for i in range(3)))
    return v(o), v(d), torch.from_numpy(tmax), box


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


PREPARE_CASES = [
    # (n, sort_rays, live_prefix, tracing)
    (2 * SB - 37, True, True, False),
    (2 * SB, True, False, False),
    (2 * SB - 37, False, True, False),
    (2 * SB - 37, False, True, True),
    (2 * SB - 37, True, True, True),
    (1 << 17, True, True, True),
    ((1 << 17) + 1, True, True, True),
    ((1 << 17) + 1, True, False, False),
]


@pytest.mark.parametrize("n,sort_rays,live_prefix,traced", PREPARE_CASES)
def test_prepare_rays_equals_the_unsplit_plumbing(n, sort_rays, live_prefix,
                                                  traced):
    o, d, tmax, box = _rays(n)
    out = {}
    for name, fn in (("split", tv.prepare_rays), ("unsplit",
                                                  _unsplit_prepare)):
        tracing.reset()
        with tracing.on(traced):
            out[name] = fn(o, d, tmax, box, 1e-4, sort_rays, SB, live_prefix)
            out[name] += (tracing.counters().get("traverse.live_rays"),)
    tracing.reset()
    for got, ref in zip(out["split"], out["unsplit"]):
        assert _same(got, ref) if torch.is_tensor(ref) or ref is None \
            else got == ref
    soat, perm, n_live, live = out["split"]
    assert soat.shape == (-(-n // SB), SB, 8)
    assert (perm is None) == (not sort_rays)
    assert (n_live is None) == (not (sort_rays and live_prefix))
    assert (live is None) == (not traced)
    if traced:
        assert 0 < live < n


def test_prepare_rays_takes_a_scalar_tmax():
    o, d, _, box = _rays(SB + 5)
    n = o.x.shape[0]
    ref = tv.prepare_rays(o, d, torch.full((n,), 7.5), box, 1e-4)
    for tmax in (7.5, torch.tensor(7.5), torch.tensor([7.5])):
        got = tv.prepare_rays(o, d, tmax, box, 1e-4)
        assert all(_same(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("n", [2 * SB - 37, (1 << 17) + 1])
def test_the_sorted_operand_puts_the_live_lanes_first(n):
    """The operand sorts every live lane (key below the miss flag) ahead
    of the rest, so ray_reorder can read the live count off the sorted
    operand; a packed operand holds the lane in its low 17 bits."""
    o, d, tmax, box = _rays(n)
    soa8, operand = tv.ray_pack_plain(o, d, tmax, box, 1e-4, SB)
    col = lambda k: soa8[:, k]
    key = tv.coherence_key(*(col(k) for k in range(7)), box, 1e-4)
    vals, idx = tv.coherence_sort(operand)
    live = int((key < MISS).sum())
    assert 0 < live < n
    assert bool((vals[:live] < MISS).all())
    assert bool((vals[live:] >= MISS).all())
    n_tot = soa8.shape[0]
    lanes = torch.arange(n_tot, dtype=torch.int32)
    if idx is None:
        assert torch.equal(operand & tv._LANE_MASK, lanes)
        assert torch.equal(operand >> 17, key >> 17)
    else:
        assert n_tot > 1 << 17 and torch.equal(operand, key)
    _, perm, n_live = tv.ray_reorder_plain(soa8, vals, idx, SB)
    assert int(n_live) == -(-live // SB)
    assert torch.equal(torch.sort(perm.long()).values, lanes.long())


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("want_t", [False, True])
@pytest.mark.parametrize("sort_rays", [False, True])
def test_ray_unsort_plain_equals_the_inline_scatter(any_hit, want_t,
                                                    sort_rays):
    rs = np.random.default_rng(11)
    n, n_tot = 3 * SB - 100, 3 * SB
    perm = (torch.from_numpy(rs.permutation(n_tot).astype(np.int32))
            if sort_rays else None)
    p_bn = torch.from_numpy(rs.integers(-1, 5000, n_tot).astype(np.int32))
    t_bn = torch.from_numpy(rs.uniform(0, 9, n_tot).astype(np.float32))
    t_bn[p_bn < 0] = np.inf
    ref = _unsplit_unsort(t_bn, p_bn, perm, n, any_hit, want_t)
    got = tv.ray_unsort_plain(p_bn, t_bn if want_t else None, perm, n,
                              hit_only=any_hit and not want_t)
    wrapped = tv.ray_unsort(p_bn, t_bn if want_t else None, perm, n,
                            hit_only=any_hit and not want_t)
    for out in (got, wrapped):
        assert _same(out[0], ref[0]) and _same(out[1], ref[1])
        assert out[1].shape == (n,)


def test_the_wrappers_take_their_plain_twins_on_the_cpu():
    o, d, tmax, box = _rays(SB + 9)
    for fn in (tv.ray_pack, tv.ray_reorder, tv.ray_unsort):
        fn.launches = 0
    for key in (True, False):
        got = tv.ray_pack(o, d, tmax, box, 1e-4, SB, key)
        ref = tv.ray_pack_plain(o, d, tmax, box, 1e-4, SB, key)
        assert all(_same(a, b) for a, b in zip(got, ref))
    soa8, operand = ref if ref[1] is not None else tv.ray_pack_plain(
        o, d, tmax, box, 1e-4, SB)
    vals, _ = tv.coherence_sort(operand)
    s_vals, s_idx = torch.sort(operand, stable=True)
    for args in ((soa8, vals, None, SB, True), (soa8, vals, None, SB, False),
                 (soa8, s_vals, s_idx, SB, True)):
        got = tv.ray_reorder(*args)
        ref = tv.ray_reorder_plain(*args)
        assert all(_same(a, b) for a, b in zip(got, ref))
    assert all(fn.launches == 0 for fn in
               (tv.ray_pack, tv.ray_reorder, tv.ray_unsort))


def _bad_calls():
    o, d, tmax, box = _rays(SB)
    f64 = V3(o.x.double(), o.y, o.z)
    soa8, operand = tv.ray_pack_plain(o, d, tmax, box, 1e-4, SB)
    vals, _ = tv.coherence_sort(operand)
    big = torch.zeros(((1 << 17) + SB, 8))
    big_vals = torch.zeros(((1 << 17) + SB,), dtype=torch.int32)
    p = torch.zeros(SB, dtype=torch.int32)
    t = torch.zeros(SB)
    perm = torch.arange(SB, dtype=torch.int32)
    return {
        "pack_f64_origin": lambda: tv.ray_pack(f64, d, tmax, box, 1e-4),
        "pack_2d_tmax": lambda: tv.ray_pack(o, d, tmax[:, None], box, 1e-4),
        "pack_short_tmax": lambda: tv.ray_pack(o, d, tmax[:-1], box, 1e-4),
        "pack_six_box_rows": lambda: tv.ray_pack(o, d, tmax, box[:6], 1e-4),
        "pack_int_box": lambda: tv.ray_pack(o, d, tmax, box.int(), 1e-4),
        "pack_empty_box": lambda: tv.ray_pack(o, d, tmax, box[:, :0], 1e-4),
        "reorder_width_7": lambda: tv.ray_reorder(soa8[:, :7], vals),
        "reorder_i64_vals": lambda: tv.ray_reorder(soa8, vals.long()),
        "reorder_short_vals": lambda: tv.ray_reorder(soa8, vals[:-1]),
        "reorder_i32_idx": lambda: tv.ray_reorder(soa8, vals, vals),
        "reorder_packed_past_2_17": lambda: tv.ray_reorder(big, big_vals),
        "reorder_f64_rows": lambda: tv.ray_reorder(soa8.double(), vals),
        "unsort_f32_prim": lambda: tv.ray_unsort(t, t, perm, SB),
        "unsort_2d_prim": lambda: tv.ray_unsort(p[:, None], None, None, SB),
        "unsort_i64_perm": lambda: tv.ray_unsort(p, None, perm.long(), SB),
        "unsort_short_t": lambda: tv.ray_unsort(p, t[:-1], perm, SB),
        "unsort_short_perm": lambda: tv.ray_unsort(p, None, perm[:-1], SB),
        "unsort_n_past_slots": lambda: tv.ray_unsort(p, None, perm, SB + 1),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_the_wrappers_refuse_what_the_kernels_do_not_take(case):
    call = _bad_calls()[case]
    for fn in (tv.ray_pack, tv.ray_reorder, tv.ray_unsort):
        fn.launches = 0
    with pytest.raises(ValueError):
        call()
    assert all(fn.launches == 0 for fn in
               (tv.ray_pack, tv.ray_reorder, tv.ray_unsort))


@pytest.mark.parametrize("sort_rays", [False, True])
def test_traverse_calls_each_wrapper_once(monkeypatch, sort_rays):
    calls = []

    def spy(name):
        fn = getattr(tv, name)

        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    for name in ("ray_pack", "ray_reorder", "ray_unsort"):
        monkeypatch.setattr(tv, name, spy(name))
    o, d, tmax, box = _rays(SB - 3)
    tri = torch.zeros((box.shape[1], 16, 128))
    t, p = tv.traverse(o, d, tmax, box, tri, 1e-4, sort_rays=sort_rays,
                       slices=torch.zeros((box.shape[1], 4, 8)))
    assert t.shape == p.shape == (SB - 3,)
    assert calls == (["ray_pack", "ray_reorder", "ray_unsort"] if sort_rays
                     else ["ray_pack", "ray_unsort"])
