"""The three CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips where torch finds no CUDA device. The file
imports neither jax nor rayito_tpu, so it also runs where JAX is not
installed; run it on a GPU machine from the repo root with

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

(``--noconftest``: the suite's conftest pins JAX to the CPU). The inputs
cover what the stage-6 frame of chip_smoke.py may not reach: more than 1024
clusters, far and padded boxes, zero direction components with origins on
box planes (the 0 * inf = NaN edge), dead steps, a live prefix shorter than
the launch, and out-of-range gather indices. Every comparison is exact:
kernel and plain version run the same IEEE float32 operations in the same
order, without contraction.
"""

import numpy as np
import pytest
import torch

from rayito_tpu_torch.accel import kernel_tables as tkt
from rayito_tpu_torch.ops.vec3 import V3
from rayito_tpu_torch.render import traverse as tv

pytestmark = pytest.mark.cuda

SB = 2048


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the CPU tests cover the plain versions")
    return torch.device("cuda", 0)


def _soat(o, d, tmax):
    n = o.shape[0]
    rows = np.concatenate(
        [o, d, tmax[:, None], np.zeros((n, 1), np.float32)], axis=1
    ).astype(np.float32)
    return rows.reshape(n // SB, SB, 8)


def _random_boxes(rs, c):
    lo = rs.uniform(-20, 19, (3, c)).astype(np.float32)
    hi = lo + rs.uniform(0.1, 2.0, (3, c)).astype(np.float32)
    return np.concatenate([lo, hi, np.zeros((2, c), np.float32)], axis=0)


def _random_rays(rs, n, spread=25.0):
    o = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _mask_case(name):
    rs = np.random.default_rng(5)
    if name == "nan_edge":
        g = np.arange(8, dtype=np.float32)
        gx, gy, gz = np.meshgrid(g, g, g[:2], indexing="ij")
        lo = np.stack([gx.ravel(), gy.ravel(), gz.ravel()]) * 2.0
        c = lo.shape[1]
        box = np.concatenate([lo, lo + 1.0, np.zeros((2, c), np.float32)])
        n = 2 * SB
        k = rs.integers(0, c, n)
        o = (lo[:, k] + rs.integers(0, 2, (3, n))).T.astype(np.float32)
        o += rs.choice(np.float32([0.0, 0.5, -0.5]), (n, 3))
        d = np.zeros((n, 3), np.float32)
        axis = rs.integers(0, 3, n)
        d[np.arange(n), axis] = rs.choice(np.float32([1.0, -1.0]), n)
        tilt = rs.random(n) < 0.3
        d[tilt, (axis[tilt] + 1) % 3] = 0.6
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tmax = np.full(n, 40.0, np.float32)
        tmax[SB:] = 0.0  # a dead step
        return _soat(o, d, tmax), box, 0.0
    box = _random_boxes(rs, 1920 if name == "groups" else 2816)
    if name == "padded":
        box[1, 2048:] += 400.0
        box[4, 2048:] += 400.0
        box[0:6, 2712:] = 1e30
    o, d = _random_rays(rs, 2 * SB)
    tmax = np.full(2 * SB, np.inf, np.float32)
    tmax[SB:] = rs.uniform(1, 50, SB)
    tmax[:64] = 0.0
    return _soat(o, d, tmax), box, 1e-4


@pytest.mark.parametrize("case", ["groups", "padded", "nan_edge"])
@pytest.mark.parametrize("live", [None, 1])
def test_cluster_masks_kernel_matches_plain(dev, case, live):
    soat, box, tmin = _mask_case(case)
    soat_d = torch.from_numpy(soat).to(dev)
    box_d = torch.from_numpy(box).to(dev)
    n_live = (None if live is None
              else torch.tensor([live], dtype=torch.int32, device=dev))
    got = tv.cluster_masks(soat_d, box_d, tmin, n_live)
    ref = tv.cluster_masks_plain(soat_d, box_d, tmin, n_live)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert bool(ref.any())
    if live == 1:
        assert not bool(got[SB // 128:].any())


@pytest.fixture(scope="module")
def tri_scene():
    rs = np.random.default_rng(7)
    n_tris = 700
    centers = np.cumsum(rs.normal(0, 0.3, (n_tris, 3)), 0).astype(np.float32)
    v0, v1, v2 = (centers + rs.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
                  for _ in range(3))
    kt = tkt.build_kernel_tables(v0, v1, v2, np.ones(n_tris, bool))
    n = 2 * SB
    o = (centers.mean(0) + rs.normal(0, 25, (n, 3))).astype(np.float32)
    d = centers[rs.integers(0, n_tris, n)] - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[n // 2:] = rs.uniform(1.0, 40.0, n - n // 2)
    tmax[-50:] = 0.0
    return dict(o=o, d=d, tmax=tmax, box=kt.cl_box, vpu=kt.tri,
                bw=tkt.build_bw_rows(kt.tri))


MODES = [("bw", False), ("vpu", False), ("vpu", True)]


@pytest.mark.parametrize("mt,any_hit", MODES)
def test_traverse_blocks_kernel_matches_plain(dev, tri_scene, mt, any_hit):
    s = tri_scene
    box = torch.from_numpy(s["box"]).to(dev)
    tri = torch.from_numpy(s["bw" if mt == "bw" else "vpu"]).to(dev)
    o, d = (V3(*(torch.from_numpy(s[k][:, i].copy()).to(dev)
                 for i in range(3))) for k in ("o", "d"))
    tmax = torch.from_numpy(s["tmax"]).to(dev)
    soat, _, n_live = tv.prepare_rays(o, d, tmax, box, 1e-4)
    masks = tv.cluster_masks(soat, box, 1e-4, n_live)
    t_k, p_k = tv.traverse_blocks(masks, soat, tri, 1e-4, mt, any_hit, n_live)
    t_p, p_p = tv.traverse_blocks_plain(masks, soat, tri, 1e-4, mt, any_hit,
                                        n_live)
    torch.cuda.synchronize()
    assert int((p_p >= 0).sum()) > 100
    if any_hit:
        assert torch.equal(p_k >= 0, p_p >= 0)
    else:
        assert torch.equal(p_k, p_p)
        assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))


@pytest.mark.parametrize("mt,any_hit", MODES)
def test_traverse_on_the_card_matches_the_cpu(dev, tri_scene, mt, any_hit):
    """traverse() through the kernels equals traverse() through the plain
    versions on the CPU, bit for bit."""
    s = tri_scene

    def run(device):
        o, d = (V3(*(torch.from_numpy(s[k][:, i].copy()).to(device)
                     for i in range(3))) for k in ("o", "d"))
        t, p = tv.traverse(
            o, d, torch.from_numpy(s["tmax"]).to(device),
            torch.from_numpy(s["box"]).to(device),
            torch.from_numpy(s["bw" if mt == "bw" else "vpu"]).to(device),
            1e-4, want_t=not any_hit, mt_mode=mt, any_hit=any_hit)
        return (None if t is None else t.cpu()), p.cpu()

    t_c, p_c = run(torch.device("cpu"))
    t_g, p_g = run(dev)
    assert torch.equal(p_g, p_c)
    if not any_hit:
        assert torch.equal(t_g.view(torch.int32), t_c.view(torch.int32))


@pytest.mark.parametrize("k", [16, 32])
def test_gather_rows_t_kernel_matches_plain(dev, k):
    rs = np.random.default_rng(40 + k)
    table = torch.from_numpy(rs.normal(size=(3000, k)).astype(np.float32))
    idx = rs.integers(-5, 3010, 5000).astype(np.int32)  # some out of range
    table, idx = table.to(dev), torch.from_numpy(idx).to(dev)
    got = tv.gather_rows_t(table, idx)
    ref = tv.gather_rows_t_plain(table, idx)
    torch.cuda.synchronize()
    assert got.shape == (k, 5000)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
