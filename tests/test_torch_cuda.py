"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips where torch finds no CUDA device. The file
imports neither jax nor rayito_tpu, so it also runs where JAX is not
installed; run it on a GPU machine from the repo root with

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

(``--noconftest``: the suite's conftest pins JAX to the CPU). The inputs
cover what the stage-6 frame of chip_smoke.py may not reach: more than 1024
clusters, far and padded boxes, diagonal rays that hit the lane pads, zero
direction components with origins on box planes (the 0 * inf = NaN edge),
dead steps, a live prefix shorter than the launch, a block whose rays reach
every mask word, and out-of-range gather indices; for the block traversal,
a key tie across mask words, a short live prefix, the run_if gate clear and
set, any-hit launches over many words, and a block listing every cluster of
a 1,920-cluster table; for the item traversal, at the big scene's shapes
(131,072 rays, more than 1,024 clusters), empty blocks, runs padded to a
multiple of w, keys tied with the initial key, a short group count, chunks
that cross a ray-block boundary, a block whose run spans several chunks, a
key tie across chunks, NaN tmax, pads and cluster ids past the tri table;
for the item list, random masks over a grid of budgets, all-zero masks, a
total of exactly maxitems and one past it, a block of exactly cap clusters
and one above it, a block that lists all 1,920 clusters, w = 1 and 8; and
traverse() on both routes, which must not wait on the device; and, on
stage 7's rotating mesh, rays in the mesh's local space at several times
through masks, block traversal and gathers, and the stage-7 scene_intersect
on the card against the CPU; and, for the mesh lights and the scenes above
the fold thresholds: mesh-light sampling on the card against the CPU, the
mesh-light and many-shape ``pathtrace_wave`` under the sync debug mode,
``argmin`` ties on the card, and the 40-sphere ``scene_intersect`` on the
card against the CPU; and, for the CLI's surface: render_color and
render_direct on the card against the CPU, one render_direct pass under
the sync debug mode, a progressive render resumed from its checkpoint, and
cli.main on stage 6 through the three kernels; and, for the
traversal='xla' route, the two-level pipeline on the card against the CPU
(t, beta and gamma bits, prim and overflow, on a mesh that truncates),
its nearest-k on tied rows, its winner rows through gather_rows_t, the
cluster_pipeline kernel against its plain version on the truncating mesh,
a mesh whose boxes all tie and stage 6's camera, bounce and shadow rays,
and its passes captured as graphs (stage 6 and the overflowing stack) and
replayed through render_path_with_stats, render_progressive and the
sharded render; and
the single draws (hash_combine, cmj_sample_1d, cmj_sample_2d: torch ops,
no kernel) on the card against the same calls on the CPU at nums that
walk and nums that do not, with int32 and int64 operands, 0-d and
immediate permutations and the multiplier-and-addend index, no launch
counted, the draw-set kernel (cmj_draws) against cmj_draws_plain on every
renderer's plan at pixel samples {1, 2, 3, 12} x light samples {1, 2}, a
plan split into three launches and a set replayed in a graph, and
build_items replayed five times in one graph over masks changed between
replays, at both budgets and with cuts at and inside a tile, and
fold_small (every tiny mesh of a query in one launch) against its
plain twin on stage 7b's ten cubes (in one launch, and cut into four
chained launches), a one-key cube, a cube in a turning group and a
192-row mesh whose every hit ties with a twin row, closest and any hit;
and analytic_fold (every plane, sphere and rect of a query in one
launch, each keyed row's chain inside it) against its plain twin on
131,072 seeded lanes of camera, bounce and shadow populations of stage 6,
stage 7, stage 7b, stage 5, the mesh light, sixteen lights, forty moving
spheres, a depth-3 and a depth-12 group chain and rows that tie exactly (twin planes and
spheres, a rect lying on the planes, 155 rows in two chained launches),
NaN and infinite lanes among them, closest and any hit; the same queries
in chained launches under cut limits; one launch per query in a replayed
pass; and the bounce's shading (bounce_prepare, bounce_resolve) against its
plain versions on the eager pass's own inputs at bounces 0 and 1 of stage
6, stage 7 (also at lane times outside its keys), the mesh light and
sixteen lights at light_samples=2, one launch of each per bounce in a
replayed pass, the pair captured in a graph and replayed, and the
wrappers' refusals (a plain-made prep on the card, mixed devices); and
tracing (utils/tracing.py): on stage 6 and on the benchmark's five-domain
``big_instanced``, a traced pass replays the untraced bits, every device
span comes back from the log and from the profiler's trace with durations
that agree (a ``domain`` span a traversal domain in every mesh query, a
``domain_merge`` in each), an untraced graph holds no marker or counter
add; and the device counters equal the host-plain counts; the tiny-mesh
fold's counters (tests, links, lanes) equal its plain twin's on a
131,072-lane stage-7b band in one and in chained launches, an untraced
stage-7b pass graph adds nothing to them, a tiny mesh nine and twelve
links deep runs in the kernel, its chain in the launch's slot table, bit
for bit with the twin and replays, and the stage-7 tumbling
cell's render (two samples a launch) replays its eager bodies bit for
bit; and the fold's slice cull: traverse_blocks at ray blocks of 128, 256
and 512 and traverse_items bit for bit with their plain folds on camera,
bounce and shadow rays of stage 6 and stage 7's moving domain, the
slices run equal to the plain count, and on a traced pass at most 16 a
(block, cluster) pair, none on an untraced one; and ray_pack through a
traversal domain's transform chain (stage 7's three-key mesh at lane
times before, on and past its keys, each of big_instanced's four one-key
copies, a nested two-link chain) bit for bit with its plain twin and
ops/transform.py local_ray (rows, operand, local ray, rotation, live
rays), the depth-0 instance on the world ray, and traverse() through the
chain with traverse() of the local ray; and the analytic fold's counters
(row tests by kind, a query's lanes) equal its plain twin's on the
256-light rig (three chained launches a query) and stage 7, nothing added
with tracing off; and the shading past its old limits (65 lights, a light
nine links deep, the 256-light rig of ``stage6_lights256``) beside stage
6 and 7: the light table read from the scene's device memory, both
kernels bit for bit with their plain twins, and a whole eager pass
through them equal to one through the twins. The launch counters
count only with tracing on, so each test that reads them turns it on
around what it counts, captures included.
Every kernel comparison is exact: kernel and plain version run the same
IEEE float32 operations in the same order, without contraction.
"""

import numpy as np
import pytest
import torch

from rayito_tpu_torch.accel import kernel_tables as tkt
from rayito_tpu_torch.ops import transform as xf
from rayito_tpu_torch.ops.vec3 import V3
from rayito_tpu_torch.render import traverse as tv
from rayito_tpu_torch.utils import cuda_lib, tracing

pytestmark = pytest.mark.cuda

SB = 2048


@pytest.fixture(autouse=True)
def _tracing_off():
    """Tracing (utils/tracing.py) is off in every test unless the test
    turns it on; a failed test leaves it off for the next."""
    yield
    tracing.enable(False)


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
    if name == "spanning":
        # a 16 x 16 x 8 grid of unit boxes in grid order (64 words of
        # neighbours); each block's rays start at one point and ray k aims
        # at the centre of word k % 64's first box, so every block lists
        # clusters of every word
        g = np.arange(16, dtype=np.float32)
        gx, gy, gz = np.meshgrid(g, g, g[:8], indexing="ij")
        lo = np.stack([gx.ravel(), gy.ravel(), gz.ravel()]) * 1.5
        box = np.concatenate([lo, lo + 1.0, np.zeros((2, lo.shape[1]),
                                                     np.float32)])
        n = 2 * SB
        o = np.repeat(rs.uniform(-2, 26, (n // 128, 3)), 128, axis=0)
        target = lo[:, 32 * (np.arange(n) % 64)].T + 0.5
        d = target - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return _soat(o.astype(np.float32), d.astype(np.float32),
                     np.full(n, np.inf, np.float32)), box, 1e-4
    box = _random_boxes(rs, 1920 if name == "groups" else 2816)
    if name == "padded":
        box[1, 2048:] += 400.0
        box[4, 2048:] += 400.0
        box[0:6, 2712:] = 1e30
    o, d = _random_rays(rs, 2 * SB)
    tmax = np.full(2 * SB, np.inf, np.float32)
    tmax[SB:] = rs.uniform(1, 50, SB)
    tmax[:64] = 0.0
    if name == "padded":
        # diagonal rays with an infinite tmax hit the 1e30 pad boxes
        d[64:80] = np.float32(1.0 / np.sqrt(np.float32(3.0)))
        tmax[64:80] = np.inf
    return _soat(o, d, tmax), box, 1e-4


@pytest.mark.parametrize("case", ["groups", "padded", "nan_edge",
                                  "spanning"])
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
    if case == "padded":
        assert int(ref[0, -1]) == -1  # every pad of the last word
    if case == "spanning":
        assert bool((ref[:SB // 128] != 0).all())


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
                bw=tkt.build_bw_rows(kt.tri),
                slices=tkt.build_slice_boxes(kt.tri))


def _tables(kt, dev):
    """A domain's MT rows, BW rows and slice boxes on ``dev``."""
    return {"vpu": torch.from_numpy(kt.tri).to(dev),
            "bw": torch.from_numpy(tkt.build_bw_rows(kt.tri)).to(dev),
            "slices": torch.from_numpy(tkt.build_slice_boxes(kt.tri)).to(dev)}


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
    t_k, p_k = tv.traverse_blocks(masks, soat, tri, 1e-4, mt, any_hit, n_live,
                                  slices=torch.from_numpy(s["slices"]).to(dev))
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
            1e-4, want_t=not any_hit, mt_mode=mt, any_hit=any_hit,
            slices=torch.from_numpy(s["slices"]).to(device))
        return (None if t is None else t.cpu()), p.cpu()

    t_c, p_c = run(torch.device("cpu"))
    t_g, p_g = run(dev)
    assert torch.equal(p_g, p_c)
    if not any_hit:
        assert torch.equal(t_g.view(torch.int32), t_c.view(torch.int32))


def _blocks_both(masks, soat, tri, mt, any_hit=False, n_live=None,
                 run_if=None, *, slices):
    got = tv.traverse_blocks(masks, soat, tri, 1e-4, mt, any_hit, n_live,
                             run_if=run_if, slices=slices)
    ref = tv.traverse_blocks_plain(masks, soat, tri, 1e-4, mt, any_hit,
                                   n_live, run_if=run_if)
    torch.cuda.synchronize()
    return got, ref


def _check_blocks(got, ref, any_hit):
    (t_k, p_k), (t_p, p_p) = got, ref
    if any_hit:
        assert torch.equal(p_k >= 0, p_p >= 0)
    else:
        assert torch.equal(p_k, p_p)
        assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))


TIE_LANES = (0, 3, 64, 127)


def _tie_case(dev):
    """Triangle 37 * 128 + j repeats triangle 5 * 128 + j (clusters 5 and
    37: mask words 0 and 1) for j in TIE_LANES, each in the plane z = 2;
    every other triangle lies beyond z = 50; one ray straight up at each
    pair (tests/test_torch_traverse.py holds the reference to the same
    input)."""
    rs = np.random.default_rng(31)
    n_tri = 40 * 128
    v0, v1, v2 = (np.float32(rs.uniform(-5, 5, (n_tri, 3))) for _ in range(3))
    for v in (v0, v1, v2):
        v[:, 2] += 60.0
    rows = np.zeros((SB, 8), np.float32)
    rows[:, 3:6] = 1.0
    for i, j in enumerate(TIE_LANES):
        x = 10.0 * i
        for t in (5 * 128 + j, 37 * 128 + j):
            v0[t], v1[t], v2[t] = (x - 2, -2, 2), (x + 2, -2, 2), (x, 2, 2)
        rows[i] = (x, 0, 0, 0, 0, 1, np.inf, 0)
    kt = tkt.build_kernel_tables(v0, v1, v2, np.ones(n_tri, bool))
    soat = torch.from_numpy(rows.reshape(1, SB, 8)).to(dev)
    box = torch.from_numpy(kt.cl_box).to(dev)
    return soat, box, _tables(kt, dev)


@pytest.mark.parametrize("mt", ["bw", "vpu"])
def test_traverse_blocks_key_tie_across_words(dev, mt):
    """Equal keys in clusters 5 and 37, listed in two mask words (two work
    units of the kernel, merged in any order): the lower cluster wins."""
    soat, box, tri = _tie_case(dev)
    masks = tv.cluster_masks(soat, box, 1e-4)
    got, ref = _blocks_both(masks, soat, tri[mt], mt, slices=tri["slices"])
    _check_blocks(got, ref, False)
    want = torch.tensor([5 * 128 + j for j in TIE_LANES], dtype=torch.int32)
    assert torch.equal(got[1].view(-1)[:len(TIE_LANES)].cpu(), want)


@pytest.mark.parametrize("case", ["short_live", "run_if_set",
                                  "run_if_clear"])
@pytest.mark.parametrize("mt,any_hit", MODES)
def test_traverse_blocks_gates(dev, big_items, case, mt, any_hit):
    """A live prefix shorter than the launch (later steps are misses), and
    the run_if gate: set, the launch runs; clear, it writes nothing."""
    s = big_items
    masks, soat, tri = s["masks"], s["soat"], s["tri"][mt]
    slices = s["tri"]["slices"]
    if case == "short_live":
        n_live = torch.tensor([3], dtype=torch.int32, device=dev)
        got, ref = _blocks_both(masks, soat, tri, mt, any_hit, n_live,
                                slices=slices)
        _check_blocks(got, ref, any_hit)
        assert not bool((got[1][3:] >= 0).any())
        assert bool((got[1][:3] >= 0).any())
        return
    flag = torch.tensor(case == "run_if_set", device=dev)
    if case == "run_if_set":
        got, ref = _blocks_both(masks, soat, tri, mt, any_hit, run_if=flag,
                                slices=slices)
        _check_blocks(got, ref, any_hit)
        assert int((ref[1] >= 0).sum()) > N_BIG // 8
        return
    t = torch.full(soat.shape[:2] + (1,), 7.0, device=dev)
    p = torch.full(soat.shape[:2] + (1,), 7, dtype=torch.int32, device=dev)
    lib, stream = cuda_lib.launch_args("traverse_blocks", masks, soat, tri)
    n = soat.shape[0] * SB
    n_units = masks.shape[0] * masks.shape[1]
    scratch = torch.zeros(n + (n_units + 5) // 2, dtype=torch.int64,
                          device=dev)
    cuda_lib.check(lib.rt_traverse_blocks(
        masks.data_ptr(), soat.data_ptr(), tri.data_ptr(), slices.data_ptr(),
        None, flag.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + 8 * n,
        t.data_ptr(), p.data_ptr(), None, masks.shape[0], 128,
        masks.shape[1], tri.shape[0], SB, soat.shape[0], 1e-4,
        int(mt == "bw"), int(any_hit), stream), "traverse_blocks")
    torch.cuda.synchronize()
    assert bool((t == 7.0).all()) and bool((p == 7).all())
    assert not bool(scratch.any())


@pytest.fixture(scope="module")
def all_words(dev):
    """1,920 clusters of random triangles (C_pad 1,920, 60 mask words),
    rays aimed at them, and masks whose first block lists every cluster."""
    rs = np.random.default_rng(13)
    n_tris = 1920 * 128
    centers = np.cumsum(rs.normal(0, 0.05, (n_tris, 3)), 0).astype(np.float32)
    v0, v1, v2 = (centers + rs.normal(0, 0.05, (n_tris, 3)).astype(np.float32)
                  for _ in range(3))
    kt = tkt.build_kernel_tables(v0, v1, v2, np.ones(n_tris, bool))
    n = 4 * SB
    o = (centers.mean(0) + rs.normal(0, 8, (n, 3))).astype(np.float32)
    d = centers[rs.integers(0, n_tris, n)] - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    box = torch.from_numpy(kt.cl_box).to(dev)
    assert box.shape[1] == 1920
    tri = _tables(kt, dev)
    tmax = np.full(n, np.inf, np.float32)
    soat = torch.from_numpy(_soat(o, d, tmax)).to(dev)
    masks = tv.cluster_masks(soat, box, 1e-4)
    masks[0] = -1
    return dict(soat=soat, box=box, tri=tri, masks=masks)


@pytest.mark.parametrize("mt,any_hit", MODES)
def test_traverse_blocks_block_lists_every_cluster(dev, all_words, mt,
                                                   any_hit):
    """C_pad 1,920: block 0 lists all 1,920 clusters (60 full words, each a
    heavy unit), the other blocks their own lists."""
    s = all_words
    got, ref = _blocks_both(s["masks"], s["soat"], s["tri"][mt], mt,
                            any_hit, slices=s["tri"]["slices"])
    _check_blocks(got, ref, any_hit)
    assert int((ref[1][0, :128] >= 0).sum()) > 64


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


# ------------------------------------------------------ item traversal

N_BIG = 64 * SB  # one 131,072-ray band of the big scene


@pytest.fixture(scope="module")
def big_items(dev):
    """1,100 clusters of random triangles (more than 1,024), a big-scene
    band of rays aimed at them (the last 4,096 dead: empty blocks), their
    sorted kernel rows and masks."""
    rs = np.random.default_rng(11)
    n_tris = 1100 * 128
    centers = np.cumsum(rs.normal(0, 0.05, (n_tris, 3)), 0).astype(np.float32)
    v0, v1, v2 = (centers + rs.normal(0, 0.05, (n_tris, 3)).astype(np.float32)
                  for _ in range(3))
    kt = tkt.build_kernel_tables(v0, v1, v2, np.ones(n_tris, bool))
    o = (centers.mean(0) + rs.normal(0, 8, (N_BIG, 3))).astype(np.float32)
    d = centers[rs.integers(0, n_tris, N_BIG)] - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.full(N_BIG, np.inf, np.float32)
    tmax[N_BIG // 2:] = rs.uniform(1.0, 20.0, N_BIG // 2)
    tmax[-2 * SB:] = 0.0
    box = torch.from_numpy(kt.cl_box).to(dev)
    tri = _tables(kt, dev)
    rays = tuple(V3(*(torch.from_numpy(a[:, i].copy()).to(dev)
                      for i in range(3))) for a in (o, d))
    tmax_d = torch.from_numpy(tmax).to(dev)
    soat, _, n_live = tv.prepare_rays(*rays, tmax_d, box, 1e-4)
    masks = tv.cluster_masks(soat, box, 1e-4, n_live)
    return dict(box=box, tri=tri, rays=rays, tmax=tmax_d, soat=soat,
                masks=masks, c_pad=box.shape[1])


def _items_both(big, mt, w, n_steps=None, soat=None):
    soat = big["soat"] if soat is None else soat
    nblk = big["masks"].shape[0]
    items, steps, overflow, used = tv.build_items(
        big["masks"], w, nblk * big["c_pad"], big["c_pad"])
    if n_steps is not None:
        steps = torch.full_like(steps, n_steps)
    soab = soat.view(nblk, 128, 8)
    got = tv.traverse_items(items, steps, soab, big["tri"][mt], 1e-4, mt, w,
                            slices=big["tri"]["slices"])
    ref = tv.traverse_items_plain(items, steps, soab, big["tri"][mt], 1e-4,
                                  mt, w)
    torch.cuda.synchronize()
    return got, ref, overflow, used


def _equal(got, ref):
    (t_k, p_k), (t_p, p_p) = got, ref
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))


CHUNK = 32  # items per chunk of the item kernel, at most


def _crosses_blocks(items, n_items):
    """Some chunk of the list holds items of two ray blocks."""
    bids = (items[:n_items] >> tv.CID_BITS).cpu()
    firsts = bids[::CHUNK]
    lasts = bids[torch.clamp_max(torch.arange(CHUNK - 1, n_items + CHUNK - 1,
                                              CHUNK), n_items - 1)]
    return bool((firsts != lasts).any())


@pytest.mark.parametrize("mt", ["bw", "vpu"])
@pytest.mark.parametrize("w", [1, 4, 8])
def test_traverse_items_kernel_matches_plain(dev, big_items, mt, w):
    """Every block's run, its w pads and its empty blocks, with chunks that
    cross ray-block boundaries; the result is also the scan kernel's, bit
    for bit."""
    got, ref, overflow, used = _items_both(big_items, mt, w)
    assert not bool(overflow) and not bool(used.all()) and bool(used.any())
    counts = torch.stack([(big_items["masks"] >> k) & 1
                          for k in range(32)]).sum(dim=(0, 2))
    if w > 1:
        assert bool((counts % w != 0).any())  # pads exist
    items = tv.build_items(big_items["masks"], w, N_BIG // 128 *
                           big_items["c_pad"], big_items["c_pad"])[0]
    assert _crosses_blocks(items, int((items >= 0).sum()))
    _equal(got, ref)
    assert int((ref[1] >= 0).sum()) > N_BIG // 8
    scan = tv.traverse_blocks(big_items["masks"], big_items["soat"],
                              big_items["tri"][mt], 1e-4, mt,
                              slices=big_items["tri"]["slices"])
    torch.cuda.synchronize()
    _equal((got[0].view(scan[0].shape), got[1].view(scan[1].shape)), scan)


@pytest.mark.parametrize("mt", ["bw", "vpu"])
def test_traverse_items_tie_with_initial_key(dev, big_items, mt):
    """Rays whose tmax is their own hit's t: the initial key
    pack(min(tmax, 3e38), 127) then equals the hit's key when the winner
    sits in lane 127, and such a ray loses that hit."""
    first = _items_both(big_items, mt, 4)[0]
    t_hit, p_hit = first[0].reshape(-1), first[1].reshape(-1)
    found = p_hit >= 0
    soat = big_items["soat"].clone().view(-1, 8)
    soat[:, 6] = torch.where(found, t_hit, soat[:, 6])
    got, ref, _, _ = _items_both(big_items, mt, 4, soat=soat.view_as(
        big_items["soat"]))
    _equal(got, ref)
    lane127 = found & (p_hit % 128 == 127)
    assert int(lane127.sum()) > 0
    p_tied = got[1].reshape(-1)
    assert not bool((p_tied[lane127] == p_hit[lane127]).any())
    keep = found & (p_hit % 128 != 127)
    assert bool((p_tied[keep] >= 0).all())


@pytest.mark.parametrize("mt", ["bw", "vpu"])
def test_traverse_items_short_n_steps(dev, big_items, mt):
    """A group count below the list's: both versions fold only the first
    n_steps groups."""
    full = _items_both(big_items, mt, 4)[0]
    got, ref, _, _ = _items_both(big_items, mt, 4, n_steps=37)
    _equal(got, ref)
    assert int((ref[1] >= 0).sum()) < int((full[1] >= 0).sum())


@pytest.mark.parametrize("budget", ["overflow", "fits", "scan"])
def test_traverse_items_route_does_not_wait_on_the_device(dev, big_items,
                                                          budget):
    """traverse(items=True) with a list that overflows (the scan runs) and
    one that fits (the item kernel runs), both built by the build_items
    kernel, and the scan route itself
    (items=False), under the sync debug mode 'error': any host
    synchronisation in the route raises. All equal the plain scan."""
    c_pad = big_items["c_pad"]
    kw = (dict(items_max=8, items_cap=4) if budget == "overflow"
          else dict(items_max=N_BIG // 128 * c_pad, items_cap=c_pad))
    if budget == "scan":
        kw = dict(items=False)
    else:
        kw["items"] = True
    o, d = big_items["rays"]
    args = (o, d, big_items["tmax"], big_items["box"], big_items["tri"]["bw"],
            1e-4)
    kw["slices"] = big_items["tri"]["slices"]
    _swap = (tv.cluster_masks, tv.traverse_blocks)
    tv.cluster_masks, tv.traverse_blocks = (tv.cluster_masks_plain,
                                            tv.traverse_blocks_plain)
    try:
        scan = tv.traverse(*args, mt_mode="bw", slices=kw["slices"])
    finally:
        tv.cluster_masks, tv.traverse_blocks = _swap
    tv.traverse(*args, mt_mode="bw", **kw)  # warm-up
    torch.cuda.synchronize()
    kernels = ((tv.traverse_blocks,) if budget == "scan"
               else (tv.traverse_items, tv.build_items))
    before = [k.launches for k in kernels]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tv.traverse(*args, mt_mode="bw", **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [n + 1 for n in before]
    _equal(got, scan)


def _items_case(masks, soat, tri, mt, w, maxitems=None, cap=None, *,
                slices):
    """The item kernel against its plain version on the list that the
    build_items kernel makes from ``masks`` (checked against its plain
    version first); by default a budget that never overflows."""
    n_words = masks.shape[1]
    maxitems = masks.shape[0] * n_words * 32 if maxitems is None else maxitems
    cap = n_words * 32 if cap is None else cap
    lst = tv.build_items(masks, w, maxitems, cap)
    _check_build(lst, tv.build_items_plain(masks, w, maxitems, cap))
    items, steps, overflow, _ = lst
    soab = soat.view(masks.shape[0], -1, 8)
    got = tv.traverse_items(items, steps, soab, tri, 1e-4, mt, w,
                            slices=slices)
    ref = tv.traverse_items_plain(items, steps, soab, tri, 1e-4, mt, w)
    torch.cuda.synchronize()
    _equal(got, ref)
    return got, items, int(steps) * w, bool(overflow)


@pytest.mark.parametrize("mt", ["bw", "vpu"])
def test_traverse_items_block_spans_chunks(dev, all_words, mt):
    """Block 0 lists all 1,920 clusters: its run spans 60 chunks, each
    merged into its rays' bests; the result is the scan's."""
    s = all_words
    got, items, n_items, _ = _items_case(s["masks"], s["soat"], s["tri"][mt],
                                         mt, 4, slices=s["tri"]["slices"])
    assert int((items[:1920] >> tv.CID_BITS == 0).sum()) == 1920
    scan = tv.traverse_blocks(s["masks"], s["soat"], s["tri"][mt], 1e-4, mt,
                              slices=s["tri"]["slices"])
    torch.cuda.synchronize()
    _equal((got[0].view(scan[0].shape), got[1].view(scan[1].shape)), scan)
    assert int((got[1][0] >= 0).sum()) > 64


@pytest.mark.parametrize("mt", ["bw", "vpu"])
def test_traverse_items_key_tie_across_chunks(dev, mt):
    """Block 0 lists clusters 0-39, so clusters 5 and 37, whose triangles
    tie, fall in two chunks (items 0-31 and 32-39): the lower cluster
    wins. Rays 4-7 carry NaN tmax of either sign and a payload."""
    soat, _, tri = _tie_case(dev)
    rows = soat.view(-1, 8)
    nans = torch.tensor([0x7FC00000, -0x00400000, 0x7F800001, -0x007FFFFF],
                        dtype=torch.int32).view(torch.float32)
    rows[4:8] = rows[0:4]
    rows[4:8, 6] = nans.to(dev)
    masks = torch.zeros((SB // 128, 2), dtype=torch.int32, device=dev)
    masks[0, 0], masks[0, 1] = -1, 0xFF
    got, _, n_items, _ = _items_case(masks, soat, tri[mt], mt, 4,
                                     slices=tri["slices"])
    assert n_items == 40
    want = torch.tensor([5 * 128 + j for j in TIE_LANES], dtype=torch.int32)
    assert torch.equal(got[1].view(-1)[:len(TIE_LANES)].cpu(), want)


@pytest.mark.parametrize("w", [4, 8])
def test_traverse_items_pads_and_clusters_past_the_table(dev, big_items, w):
    """Runs padded to w (w = 8: a block of one cluster gets seven pads)
    over a tri table 100 clusters shorter than the masks: ids past it read
    its last cluster and keep their own id in prim, as in the plain
    version."""
    s = big_items
    masks = s["masks"].clone()
    masks[1] = 0
    masks[1, 3] = 1 << 7
    tri = s["tri"]["bw"][:s["c_pad"] - 100].contiguous()
    slices = s["tri"]["slices"][:s["c_pad"] - 100].contiguous()
    got, items, n_items, _ = _items_case(masks, s["soat"], tri, "bw", w,
                                         slices=slices)
    cids = items[:n_items] & ((1 << tv.CID_BITS) - 1)
    assert bool((cids >= tri.shape[0]).any())
    assert bool((items[1:n_items] == items[:n_items - 1]).any())  # pads


# ------------------------------------------------------------- item list


def _check_build(got, ref):
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, r)


def _random_masks(rs, nblk=24, nw=4):
    bits = rs.random((nblk, nw, 32)) < rs.uniform(0.05, 0.6, (nblk, 1, 1))
    bits[rs.random(nblk) < 0.25] = False
    bits[3] = True
    words = (bits.astype(np.int64) << np.arange(32)).sum(-1)
    return np.where(words >= 2**31, words - 2**32, words).astype(np.int32)


# tests/test_torch_items.py's grid: fits, tight fit, overflow by total,
# overflow by cap, w = 1 and w = 8
BUDGETS = [(4, 3072, 128), (3, 1400, 100), (4, 300, 128), (4, 3072, 20),
           (1, 3072, 128), (8, 3072, 128)]
EDGES = ["zero", "total_is_max", "total_past_max", "count_is_cap",
         "count_past_cap"]


@pytest.mark.parametrize("budget", BUDGETS)
def test_build_items_kernel_matches_plain(dev, budget):
    w, maxitems, cap = budget
    rs = np.random.default_rng(100 + w + maxitems + cap)
    masks = torch.from_numpy(_random_masks(rs)).to(dev)
    got = tv.build_items(masks, w, maxitems, cap)
    _check_build(got, tv.build_items_plain(masks, w, maxitems, cap))


@pytest.mark.parametrize("w", [1, 4, 8])
@pytest.mark.parametrize("case", EDGES)
def test_build_items_edge_budgets(dev, case, w):
    """All-zero masks (n_steps 0), a total of exactly maxitems and one
    past it, a block of exactly cap clusters and one above it; 40 blocks
    of 60 words, more than one warp's worth of words per block."""
    masks = _random_masks(np.random.default_rng(w), nblk=40, nw=60)
    if case == "zero":
        masks[:] = 0
    counts = np.unpackbits(masks.view(np.uint8)).reshape(40, -1).sum(1)
    total = int((-(-counts // w) * w).sum())
    maxitems, cap = max(total, 1), int(max(counts.max(), 1))
    maxitems -= case == "total_past_max"
    cap -= case == "count_past_cap"
    masks = torch.from_numpy(masks).to(dev)
    got = tv.build_items(masks, w, maxitems, cap)
    _check_build(got, tv.build_items_plain(masks, w, maxitems, cap))
    assert bool(got[2]) == (case in ("total_past_max", "count_past_cap"))
    assert int(got[1]) == min(total, maxitems) // w
    if case == "zero":
        assert int(got[1]) == 0 and bool((got[0] == -1).all())


@pytest.mark.parametrize("budget", ["fits", "reference"])
def test_build_items_block_lists_every_cluster(dev, all_words, budget):
    """Block 0 lists all 1,920 clusters: at a budget that never overflows,
    and at the reference's 24,576 / 64, which overflows by cap."""
    masks = all_words["masks"]
    maxitems, cap = ((masks.shape[0] * 1920, 1920) if budget == "fits"
                     else (24576, 64))
    got = tv.build_items(masks, 4, maxitems, cap)
    _check_build(got, tv.build_items_plain(masks, 4, maxitems, cap))
    assert bool(got[2]) == (budget == "reference")


# ------------------------------------------------- stage 7: moving domain


@pytest.fixture(scope="module")
def stage7(dev, tmp_path_factory):
    """stage7_scene1 on the n=8 stand-in, compiled on the card and on the
    CPU, with camera rays at it from around its camera."""
    from rayito_tpu_torch.models import demo

    path = str(tmp_path_factory.mktemp("obj") / "bumpy8.obj")
    demo.write_bumpy_standin(path, n=8)
    rs = np.random.default_rng(11)
    n = 2 * SB
    o = (np.asarray(demo.STAGE7_CAMERA[0])
         + rs.uniform(-1.0, 1.0, (n, 3))).astype(np.float32)
    tgt = np.asarray([0.2, -0.5, 0.0]) + rs.normal(0.0, 1.8, (n, 3))
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    return dict(card=demo.stage7_scene1(path).compile(dev),
                cpu=demo.stage7_scene1(path).compile("cpu"),
                o=o, d=d.astype(np.float32),
                time=rs.uniform(0.0, 1.0, n).astype(np.float32))


def _v3_on(a, device):
    return V3(*(torch.from_numpy(a[:, i].copy()).to(device) for i in range(3)))


@pytest.mark.parametrize("when", ["start", "middle_key", "end", "lanes"])
@pytest.mark.parametrize("mt,any_hit", MODES)
def test_moving_domain_kernels_match_plain(dev, stage7, when, mt, any_hit):
    """Rays in the rotating mesh's local space at the shutter's start, its
    middle key, its end and at each lane's own time: the masks, the block
    traversal and the winners' row gathers equal their plain versions."""
    scene = stage7["card"]
    n = stage7["o"].shape[0]
    time = {"start": np.zeros(n, np.float32),
            "middle_key": np.full(n, 0.5, np.float32),
            "end": np.ones(n, np.float32),
            "lanes": stage7["time"]}[when]
    time = torch.from_numpy(time).to(dev)
    o_l, d_l, _ = xf.local_ray(scene, scene.ktab_xf[0],
                               _v3_on(stage7["o"], dev),
                               _v3_on(stage7["d"], dev), time)
    box = scene.ktab_box[0]
    tri = scene.ktab_tri[0] if mt == "vpu" else scene.ktab_mxu[0]
    tmax = torch.full((n,), float("inf"), device=dev)
    soat, _, n_live = tv.prepare_rays(o_l, d_l, tmax, box, 1e-4)
    masks = tv.cluster_masks(soat, box, 1e-4, n_live)
    assert torch.equal(masks, tv.cluster_masks_plain(soat, box, 1e-4, n_live))
    got = tv.traverse_blocks(masks, soat, tri, 1e-4, mt, any_hit, n_live,
                             slices=scene.ktab_slice[0])
    ref = tv.traverse_blocks_plain(masks, soat, tri, 1e-4, mt, any_hit,
                                   n_live)
    torch.cuda.synchronize()
    assert int((ref[1] >= 0).sum()) > n // 32
    _check_blocks(got, ref, any_hit)
    if not any_hit:
        p = ref[1].view(-1)
        idx = torch.where(p >= 0, scene.ktab_base[0][
            (torch.clamp_min(p, 0) // tkt.KTRI).long()]
            + torch.clamp_min(p, 0) % tkt.KTRI, 0).to(torch.int32)
        for table in (scene.tri_vm_rows, scene.tri_meta_rows):
            g = tv.gather_rows_t(table, idx)
            assert torch.equal(g.view(torch.int32),
                               tv.gather_rows_t_plain(table, idx)
                               .view(torch.int32))


def test_stage7_scene_intersect_on_the_card_matches_the_cpu(dev, stage7):
    """scene_intersect of the stage-7 scene at the lanes' times on the card
    equals the port on the CPU: identical hit, shape and material; t to
    1e-5 relative and normals to 1e-5 (elementwise float32 on both; the
    kernels are bit-identical to the plain versions the CPU runs)."""
    from rayito_tpu_torch.render import trace as tr

    n = stage7["o"].shape[0]
    hits = []
    for device, scene in ((dev, stage7["card"]),
                          (torch.device("cpu"), stage7["cpu"])):
        h = tr.scene_intersect(
            scene, _v3_on(stage7["o"], device), _v3_on(stage7["d"], device),
            torch.from_numpy(stage7["time"]).to(device), 1e-4,
            torch.full((n,), 1e30, device=device))
        hits.append(h)
    g, c = hits
    valid = c.valid
    assert torch.equal(g.valid.cpu(), valid)
    assert torch.equal(g.shape_id.cpu(), c.shape_id)
    assert torch.equal(g.mat.cpu(), c.mat)
    assert int((c.shape_id >= stage7["cpu"].mesh_id0).sum()) > n // 32
    torch.testing.assert_close(g.t.cpu()[valid], c.t[valid], rtol=1e-5,
                               atol=0.0)
    for comp in "xyz":
        torch.testing.assert_close(getattr(g.normal, comp).cpu()[valid],
                                   getattr(c.normal, comp)[valid],
                                   rtol=0.0, atol=1e-5)


# ------------------------------- mesh lights, many shapes and many lights


def _mesh_light_scene(path):
    """A bullseye plane, two spheres, a rect light and the stand-in mesh
    wrapped as a ShapeLight: one mesh light switches NEE's BRDF side to
    the full closest-hit query."""
    import rayito_tpu_torch as tt
    from rayito_tpu_torch.models.obj import load_obj

    s = tt.Scene()
    s.add(tt.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                   tt.DiffuseMaterial((0.7, 0.7, 0.9)), bullseye=True))
    s.add(tt.Sphere((3.0, -1.0, 0.0), 1.0,
                    tt.GlossyMaterial((0.3, 0.9, 0.3), 0.1)))
    s.add(tt.Sphere((-2.0, -1.5, 1.0), 0.5,
                    tt.DiffuseMaterial((0.7, 0.7, 0.2))))
    s.add(tt.RectangleLight((-1.5, 4.0, -1.5), (3.0, 0.0, 0.0),
                            (0.0, 0.0, 3.0), (1.0, 1.0, 1.0), 5.0))
    s.add(tt.ShapeLight(load_obj(path, tt.DiffuseMaterial((1, 1, 1))),
                        color=(1.0, 1.0, 0.3), power=10.0))
    return s


def _mesh_light_first_scene(path):
    """A plane, a small box wrapped as a ShapeLight and then the stand-in
    mesh: the light is not the scene's last mesh, so the CDF past its own
    run of 48 is the next mesh's."""
    import rayito_tpu_torch as tt
    from rayito_tpu_torch.models.demo import inline_box_mesh
    from rayito_tpu_torch.models.obj import load_obj

    s = tt.Scene()
    s.add(tt.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                   tt.DiffuseMaterial((0.7, 0.7, 0.9))))
    lm = inline_box_mesh(tt.DiffuseMaterial((0.9, 0.9, 0.9)))
    lm.vertices = (np.asarray(lm.vertices, np.float32) * np.float32(0.5)
                   + np.float32([0.0, 3.0, 0.0]))
    s.add(tt.ShapeLight(lm, color=(1.0, 1.0, 1.0), power=8.0))
    s.add(load_obj(path, tt.DiffuseMaterial((0.8, 0.3, 0.1))))
    return s


@pytest.fixture(scope="module")
def lit(dev, tmp_path_factory):
    """{name: (scene on the card, scene on the CPU)}."""
    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.models.scene import scene_data_from_arrays

    path = str(tmp_path_factory.mktemp("obj") / "bumpy8.obj")
    demo.write_bumpy_standin(path, n=8)
    out = {}
    for name, scene in (
            ("mesh_light", _mesh_light_scene(path)),
            ("mesh_light_first", _mesh_light_first_scene(path)),
            ("spheres40", demo.many_spheres_scene()),
            ("spheres40_motion", demo.many_spheres_scene(motion=True)),
            ("spheres40_twins", demo.many_spheres_scene(twins=True)),
            ("lights16", demo.sixteen_lights_scene())):
        arrays, static = scene.compile_arrays()
        out[name] = (scene_data_from_arrays(arrays, static, dev),
                     scene_data_from_arrays(arrays, static, "cpu"))
    return out


@pytest.mark.parametrize("name", ["mesh_light", "mesh_light_first"])
def test_mesh_light_sampling_on_the_card_matches_the_cpu(dev, lit, name):
    """sample_light and light_intersect_pdf of the mesh light: the same
    triangle picks (searchsorted over the light's own run of the f32 CDF,
    also when another mesh's CDF follows it), every pick a triangle of the
    light, positions to 1e-5, the same rejected samples off the facing
    edge, pdfs to 1e-5 relative."""
    from rayito_tpu_torch.models.scene import LIGHT_MESH
    from rayito_tpu_torch.render import lights as L

    card, cpu = lit[name]
    li = cpu.light_kinds_host.index(LIGHT_MESH)
    mi = cpu.light_indices_host[li]
    n = 4 * SB
    rs = np.random.default_rng(41)
    ref_pos = np.stack([rs.uniform(-4, 4, n), rs.uniform(-2, 4, n),
                        rs.uniform(-4, 4, n)], 1).astype(np.float32)
    u = rs.uniform(0, 1, (3, n)).astype(np.float32)
    u[2, :2] = 0.0, np.nextafter(np.float32(1.0), np.float32(0.0))
    out = {}
    for device, scene in ((dev, card), (torch.device("cpu"), cpu)):
        uu = [torch.from_numpy(x).to(device) for x in u]
        tri0, count = scene.mesh_tri_ranges[mi]
        cdf = scene.tri_area_cdf[tri0:tri0 + -(-count // 48) * 48]
        pick = torch.searchsorted(cdf, uu[2] * scene.mesh_total_area[mi],
                                  right=True)
        pos, nrm, pdf = L.sample_light(scene, li, _v3_on(ref_pos, device),
                                       None, None, *uu, 1e-4)
        ipdf = L.light_intersect_pdf(
            scene, li, _v3_on(ref_pos, device), nrm, uu[0] * 8.0 + 0.5, nrm,
            None)
        out[device.type] = [x.cpu() for x in
                            (pick, pos.x, pos.y, pos.z, nrm.x, nrm.y, nrm.z,
                             pdf, ipdf)]
    g, c = out["cuda"], out["cpu"]
    assert torch.equal(g[0], c[0])
    assert c[0].unique().numel() > min(n // 16, count // 2)
    assert int(c[0].max()) < count
    for a, b in zip(g[1:7], c[1:7]):
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-5)
    facing = sum(c[4 + k] * (torch.from_numpy(ref_pos[:, k]) - c[1 + k])
                 for k in range(3))
    clear = facing.abs() > 1e-4
    assert torch.equal((g[7] == 0)[clear], (c[7] == 0)[clear])
    litl = clear & (c[7] > 0) & (g[7] > 0)
    assert litl.sum() > n // 16
    torch.testing.assert_close(g[7][litl], c[7][litl], rtol=1e-5, atol=0.0)
    torch.testing.assert_close(g[8], c[8], rtol=1e-5, atol=0.0)


def _wave_inputs(n, device, eye=(0.0, 3.0, 12.0)):
    rs = np.random.default_rng(13)
    o = (np.asarray(eye) + rs.uniform(-0.5, 0.5, (n, 3))).astype(np.float32)
    tgt = rs.normal(0.0, 2.0, (n, 3)) + np.asarray([0.0, -0.5, 0.0])
    d = ((tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True))
    px = torch.arange(n, dtype=torch.int32, device=device) % 64
    py = torch.arange(n, dtype=torch.int32, device=device) // 64
    return (_v3_on(o, device), _v3_on(d.astype(np.float32), device),
            torch.from_numpy(rs.uniform(0, 1, n).astype(np.float32)).to(device),
            px, py, px % 4)


@pytest.mark.parametrize("name", ["mesh_light", "spheres40",
                                  "spheres40_motion", "lights16"])
def test_pathtrace_wave_does_not_wait_on_the_device(dev, lit, name):
    """One wavefront to depth 3 at power-of-two sample counts (2x2 pixel
    samples, one light sample) under the sync debug mode 'error': the
    mesh-light branch (CDF search, triangle-row gather, the full BRDF-side
    query), the batched folds and the chosen-light NEE read nothing back.
    The result equals the same call outside the debug mode, and is close
    to the CPU's."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils.config import RenderConfig

    card, cpu = lit[name]
    cfg = RenderConfig(width=64, height=64, pixel_samples=2, light_samples=1,
                       max_depth=3)
    n = 2 * SB
    args = _wave_inputs(n, dev)
    ref, _, q_ref = pt.pathtrace_wave(card, cfg, *args)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _, q = pt.pathtrace_wave(card, cfg, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for comp in "xyz":
        assert torch.equal(getattr(got, comp), getattr(ref, comp))
    assert int(q) == int(q_ref) > n
    assert bool(torch.isfinite(got.x).all()) and float(got.x.max()) > 0.0
    on_cpu, _, q_cpu = pt.pathtrace_wave(cpu, cfg,
                                         *_wave_inputs(n, torch.device("cpu")))
    assert abs(int(q) - int(q_cpu)) <= 0.001 * int(q_cpu)
    err = float(torch.sqrt(((got.x.cpu() - on_cpu.x) ** 2).mean())
                / torch.sqrt((on_cpu.x ** 2).mean()))
    assert err <= 0.02, err  # knife-edge lanes only; see the CPU parity tests


def test_argmin_tie_on_the_card_takes_the_first_row(dev):
    """torch.argmin over rows, as the batched fold uses it: among tied
    minima the first row, for every lane, also with inf rows around."""
    rows, n = 64, 4 * SB
    rs = np.random.default_rng(3)
    t = rs.uniform(1.0, 9.0, (rows, n)).astype(np.float32)
    t[rs.uniform(0, 1, (rows, n)) < 0.5] = np.inf
    first = rs.integers(0, rows - 1, n)
    second = np.minimum(first + rs.integers(1, 40, n), rows - 1)
    t[first, np.arange(n)] = 0.5
    t[second, np.arange(n)] = 0.5
    got = torch.argmin(torch.from_numpy(t).to(dev), dim=0)
    assert torch.equal(got.cpu(), torch.from_numpy(first))
    assert torch.equal(torch.argmin(torch.from_numpy(t), dim=0),
                       torch.from_numpy(first))


@pytest.mark.parametrize("name", ["spheres40", "spheres40_motion",
                                  "spheres40_twins"])
def test_many_spheres_scene_intersect_on_the_card_matches_the_cpu(dev, lit,
                                                                  name):
    """The analytic fold on the card (the kernel) against the CPU's
    batched fold, and against the plain twin with one row per batch on the
    card (the fold shape by shape): identical hits, shapes and materials,
    t to 1e-5 relative, normals to 1e-5; of two identical spheres the lower
    row wins on both."""
    from rayito_tpu_torch.render import trace as tr

    card, cpu = lit[name]
    n = 2 * SB
    rs = np.random.default_rng(3)
    o = rs.uniform(-8, 8, (n, 3)).astype(np.float32)
    o[:, 2] += 14.0
    d = (rs.uniform(-6, 6, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    time = rs.uniform(0, 1, n).astype(np.float32)

    def query(scene, device):
        hit = tr.scene_intersect(
            scene, _v3_on(o, device), _v3_on(d, device),
            torch.from_numpy(time).to(device), 1e-4,
            torch.full((n,), 1e30, device=device))
        occ, _ = tr.scene_occluded(
            scene, _v3_on(o, device), _v3_on(d, device),
            torch.from_numpy(time).to(device), 1e-4,
            torch.full((n,), 10.0, device=device))
        return hit, occ

    g, g_occ = query(card, dev)
    c, c_occ = query(cpu, torch.device("cpu"))
    chunk, fold = tr.ROLL_CHUNK, tr.analytic_fold
    tr.ROLL_CHUNK, tr.analytic_fold = 1, tr.analytic_fold_plain
    try:
        p, p_occ = query(card, dev)
    finally:
        tr.ROLL_CHUNK, tr.analytic_fold = chunk, fold
    valid = c.valid
    assert valid.sum() > n // 8
    for other, other_occ in ((c, c_occ), (p, p_occ)):
        assert torch.equal(g.valid.cpu(), other.valid.cpu())
        assert torch.equal(g.shape_id.cpu(), other.shape_id.cpu())
        assert torch.equal(g.mat.cpu(), other.mat.cpu())
        assert torch.equal(g_occ.cpu(), other_occ.cpu())
        torch.testing.assert_close(g.t.cpu()[valid], other.t.cpu()[valid],
                                   rtol=1e-5, atol=0.0)
        for comp in "xyz":
            torch.testing.assert_close(
                getattr(g.normal, comp).cpu()[valid],
                getattr(other.normal, comp).cpu()[valid], rtol=0.0,
                atol=1e-5)
    assert torch.equal(g.t, p.t)  # the same float32 operations per element
    if name == "spheres40_twins":
        sid = g.shape_id.cpu()
        assert (sid == cpu.sphere_id0 + 18).sum() > 16
        assert (sid == cpu.sphere_id0 + 30).sum() == 0


def test_render_color_and_direct_on_the_card_match_the_cpu(dev):
    """Stage 1 bit for bit; stage 2 (16 unstratified samples) within 0.5%;
    stage 3 without its sphere light at a 1e-2 epsilon within 0.5% (with
    the light, a float32 knife edge: see test_torch_direct.py)."""
    import dataclasses

    import rayito_tpu_torch as rt
    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.render import integrator as ig
    from rayito_tpu_torch.utils.config import CONFIG_STAGE123

    cfg = dataclasses.replace(CONFIG_STAGE123, width=96, height=64)
    cpu = torch.device("cpu")
    s1 = [ig.render_color(demo.stage1_scene().compile(d), cfg,
                          fov=demo.STAGE1_FOV, camera=demo.STAGE1_CAMERA)
          for d in (dev, cpu)]
    np.testing.assert_array_equal(s1[0], s1[1])

    def no_sphere_light():
        s = rt.Scene()
        blueish = rt.DiffuseMaterial((0.9, 0.9, 1.0))
        s.add(rt.Plane(position=(0.0, -2.0, 0.0), normal=(0.0, 1.0, 0.0),
                       material=blueish, bullseye=True))
        s.add(rt.Sphere(position=(3.0, -1.0, 0.0), radius=1.0,
                        material=rt.DiffuseMaterial((0.9, 0.7, 0.8))))
        s.add(rt.Sphere(position=(-3.0, 0.0, -2.0), radius=2.0,
                        material=rt.PhongMaterial((0.7, 0.9, 0.7), 16.0)))
        s.add(rt.Sphere(position=(0.0, 0.0, 2.0), radius=1.0,
                        material=blueish))
        s.add(rt.RectangleLight(corner=(-2.5, 4.0, -2.5),
                                side1=(5.0, 0.0, 0.0), side2=(0.0, 0.0, 5.0),
                                color=(1.0, 1.0, 1.0), power=1.0))
        return s

    for make, kw, spp in ((demo.stage2_scene, {}, 16),
                          (no_sphere_light, dict(pixel_samples=2,
                                                 light_samples=2,
                                                 ray_tmin=1e-2), None)):
        c = dataclasses.replace(cfg, **kw)
        imgs = [ig.render_direct(make().compile(d), c, fov=demo.STAGE23_FOV,
                                 camera=demo.STAGE23_CAMERA, spp=spp)
                for d in (dev, cpu)]
        err = float(np.sqrt(np.mean((imgs[0] - imgs[1]) ** 2))
                    / np.sqrt(np.mean(imgs[1] ** 2)))
        assert err <= 0.005, err
        assert np.isfinite(imgs[0]).all() and imgs[0].max() > 0.0


def test_render_direct_pass_does_not_wait_on_the_device(dev):
    """One stage-3 direct pass body (the eager pass a graph captures) at
    power-of-two counts (2x2 pixel samples, 2x2 light samples) under the
    sync debug mode 'error': nothing is read back; the result equals the
    same call outside the mode."""
    import dataclasses

    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.render import integrator as ig
    from rayito_tpu_torch.utils.config import CONFIG_STAGE123

    cfg = dataclasses.replace(CONFIG_STAGE123, width=64, height=64,
                              pixel_samples=2, light_samples=2)
    scene = demo.stage3_scene().compile(dev)
    cam = tuple(tuple(float(x) for x in v) for v in demo.STAGE23_CAMERA)
    si = torch.arange(0, 4, dtype=torch.int32, device=dev)
    args = (scene, cfg, 45.0, cam, 2, 2, si)
    ref = ig._direct_pass_body(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ig._direct_pass_body(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and float(got.max()) > 0.0


def test_progressive_resume_on_the_card(dev, tmp_path):
    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.render import progressive as pg
    from rayito_tpu_torch.utils.config import RenderConfig

    scene = demo.stage5_scene().compile(dev)
    cam = PerspectiveCamera.make(30.0, *demo.STAGE5_CAMERA)
    cfg = RenderConfig(width=32, height=24, pixel_samples=4, light_samples=1,
                       max_depth=2, max_rays_per_pass=32 * 24 * 4)
    full, _ = pg.render_progressive(scene, cfg, cam)
    ck = str(tmp_path / "ck.npz")

    def interrupt(st):
        if st.samples_done >= 8:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        pg.render_progressive(scene, cfg, cam, checkpoint_path=ck,
                              on_progress=interrupt)
    resumed, st = pg.render_progressive(scene, cfg, cam, checkpoint_path=ck)
    np.testing.assert_array_equal(full, resumed)
    assert st.samples_done == 16 and full.max() > 0.0


def test_cli_stage6_launches_the_three_kernels(dev, tmp_path):
    """cli.main with no --device renders on the card through
    cluster_masks, traverse_blocks and gather_rows_t, drawing its samples
    through the cmj kernel."""
    from rayito_tpu_torch import cli
    from rayito_tpu_torch.models.demo import write_bumpy_standin
    from rayito_tpu_torch.utils.image import read_pfm

    obj = str(tmp_path / "b8.obj")
    write_bumpy_standin(obj, n=8)
    out = str(tmp_path / "s6.pfm")
    cuda_lib.reset_launch_counts()
    assert cli.main(["--scene", "stage6", "--obj", obj, "--width", "64",
                     "--height", "48", "--pfm", "-o", out]) == 0
    counts = {fn.__name__: fn.launches for fn in cuda_lib.KERNELS}
    for name in ("cluster_masks", "traverse_blocks", "gather_rows_t", "cmj"):
        assert counts[name] > 0, counts
    img = read_pfm(out)
    assert img.shape == (48, 64, 3) and np.isfinite(img).all()


# ------------------------------------------------ traversal='xla' route


def _layered_scene(n_layers=420, g=4, dz=0.05, light=False):
    """A stack of thin square layers along z (18 superclusters): rays that
    cross it end-on truncate at both levels of the pipeline; with
    ``light`` a floor, a sphere and a rect light beside it."""
    import rayito_tpu_torch as tt

    rs = np.random.default_rng(5)
    verts, idx = [], []
    for k in range(n_layers):
        z = k * dz + rs.uniform(-0.001, 0.001)
        base = len(verts)
        verts += [(i / g * 2 - 1, j / g * 2 - 1, z) for j in range(g + 1)
                  for i in range(g + 1)]
        for j in range(g):
            for i in range(g):
                a = base + j * (g + 1) + i
                idx += [(a, a + 1, a + g + 2), (a, a + g + 2, a + g + 1)]
    s = tt.Scene()
    s.add(tt.TriangleMesh(np.asarray(verts, np.float32),
                          np.asarray(idx, np.int32),
                          tt.DiffuseMaterial((0.6, 0.5, 0.4))))
    if light:
        s.add(tt.Plane((0.0, -1.5, 0.0), (0.0, 1.0, 0.0),
                       tt.DiffuseMaterial((0.7, 0.7, 0.9))))
        s.add(tt.Sphere((2.0, 0.0, 10.0), 0.8,
                        tt.DiffuseMaterial((0.8, 0.3, 0.7))))
        s.add(tt.RectangleLight((-2.0, 4.0, 0.0), (4.0, 0.0, 0.0),
                                (0.0, 0.0, 4.0), (1.0, 1.0, 1.0), 6.0))
    return s


@pytest.fixture(scope="module")
def xla_scenes(tmp_path_factory):
    from rayito_tpu_torch.models.demo import stage6_scene, write_bumpy_standin

    obj = str(tmp_path_factory.mktemp("obj") / "b8.obj")
    write_bumpy_standin(obj, n=8)
    return {"layers": _layered_scene().compile("cpu", traversal="xla"),
            "stage6": stage6_scene(obj).compile("cpu", traversal="xla")}


def _xla_rays(case, n):
    rs = np.random.default_rng(7)
    if case == "layers":
        o = np.stack([rs.uniform(-0.9, 0.9, n), rs.uniform(-0.9, 0.9, n),
                      np.full(n, -3.0)], 1)
        d = rs.normal(0.0, 0.05, (n, 3))
        d[:, 2] = 1.0
    else:
        o = rs.uniform(-3.0, 3.0, (n, 3)) + np.asarray([0.0, 0.0, 8.0])
        d = rs.normal(0.0, 0.08, (n, 3)) - o / np.linalg.norm(
            o, axis=1, keepdims=True)
    d[::10], d[5::10] = (0.0, 0.0, 1.0), (0.0, 1.0, 0.0)  # axis-parallel
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 1e30, np.float32)
    tmax[3::7] = 5.0
    return o.astype(np.float32), d.astype(np.float32), tmax


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["layers", "stage6"])
def test_xla_route_on_the_card_matches_the_cpu(dev, xla_scenes, case,
                                                any_hit):
    """mesh_intersect_clusters on 5,003 rays (the reference's blocks of
    1,250 leave 1,247 pad slots): t, beta and gamma bits, prim and
    overflow equal on the card and the CPU."""
    from rayito_tpu_torch.render import mesh_intersect as mi

    sd = xla_scenes[case]
    on_card = sd.to(dev)
    o, d, tmax = _xla_rays(case, 5003)
    m = 0 if case == "layers" else 1
    v3 = lambda a, where: V3(*(torch.from_numpy(a[:, k].copy()).to(where)
                               for k in range(3)))
    got = mi.mesh_intersect_clusters(on_card, m, v3(o, dev), v3(d, dev),
                                     1e-4, torch.from_numpy(tmax).to(dev),
                                     any_hit)
    ref = mi.mesh_intersect_clusters(sd, m, v3(o, "cpu"), v3(d, "cpu"), 1e-4,
                                     torch.from_numpy(tmax), any_hit)
    for g, r in zip(got[:4], ref[:4]):
        assert torch.equal(g.cpu().view(torch.int32), r.view(torch.int32))
    assert int(got[4]) == int(ref[4])
    assert (ref[1] >= 0).sum() > 500
    if case == "layers":
        assert int(ref[4]) > 5003


def test_nearest_k_ties_on_the_card(dev):
    """The route's nearest-k (a stable sort cut after k) keeps tied
    entries in index order on the card, as jax.lax.top_k does."""
    from rayito_tpu_torch.render.traverse import nearest_k

    rs = np.random.default_rng(9)
    for width, k in ((64, 16), (256, 24), (16, 16)):
        t = rs.choice(np.asarray([0.5, 1.0, 2.0, np.inf], np.float32),
                      (4 * SB, width))
        want = np.argsort(t, axis=1, kind="stable")[:, :k]
        got_t, got_i = nearest_k(torch.from_numpy(t).to(dev), k)
        assert torch.equal(got_i.cpu(), torch.from_numpy(want))
        np.testing.assert_array_equal(got_t.cpu().numpy(),
                                      np.take_along_axis(t, want, axis=1))


def test_xla_route_launches_gather_rows_t(dev, xla_scenes):
    """A closest-hit query under 'xla' on the card runs cluster_pipeline
    once per mesh, gathers its winners' rows through the gather_rows_t
    kernel, folds its analytic shapes in one analytic_fold launch and
    launches no kernel of the other route; its hits equal the CPU's."""
    from rayito_tpu_torch.render import trace as tr

    sd = xla_scenes["stage6"]
    on_card = sd.to(dev)
    o, d, _ = _xla_rays("stage6", 4096)
    v3 = lambda a, where: V3(*(torch.from_numpy(a[:, k].copy()).to(where)
                               for k in range(3)))
    cuda_lib.reset_launch_counts()
    got = tr.scene_intersect(on_card, v3(o, dev), v3(d, dev), None, 1e-4,
                             1e30)
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in cuda_lib.KERNELS}
    assert counts.pop("gather_rows_t") >= 2
    assert counts.pop("cluster_pipeline") == sd.n_meshes
    assert counts.pop("analytic_fold") == 1  # the plane, spheres and rect
    assert not any(counts.values())
    ref = tr.scene_intersect(sd, v3(o, "cpu"), v3(d, "cpu"), None, 1e-4,
                             1e30)
    for k in ("t", "shape_id", "mat"):
        assert torch.equal(getattr(got, k).cpu(), getattr(ref, k)), k
    assert int(got.overflow) == int(ref.overflow) == 0


def _stage6_population(sd, kind, dev, n=16384, time=None, camera=None):
    """(o, d, tmax) on the card: the stage-6 camera's rays (or
    ``camera``'s) at seeded screen positions; from their hits (at the
    lanes' ``time``), seeded bounce directions about the normal (tmax
    1e30), or shadow rays to seeded points of the rect light (tmax the
    distance less 1e-4); lanes without a hit keep the camera ray."""
    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.render import trace as tr

    rs = np.random.default_rng(17)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    cam = PerspectiveCamera.make(30.0, *(camera or demo.STAGE6_CAMERA))
    u = f(rs.uniform(0.0, 1.0, (5, n)))
    o, d, _ = cam.to(dev).make_rays(u[0], u[1], u[2], u[3], u[4])
    tmax = torch.full((n,), 1e30, device=dev)
    if kind == "camera":
        return o, d, tmax
    hit = tr.scene_intersect(sd, o, d, time, 1e-4, 1e30)
    t = torch.where(hit.valid, hit.t, 0.0)
    p = V3(o.x + d.x * t, o.y + d.y * t, o.z + d.z * t)
    if kind == "bounce":
        g = f(rs.normal(0.0, 1.0, (3, n)))
        nd = V3(hit.normal.x + g[0], hit.normal.y + g[1], hit.normal.z + g[2])
        ln = torch.sqrt(nd.x * nd.x + nd.y * nd.y + nd.z * nd.z)
        nd = V3(nd.x / ln, nd.y / ln, nd.z / ln)
    else:
        s = f(rs.uniform(0.0, 1.0, (2, n)))
        q = V3(-1.5 + 3.0 * s[0], torch.full_like(s[0], 4.0),
               -1.5 + 3.0 * s[1])
        nd = V3(q.x - p.x, q.y - p.y, q.z - p.z)
        ln = torch.sqrt(nd.x * nd.x + nd.y * nd.y + nd.z * nd.z)
        nd = V3(nd.x / ln, nd.y / ln, nd.z / ln)
        tmax = torch.where(hit.valid, ln - 1e-4, tmax)
    keep = lambda a, b: torch.where(hit.valid, a, b)
    return (V3(keep(p.x, o.x), keep(p.y, o.y), keep(p.z, o.z)),
            V3(keep(nd.x, d.x), keep(nd.y, d.y), keep(nd.z, d.z)), tmax)


@pytest.mark.parametrize("case", ["layers", "ties", "stage6_camera",
                                  "stage6_bounce", "stage6_shadow"])
def test_cluster_pipeline_kernel_matches_plain(dev, xla_scenes, case):
    """cluster_pipeline against cluster_pipeline_plain on the card, t,
    prim and per-slot overflow bit for bit, for every mesh: the layered
    stack crossed end-on (5,003 rays; it truncates at both levels),
    demo.tied_slivers_scene, whose boxes all tie (16,384 rays straight up
    z, truncating by the tie rule) and stage 6's camera, bounce and shadow populations
    (16,384 rays); the kernel reads n_active on the device, and slots past
    it are misses."""
    from rayito_tpu_torch.render import mesh_intersect as mi

    if case == "ties":
        from rayito_tpu_torch.models.demo import tied_slivers_scene

        sd = tied_slivers_scene().compile(dev, traversal="xla")
    else:
        sd = xla_scenes["layers" if case == "layers" else "stage6"].to(dev)
    if case == "ties":
        rs = np.random.default_rng(8)
        n = 16384
        f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa
        o = V3(f(rs.uniform(-0.9, 0.9, n)), f(rs.uniform(-0.9, 0.9, n)),
               f(np.full(n, -2.0)))
        z = torch.zeros((n,), device=dev)
        d, tmax = V3(z, z, z + 1.0), z + 1e30
    elif case == "layers":
        o, d, tmax = (torch.from_numpy(a).to(dev) for a in _xla_rays(
            "layers", 5003))
        o, d = (V3(a[:, 0].contiguous(), a[:, 1].contiguous(),
                   a[:, 2].contiguous()) for a in (o, d))
    else:
        o, d, tmax = _stage6_population(sd, case.split("_")[1], dev)
    total = 0
    for m in range(sd.n_meshes):
        args, _ = mi.pipeline_inputs(sd, m, o, d, 1e-4, tmax)
        got = tv.cluster_pipeline(**args)
        ref = tv.cluster_pipeline_plain(**args)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert torch.equal(g.view(torch.int32), r.view(torch.int32)), m
        n_act = int(args["n_active"])
        assert (got[1][n_act:] == -1).all() and not got[2][n_act:].any()
        total += int((got[1][:n_act] >= 0).sum())
        if case in ("layers", "ties"):
            assert int(got[2].sum()) > 5003
    assert total > 1000


# ------------------------------------------ the dispatch: passes as graphs


@pytest.fixture(scope="module")
def graph_scenes(dev, tmp_path_factory):
    """{name: (scene on the card, config, camera)}: stage 6, stage 7 (keyed
    transforms, a moving domain, shutter 0..1), the mesh-light scene, the
    big scene on its item route and the benchmark's ``big_instanced``
    (five placed copies: five traversal domains, four under a one-key
    transform), on the n=8 stand-in, 64x48 in 16-row bands, 2x2 pixel
    samples."""
    import dataclasses
    import json
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import port_scene, run
    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.models.scene import scene_data_from_arrays
    from rayito_tpu_torch.utils.config import RenderConfig

    path = str(tmp_path_factory.mktemp("obj") / "bumpy8.obj")
    demo.write_bumpy_standin(path, n=8)
    cfg = RenderConfig(width=64, height=48, pixel_samples=2,
                       light_samples=1, max_depth=3, aspect_correction=True,
                       max_rays_per_pass=64 * 16)
    arrays, static = _mesh_light_scene(path).compile_arrays()
    big = demo.big_streamed_scene(path).compile(dev)
    still = PerspectiveCamera.make(30.0, *demo.STAGE6_CAMERA)
    with open(os.path.join(root, "portbench", "configs",
                           "big_instanced.json")) as f:
        inst = json.load(f)
    return {
        "stage6": (demo.stage6_scene(path).compile(dev), cfg, still),
        "stage7": (demo.stage7_scene1(path).compile(dev), cfg,
                   PerspectiveCamera.make(30.0, *demo.STAGE7_CAMERA,
                                          shutter_close=1.0)),
        "mesh_light": (scene_data_from_arrays(arrays, static, dev), cfg,
                       still),
        "big_items": (dataclasses.replace(big, traverse_items=True), cfg,
                      PerspectiveCamera.make(40.0, *demo.STAGE6_CAMERA)),
        "big_instanced": (port_scene.build(inst, {"bumpy": path}).compile(
            dev), cfg, run.camera_of(inst["camera"])),
    }


def _same_pass(a, b):
    """Two (image, overflow, queries) passes agree bit for bit."""
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert int(a[2]) == int(b[2]) > 0 and int(a[1]) == int(b[1]) == 0


@pytest.mark.parametrize("name", ["stage6", "stage7", "mesh_light",
                                  "big_items"])
def test_replayed_pass_equals_the_eager_body(dev, graph_scenes, name):
    """The first call of a pass captures its graph (the warm-up under the
    sync debug mode 'error', so nothing in the pass reads the card back),
    then replays it; a second call only replays. Both equal the eager body
    bit for bit, queries included. The replay launches every kernel of the
    path: the wrappers' device counters move with it, their host counts
    (Python calls) do not."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = graph_scenes[name]
    graphs.clear()
    si = torch.arange(2, dtype=torch.int32, device=dev)
    row0 = torch.full((), 16, dtype=torch.int32, device=dev)
    with tracing.on():  # the launch counters count with tracing on
        eager = pt._path_pass_body(scene, cfg, cam.to(dev), si, row0, 16)
        first = pt._render_path_pass(scene, cfg, cam, si, 16, 16)
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        again = pt._render_path_pass(scene, cfg, cam, si, 16, 16)
        counts = cuda_lib.launch_counts()
    (g,) = graphs.graphs()
    assert g.replays == 2
    kernels = ("build_items", "traverse_items") if name == "big_items" else \
        ("cluster_masks", "traverse_blocks")
    for k in kernels + ("gather_rows_t", "cmj"):
        assert counts[k] > 0, counts
    assert all(fn.launches == 0 for fn in cuda_lib.KERNELS)
    _same_pass(first, eager)
    _same_pass(again, eager)
    graphs.clear()


def test_graphs_go_with_their_scene(dev, graph_scenes):
    """Two scenes rendered in turn: when the first is collected its graph
    and pool are freed (the cache holds a scene weakly), so the memory the
    caching allocator holds drops and only the second scene's graph
    stays."""
    import dataclasses
    import gc

    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import graphs

    base_scene, cfg, cam = graph_scenes["stage6"]
    graphs.clear()
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved(dev)
    first = dataclasses.replace(base_scene)  # the same tensors, a new scene
    pt._render_path_pass(first, cfg, cam, [0, 1], 0, 16)
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved(dev) - before
    assert held > 0 and len(graphs.graphs()) == 1
    del first
    gc.collect()
    assert not graphs.graphs()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(dev) - before < held
    second = dataclasses.replace(base_scene)
    img, _, q = pt._render_path_pass(second, cfg, cam, [0, 1], 0, 16)
    assert len(graphs.graphs()) == 1 and int(q) > 0
    del second, img, q
    gc.collect()
    assert not graphs.graphs()


def test_one_graph_takes_a_new_camera_and_row0(dev, graph_scenes):
    """A pass captured with one camera and row 0 replays with another
    camera (moved, depth of field on, a shutter) and row 32: equal to a
    fresh eager pass of the new inputs, through the same graph."""
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = graph_scenes["stage6"]
    graphs.clear()
    si = torch.arange(2, dtype=torch.int32, device=dev)
    pt._render_path_pass(scene, cfg, cam, si, 0, 16)
    other = PerspectiveCamera.make(35.0, (1.0, 4.0, 14.0), (0.0, -0.5, 0.0),
                                   (0.0, 1.0, 0.0), focal_distance=12.0,
                                   lens_radius=0.2, shutter_close=1.0)
    got = pt._render_path_pass(scene, cfg, other, si, 32, 16)
    eager = pt._path_pass_body(
        scene, cfg, other.to(dev), si,
        torch.full((), 32, dtype=torch.int32, device=dev), 16)
    torch.cuda.synchronize()
    assert len(graphs.graphs()) == 1 and graphs.graphs()[0].replays == 2
    _same_pass(got, eager)
    graphs.clear()


def _xla_pass_scenes(graph_scenes):
    """{name: (scene, config, camera)} under 'xla' on the card: stage 6 and
    the layered stack seen end-on (which overflows)."""
    import dataclasses

    from rayito_tpu_torch.models.camera import PerspectiveCamera

    scene, cfg, cam = graph_scenes["stage6"]
    layers = _layered_scene(light=True).compile(scene.device,
                                                traversal="xla")
    end_on = PerspectiveCamera.make(25.0, (0.0, 0.3, -6.0), (0.0, 0.0, 10.0),
                                    (0.0, 1.0, 0.0))
    return {"stage6": (dataclasses.replace(scene, traversal="xla"), cfg, cam),
            "layers": (layers, cfg, end_on)}


@pytest.mark.parametrize("name", ["stage6", "layers"])
def test_xla_pass_is_captured_and_replayed(dev, graph_scenes, name):
    """An 'xla' pass is captured like any other: the warm-up under the
    sync debug mode 'error' reads nothing back, a second call only
    replays, and both equal the eager body bit for bit, overflow and
    queries included. The replay launches cluster_pipeline once per mesh
    query, gather_rows_t, the sample streams' kernel, each shading kernel
    once per bounce and the analytic fold once per query, and no kernel of
    the other route."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = _xla_pass_scenes(graph_scenes)[name]
    graphs.clear()
    si = torch.arange(2, dtype=torch.int32, device=dev)
    row0 = torch.full((), 16, dtype=torch.int32, device=dev)
    with tracing.on():  # the launch counters count with tracing on
        eager = pt._path_pass_body(scene, cfg, cam.to(dev), si, row0, 16)
        first = pt._render_path_pass(scene, cfg, cam, si, 16, 16)
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        again = pt._render_path_pass(scene, cfg, cam, si, 16, 16)
        counts = cuda_lib.launch_counts()
    (g,) = graphs.graphs()
    assert g.replays == 2 and all(fn.launches == 0 for fn in cuda_lib.KERNELS)
    assert counts.pop("cluster_pipeline") > 0 and counts.pop("cmj") > 0
    assert (counts.pop("bounce_prepare") == counts.pop("bounce_resolve")
            == cfg.max_depth)
    # the analytic fold once per query: a closest hit and two shadow
    # queries a light sample per bounce
    assert counts.pop("analytic_fold") == cfg.max_depth * (
        1 + 2 * cfg.light_samples)
    assert counts.pop("gather_rows_t") > 0 and not any(counts.values())
    for got in (first, again):
        assert torch.equal(got[0].view(torch.int32),
                           eager[0].view(torch.int32))
        assert int(got[1]) == int(eager[1]) and int(got[2]) == int(eager[2])
    assert int(eager[2]) > 0
    assert (int(eager[1]) > 0) == (name == "layers")
    graphs.clear()


def test_xla_entry_points_replay_graphs(dev, graph_scenes, tmp_path):
    """Under 'xla', render_path_with_stats, render_progressive (with a
    checkpoint) and the sharded render over the one card run their passes
    as replayed graphs with the same image, overflow and queries."""
    from rayito_tpu_torch.parallel import sharding as sh
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.render import progressive as pg
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = _xla_pass_scenes(graph_scenes)["layers"]
    graphs.clear()
    img, ovf, q = pt.render_path_with_stats(scene, cfg, cam)
    assert [g.replays for g in graphs.graphs()] == [12]  # 4 spp x 3 bands
    assert ovf > 0 and q > 0
    p_img, st = pg.render_progressive(scene, cfg, cam,
                                      checkpoint_path=str(tmp_path / "c.npz"))
    np.testing.assert_array_equal(p_img, img)
    assert (st.rays_traced, st.overflow) == (q, ovf)
    assert graphs.graphs()[0].replays == 24
    s_img, s_ovf, s_q = sh.render_path_sharded_with_stats(scene, cfg, cam,
                                                          [dev])
    np.testing.assert_array_equal(s_img, img)
    assert (s_ovf, s_q) == (ovf, q)
    labels = [g.label for g in graphs.graphs()]
    assert any(lab.startswith("sharded") for lab in labels), labels
    graphs.clear()


def test_frame_replays_do_not_alias(dev, graph_scenes):
    """One frame of three launches through one graph: each launch's image
    is copied out before the next replay, so every image equals its own
    eager pass, the rows differ, and none shares storage with the graph's
    output buffer (which holds the last launch only)."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = graph_scenes["stage6"]
    graphs.clear()
    si_mat = torch.tensor([[0, 1], [0, 1], [2, 3]], dtype=torch.int32,
                          device=dev)
    row0s = torch.tensor([0, 32, 16], dtype=torch.int32, device=dev)
    imgs, ovf, q = pt._render_path_frame(scene, cfg, cam, si_mat, row0s, 16)
    torch.cuda.synchronize()
    (g,) = graphs.graphs()
    out = g.outputs[0]
    assert g.replays == 3
    assert imgs.untyped_storage().data_ptr() != out.untyped_storage(
        ).data_ptr()
    q_sum = 0
    for k in range(3):
        eager = pt._path_pass_body(scene, cfg, cam.to(dev), si_mat[k],
                                   row0s[k], 16)
        assert torch.equal(imgs[k].view(torch.int32),
                           eager[0].view(torch.int32)), k
        q_sum += int(eager[2])
    assert int(q) == q_sum and ovf == 0
    assert not torch.equal(imgs[0], imgs[1])
    assert torch.equal(out, imgs[2])
    graphs.clear()


def test_entry_points_replay_graphs(dev, graph_scenes, tmp_path):
    """render_path_with_stats, render_progressive (with a checkpoint), the
    sharded render over the one card, render_color and render_direct run
    their passes as replayed graphs, and the sharded and progressive
    renders keep render_path_with_stats's bits."""
    import dataclasses

    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.parallel import sharding as sh
    from rayito_tpu_torch.render import integrator as ig
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.render import progressive as pg
    from rayito_tpu_torch.utils import graphs
    from rayito_tpu_torch.utils.config import CONFIG_STAGE123

    scene, cfg, cam = graph_scenes["stage6"]
    graphs.clear()
    img, ovf, q = pt.render_path_with_stats(scene, cfg, cam)
    assert [g.replays for g in graphs.graphs()] == [12]  # 4 spp x 3 bands
    p_img, st = pg.render_progressive(scene, cfg, cam,
                                      checkpoint_path=str(tmp_path / "c.npz"))
    np.testing.assert_array_equal(p_img, img)
    assert st.rays_traced == q and graphs.graphs()[0].replays == 24
    s_img, _, s_q = sh.render_path_sharded_with_stats(scene, cfg, cam,
                                                      [dev])
    np.testing.assert_array_equal(s_img, img)
    labels = [g.label for g in graphs.graphs()]
    assert any(lab.startswith("sharded") for lab in labels), labels
    c3 = dataclasses.replace(CONFIG_STAGE123, width=64, height=48,
                             pixel_samples=2, light_samples=2)
    s3 = demo.stage3_scene().compile(dev)
    ig.render_color(s3, c3, fov=45.0, camera=demo.STAGE23_CAMERA)
    ig.render_direct(s3, c3, fov=45.0, camera=demo.STAGE23_CAMERA)
    labels = [g.label for g in graphs.graphs()]
    assert "color pass" in labels and any(
        lab.startswith("direct") for lab in labels), labels
    graphs.clear()


# ------------------------------------- sample streams and tiny-mesh fold


def _u32(rs, n, dev, dtype=torch.int64):
    """n seeded uint32 values on the card (int32 bits for int32)."""
    v = rs.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    v = v.view(np.int32) if dtype == torch.int32 else v.astype(np.int64)
    return torch.from_numpy(v).to(dev)


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _cpu(v):
    return v.cpu() if isinstance(v, torch.Tensor) else v


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("num", [1, 2, 3, 5, 9, 17, 144, 300, 576, 4097])
def test_cmj_samples_match_plain(dev, num, dtype):
    """cmj_sample_1d and a num x 3 cmj_sample_2d on the card (the fixed
    cycle-walk rounds) against the same calls on CPU copies of their
    inputs (the walk stopping once every lane is in range), bit for bit,
    on 65,536 lanes of seeded permutations: the plain index, a 0-d and an
    immediate permutation, and the flat index si * 3 + 2 as a multiplier
    and an addend. No cmj launch is counted."""
    from rayito_tpu_torch.ops import rng

    rs = np.random.default_rng(num)
    n = 65536
    lane = torch.arange(n, device=dev)
    idx = (lane % num).to(dtype)
    perm = _u32(rs, n, dev, dtype)
    cases = [((idx, num, perm), {}), ((idx, num, perm[0]), {}),
             ((idx, num, 0xDEADBEEF), {})]
    if num % 3 == 0:
        cases.append((((lane % (num // 3)).to(dtype), num, perm),
                      {"index_mul": 3, "index_add": 2}))
    before = rng.cmj.launches
    for args, kw in cases:
        got = rng.cmj_sample_1d(*args, **kw)
        want = rng.cmj_sample_1d(*map(_cpu, args), **kw)
        assert got.is_cuda and _same_bits(got.cpu(), want), kw
    idx2 = (lane % (num * 3)).to(dtype)
    got = rng.cmj_sample_2d(idx2, num, 3, perm)
    want = rng.cmj_sample_2d(idx2.cpu(), num, 3, perm.cpu())
    assert all(g.is_cuda and _same_bits(g.cpu(), w)
               for g, w in zip(got, want))
    assert rng.cmj.launches == before


def test_hash_combine_matches_plain(dev):
    """hash_combine on the card against the same call on CPU copies of its
    operands, bit for bit: int32 and int64 lanes, 0-d tensors and
    immediates, one to six operands, no cmj launch counted; seven
    operands and tensors on two devices are refused; an all-int hash
    stays on the host."""
    from rayito_tpu_torch.ops import rng

    rs = np.random.default_rng(2)
    n = 100_000
    a, b = _u32(rs, n, dev, torch.int32), _u32(rs, n, dev)
    c = torch.tensor(-3, dtype=torch.int32, device=dev)
    before = rng.cmj.launches
    for ops in ((a,), (a, b), (a, 7, b, c),
                (a, b, rng.PURPOSE_LIGHT, 2, c, 0xFFFFFFFF)):
        got = rng.hash_combine(*ops)
        assert got.dtype == torch.int64 and got.shape == (n,) and got.is_cuda
        assert torch.equal(got.cpu(), rng.hash_combine(*map(_cpu, ops)))
    assert rng.cmj.launches == before
    with pytest.raises(ValueError, match="at most 6"):
        rng.hash_combine(a, 1, 2, 3, 4, 5, 6)
    assert rng.hash_combine(1, 2).device.type == "cpu"
    with pytest.raises(ValueError, match="one CUDA device"):
        rng.hash_combine(a, torch.zeros(n, dtype=torch.int32))


def _draw_plans(ps, ls):
    """{name: plan} of the renderers' draw sets at (ps, ls)."""
    from rayito_tpu_torch.render import integrator as tint
    from rayito_tpu_torch.render import pathtracer as tpath
    from rayito_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(width=64, height=48, pixel_samples=ps,
                       light_samples=ls, seed=7)
    return {"camera": tpath.camera_draws(cfg),
            "bounce": tpath.bounce_draws(cfg, 3, 1),
            "bounce_dark": tpath.bounce_draws(cfg, 0, 2),
            "direct_subpixel": (tint.subpixel_draw(cfg, ps, ps),
                                tint.subpixel_draw(cfg, 64, 1)),
            "direct_lights": tint.direct_light_draws(cfg, 2)}


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("ps, ls", [(ps, ls) for ps in (1, 2, 3, 12)
                                    for ls in (1, 2)])
def test_cmj_draws_match_plain(dev, ps, ls, dtype):
    """The draw-set kernel against cmj_draws_plain (the fixed cycle-walk
    rounds on the card) on every renderer's plan, bit for bit, on 65,536
    lanes of a 640-wide grid: one launch per set, counted."""
    from rayito_tpu_torch.ops import rng

    n = 65536
    rs = np.random.default_rng(10 * ps + ls)
    lane = torch.arange(n, device=dev)
    px, py = (lane % 640).to(dtype), (lane // 640).to(dtype)
    si = torch.from_numpy(rs.integers(0, ps * ps, n)).to(dev, dtype)
    for name, plan in _draw_plans(ps, ls).items():
        before = rng.cmj.launches
        got = rng.cmj_draws(plan, px, py, si)
        assert rng.cmj.launches - before == 1, name
        want = rng.cmj_draws_plain(plan, px, py, si)
        assert got.shape == want.shape and _same_bits(got, want), name


def test_cmj_draws_split_and_captured(dev):
    """A set of 150 draws over ten seeds runs as three launches (the plan's
    64-draw and 8-seed limits) and equals its plain version; a 0-d si and
    int64 px serve every lane; a bounce's set captured in a graph counts
    one launch per replay and replays the eager draws."""
    from rayito_tpu_torch.ops import rng

    px = torch.arange(4096, dtype=torch.int32, device=dev)
    big = tuple(rng.Draw(("px", "py", k % 10), 3 + k % 4, k % 3)
                for k in range(150))
    before = rng.cmj.launches
    got = rng.cmj_draws(big, px, px // 64, px % 9)
    assert rng.cmj.launches - before == 3
    assert _same_bits(got, rng.cmj_draws_plain(big, px, px // 64, px % 9))
    si = torch.tensor(5, dtype=torch.int32, device=dev)
    got = rng.cmj_draws(big[:7], px.long(), px // 64, si)
    assert got.shape[1:] == (4096,)
    assert _same_bits(got, rng.cmj_draws_plain(big[:7], px.long(), px // 64,
                                               si))
    plan = _draw_plans(2, 2)["bounce"]
    want = rng.cmj_draws(plan, px, px // 64, px % 4)
    torch.cuda.synchronize()
    with tracing.on():
        cuda_lib.reset_launch_counts()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = rng.cmj_draws(plan, px, px // 64, px % 4)
        for _ in range(3):
            g.replay()
        torch.cuda.synchronize()
        assert rng.cmj.launches == 1
        assert cuda_lib.launch_counts()["cmj"] == 3
    assert _same_bits(out, want)


def _aligned_prefix(masks, w):
    """Each block's w-aligned count and their running sum (numpy)."""
    counts = np.unpackbits(masks.view(np.uint8)).reshape(
        masks.shape[0], -1).sum(1)
    aligned = -(-counts // w) * w
    return counts, np.concatenate([[0], np.cumsum(aligned)])


@pytest.mark.parametrize("budget", ["fits", "reference", "tile_edge",
                                    "inside_tile", "past_tile_edge"])
def test_build_items_replayed_in_a_graph(dev, budget):
    """build_items captured once in a CUDA graph and replayed five times
    over masks changed in place between replays (200 blocks of 60 words:
    25 tiles of 8 blocks), every output equal to build_items_plain on
    each replay's masks: at a budget that never overflows, at the
    reference's 24,576 / 64 (overflow by cap), and at budgets whose cut
    falls exactly at the end of the twelfth tile (block 96), inside the
    fourteenth tile (block 109) and just past the twelfth tile's end. One
    launch per replay."""
    rs = np.random.default_rng(31)
    nblk, nw, w = 200, 60, 4

    def masks_for(k):
        m = _random_masks(np.random.default_rng(1000 + k), nblk=nblk, nw=nw)
        m[rs.random(nblk) < 0.1] = 0
        return m

    first = masks_for(0)
    counts, prefix = _aligned_prefix(first, w)
    maxitems, cap = {
        "fits": (nblk * nw * 32, nw * 32),
        "reference": (24576, 64),
        "tile_edge": (int(prefix[96]), nw * 32),
        "inside_tile": (int(prefix[96 + 13]) + 2, nw * 32),
        "past_tile_edge": (int(prefix[96]) + 1, nw * 32)}[budget]
    static = torch.from_numpy(first).to(dev)
    tv.build_items(static, w, maxitems, cap)  # warm-up, eager
    torch.cuda.synchronize()
    overflowed = 0
    with tracing.on():
        cuda_lib.reset_launch_counts()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = tv.build_items(static, w, maxitems, cap)
        for k in range(5):
            static.copy_(torch.from_numpy(first if k == 0 else masks_for(k)))
            g.replay()
            want = tv.build_items_plain(static, w, maxitems, cap)
            _check_build(out, want)
            overflowed += bool(want[2])
        assert cuda_lib.launch_counts()["build_items"] == 5
    if budget == "fits":
        assert overflowed == 0
    elif budget != "past_tile_edge" or counts[96:].any():
        assert overflowed >= 1


@pytest.mark.parametrize("mesh", ["stage7b", "one_key", "nested", "tied_192",
                                  "chained"])
def test_fold_small_kernel_matches_plain(dev, mesh, monkeypatch):
    """fold_small (every tiny mesh of a query in one launch) against its
    plain twin fold_small_query_plain on the card, 131,072 seeded rays at
    lane times in [-0.5, 1.5], every 5th cut short by tmax: closest hit
    from a running best of its own (t, prim, beta, gamma and the rotation
    bit for bit on every lane) and any hit (occluded equal), one launch
    each, counted on the host and on the device. "tied_192":
    demo.twin_mesh_scene, 96 triangles twice in one mesh of 192 rows, where
    every hit must go to the lower of the two twin rows. "chained": stage
    7b's ten cubes cut into launches of at most 3 meshes (four per query),
    each launch folding into the last one's outputs."""
    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.ops.quaternion import Quat
    from rayito_tpu_torch.render import mesh_intersect as mi

    sd = {"stage7b": demo.stage7_scene2, "chained": demo.stage7_scene2,
          "one_key": demo.one_key_cube_scene,
          "nested": demo.nested_cube_scene,
          "tied_192": demo.twin_mesh_scene}[mesh]().compile(dev)
    per_query = 1
    if mesh == "chained":
        monkeypatch.setattr(mi, "FOLD_MAX_MESHES", 3)
        per_query = len(mi._fold_specs(sd))
        assert per_query == 4
    rs = np.random.default_rng(4)
    n = 131072
    if mesh in ("stage7b", "chained"):
        o = np.tile(np.float32([-4.0, 10.0, 30.0]), (n, 1))
        target = np.stack([rs.uniform(-10.0, 11.0, n),
                           rs.uniform(-2.0, 11.0, n),
                           rs.uniform(1.0, 4.0, n)], 1)
    else:
        o = np.tile(np.float32([0.3, 0.8, 6.0]), (n, 1))
        target = rs.uniform(-1.2, 1.6, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 1e30)
    tmax[::5] = 5.0
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa
    v3 = lambda a: V3(f(a[:, 0]), f(a[:, 1]), f(a[:, 2]))  # noqa: E731
    time = f(rs.uniform(-0.5, 1.5, n))
    t_run = f(np.where(rs.random(n) < 0.3, rs.uniform(20.0, 40.0, n),
                       np.inf))
    one, zero = torch.ones((n,), device=dev), torch.zeros((n,), device=dev)
    best = (t_run, torch.where(t_run < 1e30, 5, -1).to(torch.int32),
            zero + 0.25, zero + 0.5, Quat(one, V3(zero, zero, zero)))
    args = (sd, v3(o), v3(d), time, 1e-4, f(tmax))
    tracing.enable(True)  # the launch counters count with tracing on
    cuda_lib.reset_launch_counts()
    got = mi.fold_small(*args, best=best)
    want = mi.fold_small_query_plain(*args, best=best)
    flat = lambda r: [*r[:4], r[4].w, r[4].v.x, r[4].v.y, r[4].v.z]  # noqa
    assert all(_same_bits(g, w) for g, w in zip(flat(got), flat(want)))
    hit = want[1] != best[1]
    assert int(hit.sum()) > 1000
    if mesh == "tied_192":
        row0, count = sd.mesh_tri_ranges[sd.ktab_small[0]]
        rows = sd.tri_vert_rows[row0:row0 + count, :9].cpu().numpy()
        first = {}
        for i, r in enumerate(rows):
            first.setdefault(r.tobytes(), i)
        assert len(first) == count // 2  # every row has one twin
        won = got[1][hit].cpu().numpy() - row0
        assert all(first[rows[i].tobytes()] == i for i in set(won))
    occ0 = torch.from_numpy(rs.random(n) < 0.2).to(dev)
    got = mi.fold_small(*args, occluded=occ0)
    want = mi.fold_small_query_plain(*args, occluded=occ0)
    assert torch.equal(got, want) and int((want & ~occ0).sum()) > 1000
    assert mi.fold_small.launches == 2 * per_query
    assert cuda_lib.launch_counts()["fold_small"] == 2 * per_query
    tracing.enable(False)


# ---------------------------------------------------------------------------
# the analytic folds (csrc/analytic_fold.cu)
# ---------------------------------------------------------------------------


def _nested_analytic_scene():
    """Depth-3 chains on analytic shapes: a group turning about Y over the
    shutter holds a translated, scaled group, which holds a sphere with two
    keys of its own and a translated rect light; a bullseye plane and a
    sphere light stay at the root."""
    import rayito_tpu_torch as tt

    s = tt.Scene()
    s.add(tt.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                   tt.DiffuseMaterial((0.6, 0.6, 0.9)), bullseye=True))
    outer = tt.Group()
    outer.transform.set_rotation(0.0, (1.0, 0.0, 0.0, 0.0))
    outer.transform.set_rotation(
        1.0, (np.cos(np.pi / 6), 0.0, np.sin(np.pi / 6), 0.0))
    outer.transform.set_translation(1.0, (0.5, 0.0, 0.0))
    inner = tt.Group()
    inner.transform.set_translation(0.0, (0.0, 0.5, 0.0))
    inner.transform.set_scaling(0.0, (1.0, 1.2, 1.0))
    sph = tt.Sphere((0.0, 0.0, 0.0), 0.6, tt.GlossyMaterial((0.3, 0.9, 0.3),
                                                           0.1))
    sph.transform.set_translation(0.0, (-2.5, 0.0, 1.0))
    sph.transform.set_translation(1.0, (-2.0, 0.0, 1.0))
    inner.add(sph)
    inner.add(tt.RectangleLight((0.0, 0.0, 0.0), (2.0, 0.0, 0.0),
                                (0.0, 0.0, 2.0), (1.0, 1.0, 1.0), 5.0,
                                transform=tt.Transform(
                                    times=[0.0],
                                    translations=[(-1.0, 3.0, -1.0)])))
    outer.add(inner)
    s.add(outer)
    s.add(tt.ShapeLight(tt.Sphere((0.0, 2.0, 4.0), 0.2,
                                  tt.DiffuseMaterial((0.6, 0.6, 0.9))),
                        color=(1.0, 1.0, 0.3), power=40.0))
    return s


def _deep_analytic_scene(depth=12):
    """A sphere with keys of its own, and a rect, inside eleven nested
    groups each translated over the shutter (chains of 12 and 11 links,
    past the 8 of the shading and the tiny-mesh fold), over a plane."""
    import rayito_tpu_torch as tt

    s = tt.Scene()
    s.add(tt.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                   tt.DiffuseMaterial((0.6, 0.6, 0.9)), bullseye=True))
    sph = tt.Sphere((0.0, 0.0, 0.0), 1.5, tt.DiffuseMaterial((0.3, 0.9, 0.3)))
    sph.transform.set_translation(0.0, (-1.0, 0.0, 0.0))
    sph.transform.set_translation(1.0, (-0.6, 0.0, 0.0))
    node = tt.Group()
    node.add(sph)
    node.add(tt.RectangleLight((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0),
                               (0.0, 0.0, 2.0), (1.0, 1.0, 1.0), 5.0))
    for g in range(depth - 1):
        node.transform.set_translation(0.0, (0.1, 0.0, 0.0))
        node.transform.set_translation(1.0, (0.1, 0.03 * g, 0.0))
        if g < depth - 2:
            outer = tt.Group()
            outer.add(node)
            node = outer
    s.add(node)
    return s


def _tied_analytic_scene():
    """Rows that tie exactly: two identical bullseye planes at y = -2, a
    rect lying on them (16 x 16, so its unit normal is exact and its t
    equals the planes'), two identical spheres, and 150 seeded spheres
    after them (past the kernel's 128 rows a launch, so every query
    chains two launches), every fifth of them moving."""
    import rayito_tpu_torch as tt

    rs = np.random.default_rng(8)
    s = tt.Scene()
    for c in ((0.7, 0.7, 0.9), (0.9, 0.2, 0.2)):
        s.add(tt.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                       tt.DiffuseMaterial(c), bullseye=True))
    for c in ((0.8, 0.3, 0.7), (0.2, 0.8, 0.3)):
        s.add(tt.Sphere((1.0, 0.0, 0.5), 1.0, tt.DiffuseMaterial(c)))
    for i in range(150):
        sph = tt.Sphere(tuple(rs.uniform(-7.0, 7.0, 3)),
                        float(rs.uniform(0.1, 0.3)),
                        tt.DiffuseMaterial((0.5, 0.5, 0.5)))
        if i % 5 == 0:
            sph.transform.set_translation(0.0, (0.0, 0.0, 0.0))
            sph.transform.set_translation(1.0, tuple(rs.uniform(-1, 1, 3)))
        s.add(sph)
    s.add(tt.RectangleLight((-8.0, -2.0, -8.0), (16.0, 0.0, 0.0),
                            (0.0, 0.0, 16.0), (1.0, 1.0, 1.0), 2.0))
    return s


@pytest.fixture(scope="module")
def af_scenes(dev, graph_scenes, lit):
    """{name: scene on the card} for the analytic fold."""
    from rayito_tpu_torch.models import demo

    return {"stage6": graph_scenes["stage6"][0],
            "stage7": graph_scenes["stage7"][0],
            "stage7b": demo.stage7_scene2().compile(dev),
            "stage5": demo.stage5_scene().compile(dev),
            "mesh_light": lit["mesh_light"][0],
            "lights16": lit["lights16"][0],
            "spheres40_motion": lit["spheres40_motion"][0],
            "nested": _nested_analytic_scene().compile(dev),
            "deep": _deep_analytic_scene().compile(dev),
            "ties": _tied_analytic_scene().compile(dev)}


AF_N = 131072


def _af_rays(scene, dev, pop, seed):
    """Seeded (o, d, time, tmax) of one population on the card: camera
    rays from above and in front of the origin at points of the scene;
    bounce rays from the camera rays' nearest analytic hits (the plain
    fold's) in random directions; shadow rays from there to points around
    the lights, tmax the distance. Lane times in [-0.5, 1.5], outside the
    keys on either side. Lanes 0-31 are edges: NaN and infinite
    components, NaN, infinite and zero tmax, NaN and infinite times, and
    rays straight down onto the tied rows."""
    from rayito_tpu_torch.render import trace as tr

    rs = np.random.default_rng(seed)
    n = AF_N
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731,E501
    v3 = lambda a: V3(f(a[:, 0]), f(a[:, 1]), f(a[:, 2]))  # noqa: E731
    time = rs.uniform(-0.5, 1.5, n).astype(np.float32)
    o = np.tile(np.float32([-4.0, 5.0, 15.0]), (n, 1))
    o += rs.normal(0.0, 0.3, (n, 3)).astype(np.float32)
    target = rs.uniform([-8.0, -3.0, -8.0], [8.0, 7.0, 8.0], (n, 3))
    if pop != "camera":
        d = target - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tm = f(time) if scene.has_motion else None
        t = tr.analytic_fold_plain(scene, v3(o), v3(d), tm, 1e-4,
                                   f(np.full(n, 1e30)))[0].cpu().numpy()
        hit = np.isfinite(t)
        o = np.where(hit[:, None], o + d * np.where(hit, t, 0)[:, None],
                     target).astype(np.float32)
        if pop == "bounce":
            target = o + rs.normal(size=(n, 3))
        else:
            target = rs.uniform([-6.0, 2.0, -4.0], [6.0, 9.0, 6.0], (n, 3))
    d = (target - o).astype(np.float32)
    dist = np.linalg.norm(d, axis=1)
    d /= dist[:, None]
    tmax = (dist * 0.999 if pop == "shadow" else np.full(n, 1e30))
    tmax = tmax.astype(np.float32)
    tmax[::7] = rs.uniform(0.5, 8.0, tmax[::7].shape)
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    d[0:4] = np.float32([nan, inf, -inf, 0.0])[:, None]
    o[4:8, 1] = [nan, inf, -inf, 1e30]
    tmax[8:16] = [nan, inf, 0.0, -1.0, 1e-30, nan, inf, 0.0]
    time[16:24] = [nan, inf, -inf, 0.0, 1.0, 0.5, -1e30, 1e30]
    d[24:32] = [0.0, -1.0, 0.0]  # straight down: the tied rows
    o[24:32] = rs.uniform([-5, 3, -5], [5, 6, 5], (8, 3))
    return (v3(o), v3(d), f(time) if scene.has_motion else None, 1e-4,
            f(tmax))


def _af_flat(out):
    """analytic_fold's outputs as a flat list of tensors."""
    if torch.is_tensor(out):
        return [out]
    t, sid, mat, nrm, cmod = out
    return [t, sid, mat, nrm.x, nrm.y, nrm.z, cmod]


@pytest.mark.parametrize("pop", ["camera", "bounce", "shadow"])
@pytest.mark.parametrize("name", ["stage6", "stage7", "stage7b", "stage5",
                                  "mesh_light", "lights16",
                                  "spheres40_motion", "nested", "deep",
                                  "ties"])
def test_analytic_fold_kernel_matches_plain(dev, af_scenes, name, pop):
    """analytic_fold (every plane, sphere and rect of a query in one
    launch) against its plain twin analytic_fold_plain on the card, 131,072
    seeded lanes of one population (lanes at NaN and infinite rays, tmax
    and times among them): closest hit (t, shape id, material, normal and
    color_mod bit for bit on every lane) and any hit (occluded equal), each
    one launch a query ("ties": 155 rows, two chained launches), counted
    on the host and on the device. On "ties" the twin rows tie exactly and
    the first of them wins: the lower plane and sphere row, and a plane
    before the rect lying on it."""
    from rayito_tpu_torch.render import trace as tr

    sd = af_scenes[name]
    args = (sd, *_af_rays(sd, dev, pop, seed=len(name) * 7 + len(pop)))
    per_query = len(tr._af_specs(sd))
    assert per_query == (2 if name == "ties" else 1)
    with tracing.on():  # the launch counters count with tracing on
        cuda_lib.reset_launch_counts()
        got = tr.analytic_fold(*args)
        occ = tr.analytic_fold(*args, any_hit=True)
        counts = cuda_lib.launch_counts()
    want = tr.analytic_fold_plain(*args)
    want_occ = tr.analytic_fold_plain(*args, any_hit=True)
    for g, w in zip(_af_flat(got), _af_flat(want)):
        assert _same_bits(g, w)
    assert torch.equal(occ, want_occ)
    assert tr.analytic_fold.launches == counts["analytic_fold"] == \
        2 * per_query
    assert int(torch.isfinite(want[0]).sum()) > AF_N // 50
    assert int(want_occ.sum()) > AF_N // 50
    assert not bool(torch.isfinite(want[0][:8]).any())  # NaN / inf rays
    if name == "ties":
        # a ray going down meets both planes and the rect at one t; the
        # double-sided rect alone takes rays going up from below them
        sid, down = want[1].cpu(), args[2].y.cpu() < 0.0
        assert int((sid == 0).sum()) > 0  # the first plane
        assert not bool(((sid == 1) | (sid == sd.sphere_id0 + 1)
                         | ((sid == sd.rect_id0) & down)).any())


@pytest.mark.parametrize("name", ["stage7", "spheres40_motion", "nested"])
def test_analytic_fold_chained_launches(dev, af_scenes, name, monkeypatch):
    """With the launch limits cut (3 rows and 2 chains a launch), a query
    chains several launches, each folding into the last one's outputs:
    the same bits as one launch and as the plain twin."""
    from rayito_tpu_torch.render import trace as tr

    sd = af_scenes[name]
    args = (sd, *_af_rays(sd, dev, "bounce", seed=21))
    whole = _af_flat(tr.analytic_fold(*args))
    whole_occ = tr.analytic_fold(*args, any_hit=True)
    monkeypatch.setattr(tr, "AF_MAX_ROWS", 3)
    monkeypatch.setattr(tr, "AF_MAX_CHAINS", 2)
    per_query = len(tr._af_specs(sd))
    assert per_query >= 2
    before = tr.analytic_fold.launches
    got = _af_flat(tr.analytic_fold(*args))
    occ = tr.analytic_fold(*args, any_hit=True)
    assert tr.analytic_fold.launches - before == 2 * per_query
    want = _af_flat(tr.analytic_fold_plain(*args))
    for g, w, a in zip(got, want, whole):
        assert _same_bits(g, w) and _same_bits(a, w)
    assert torch.equal(occ, whole_occ)
    assert torch.equal(occ, tr.analytic_fold_plain(*args, any_hit=True))


@pytest.mark.parametrize("name", ["stage6", "stage7"])
def test_analytic_fold_launches_once_per_query(dev, graph_scenes, name):
    """One replayed pass launches analytic_fold once per query: per bounce
    one closest-hit and two shadow queries a light sample, read from the
    device counter; the scene_intersect and scene_occluded results of the
    replayed pass are the eager body's (test_replayed_pass_equals_the_
    eager_body holds the bits)."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = graph_scenes[name]
    graphs.clear()
    si = torch.arange(2, dtype=torch.int32, device=dev)
    with tracing.on():
        pt._render_path_pass(scene, cfg, cam, si, 16, 16)  # captures
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        pt._render_path_pass(scene, cfg, cam, si, 16, 16)
        counts = cuda_lib.launch_counts()
    assert counts["analytic_fold"] == cfg.max_depth * (
        1 + 2 * cfg.light_samples) == 9
    graphs.clear()


def _af_counts(fn):
    """(fn(), the analytic fold's nonzero counters it added)."""
    tracing.reset()
    out = fn()
    c = {k: v for k, v in tracing.counters().items()
         if k.startswith("analytic_fold.") and v}
    tracing.reset()
    return out, c


@pytest.mark.parametrize("name", ["rig256", "stage7"])
def test_analytic_fold_counters_equal_the_plain_twins(dev, many_lights,
                                                      af_scenes, name):
    """131,072 seeded bounce and shadow lanes of the 256-light rig (261
    rows, three chained launches a query) and of stage 7 (keyed rows): the
    counters the kernel adds on the device equal the plain twin's, rows x
    lanes on a closest-hit query, each lane's rows to its first hit on an
    any-hit one; with tracing off the kernel adds nothing."""
    from rayito_tpu_torch.render import trace as tr

    sd = many_lights[name][0] if name == "rig256" else af_scenes[name]
    rows = sd.n_planes + sd.n_spheres + sd.n_rects
    args = (sd, *_af_rays(sd, dev, "bounce", seed=25))
    shadow = (sd, *_af_rays(sd, dev, "shadow", seed=26))
    with tracing.on():
        got, c_k = _af_counts(lambda: tr.analytic_fold(*args))
        want, c_p = _af_counts(lambda: tr.analytic_fold_plain(*args))
        occ, a_k = _af_counts(lambda: tr.analytic_fold(*shadow,
                                                       any_hit=True))
        occ_p, a_p = _af_counts(lambda: tr.analytic_fold_plain(
            *shadow, any_hit=True))
    for g, w in zip(_af_flat(got), _af_flat(want)):
        assert _same_bits(g, w)
    assert torch.equal(occ, occ_p)
    assert c_k == c_p == {
        "analytic_fold.lanes.closest": AF_N,
        "analytic_fold.tests.plane": AF_N * sd.n_planes,
        "analytic_fold.tests.sphere": AF_N * sd.n_spheres,
        "analytic_fold.tests.rect": AF_N * sd.n_rects}
    assert min(sd.n_planes, sd.n_spheres, sd.n_rects) > 0
    assert a_k == a_p and a_k["analytic_fold.lanes.any"] == AF_N
    assert 0 < sum(a_k[f"analytic_fold.tests.{k}"]
                   for k in tr.AF_KINDS) < AF_N * rows
    _, off = _af_counts(lambda: tr.analytic_fold(*args))
    assert off == {}


# ---------------------------------------------------------------------------
# many lights: the shading's light table in device memory
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def many_lights(dev, graph_scenes, tmp_path_factory):
    """{name: (scene on the card, config, camera)}: 65 sphere lights, a
    sphere light nested nine groups deep (a chain of nine keyed links) and
    the benchmark's ``stage6_lights256`` (the stage-6 scene under 256
    lights, on the n=8 stand-in), at graph_scenes' traffic."""
    import json
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import port_scene, run, standin
    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.models.camera import PerspectiveCamera

    cfg = graph_scenes["stage6"][1]
    with open(os.path.join(root, "portbench", "configs",
                           "stage6_lights256.json")) as f:
        rig = json.load(f)
    path = str(tmp_path_factory.mktemp("obj") / "bumpy8.obj")
    standin.write_bumpy_standin(path, n=8)
    near = PerspectiveCamera.make(40.0, (0, 3, 10), (0, 0, 0), (0, 1, 0),
                                  shutter_close=1.0)
    return {
        "lights65": (demo.many_sphere_lights_scene().compile(dev), cfg,
                     near),
        "deep9": (demo.deep_light_scene().compile(dev), cfg, near),
        "rig256": (port_scene.build(rig, {"bumpy": path}).compile(dev), cfg,
                   run.camera_of(rig["camera"])),
    }


@pytest.mark.parametrize("name", ["lights65", "deep9", "rig256", "stage6",
                                  "stage7"])
def test_many_lights_render_on_the_card_bit_for_bit(dev, graph_scenes,
                                                    many_lights, name,
                                                    monkeypatch):
    """Scenes past the card's old shading limits (65 lights, a light chain
    of nine links, the 256-light rig) and stage 6 and 7: a whole eager
    pass through the shading kernels renders the image, the overflow and
    the queries of the pass through their plain twins, bit for bit."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.render import shade

    scene, cfg, cam = many_lights.get(name) or graph_scenes[name]
    if name == "deep9":
        assert int(scene.light_table[:, 2].max()) == 9

    def one_pass():
        si = torch.arange(2, dtype=torch.int32, device=dev)
        row0 = torch.full((), 16, dtype=torch.int32, device=dev)
        return pt._path_pass_body(scene, cfg, cam.to(dev), si, row0, 16)

    got = one_pass()
    monkeypatch.setattr(shade, "bounce_prepare", shade.bounce_prepare_plain)
    monkeypatch.setattr(shade, "bounce_resolve", shade.bounce_resolve_plain)
    want = one_pass()
    assert _same_bits(got[0], want[0])
    assert int(got[1]) == int(want[1]) == 0
    assert int(got[2]) == int(want[2]) > 0
    assert float(want[0].sum()) > 0.0


# ---------------------------------------------------------------------------
# the bounce's shading (csrc/shade.cu)
# ---------------------------------------------------------------------------


def _shade_calls(scene, cfg, cam, dev, keep=2):
    """The (prepare, resolve) arguments of the first ``keep`` bounces of
    one eager 16-row pass (pixel samples 0 and 1)."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.render import shade

    calls = []
    prep, res = shade.bounce_prepare, shade.bounce_resolve

    def spy_prep(*a):
        if len(calls) < keep:
            calls.append([list(a), None])
        return prep(*a)

    def spy_res(*a):
        if calls and calls[-1][1] is None:
            calls[-1][1] = list(a)
        return res(*a)

    shade.bounce_prepare, shade.bounce_resolve = spy_prep, spy_res
    try:
        pt._path_pass_body(scene, cfg, cam.to(dev),
                           torch.arange(2, dtype=torch.int32, device=dev),
                           torch.full((), 16, dtype=torch.int32, device=dev),
                           16)
    finally:
        shade.bounce_prepare, shade.bounce_resolve = prep, res
    return calls


def _shade_same(a, b):
    """Two shading outputs (tensors, V3s or None) agree bit for bit."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, V3):
        a, b = torch.stack([a.x, a.y, a.z]), torch.stack([b.x, b.y, b.z])
    return _same_bits(a, b)


def _check_shade_call(call, time=None):
    """bounce_prepare and bounce_resolve against their plain versions on
    one bounce's recorded arguments, every output bit for bit."""
    import dataclasses

    from rayito_tpu_torch.render import shade

    args, res_args = (list(a) for a in call)
    if time is not None:
        args[10] = res_args[7] = time
    got = shade.bounce_prepare(*args)
    want = shade.bounce_prepare_plain(*args)
    for f in dataclasses.fields(shade.Prepared):
        if f.name != "buffers":
            assert _shade_same(getattr(got, f.name),
                               getattr(want, f.name)), f.name
    res_args[2] = got
    for a, b in zip(shade.bounce_resolve(*res_args),
                    shade.bounce_resolve_plain(*res_args)):
        assert _shade_same(a, b)
    return got


@pytest.mark.parametrize("name", ["stage6", "stage7", "mesh_light",
                                  "lights16_ls2", "lights65", "deep9",
                                  "rig256"])
def test_shade_kernels_match_plain(dev, graph_scenes, many_lights, name):
    """Both shading kernels against their plain versions on the inputs the
    eager pass hands them at bounces 0 and 1: stage 6, stage 7 (also at
    seeded lane times in [-0.5, 1.5], outside its keys), the mesh light
    (the BRDF-side closest-hit branch), sixteen lights at
    light_samples=2, and past the kernel's old limits: 65 lights, a light
    chain of nine links (also at seeded lane times) and the 256-light rig,
    each light table read from the scene's device memory."""
    import dataclasses

    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.models.camera import PerspectiveCamera

    if name == "lights16_ls2":
        scene = demo.sixteen_lights_scene().compile(dev)
        cfg = dataclasses.replace(graph_scenes["stage6"][1], light_samples=2)
        cam = PerspectiveCamera.make(40.0, (0, 3, 10), (0, 0, 0), (0, 1, 0))
    else:
        scene, cfg, cam = many_lights.get(name) or graph_scenes[name]
    assert scene.light_table.device == scene.light_slots.device == dev
    calls = _shade_calls(scene, cfg, cam, dev)
    assert len(calls) == 2
    for call in calls:
        got = _check_shade_call(call)
        assert int(got.lane.sum()) > 0
    assert int(calls[0][1][2].ok_l.sum()) > 100
    if name in ("stage7", "deep9"):
        rs = np.random.default_rng(15)
        n = calls[0][0][3].t.shape[0]
        time = torch.from_numpy(
            rs.uniform(-0.5, 1.5, n).astype(np.float32)).to(dev)
        _check_shade_call(calls[0], time)


def test_shade_kernels_count_and_capture(dev, graph_scenes):
    """One launch of each shading kernel per bounce and pass, counted on the
    device inside a replayed graph; the kernels captured in a graph replay
    to the outputs of their eager calls."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.render import shade
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = graph_scenes["stage6"]
    graphs.clear()
    si = torch.arange(2, dtype=torch.int32, device=dev)
    with tracing.on():  # the launch counters count with tracing on
        pt._render_path_pass(scene, cfg, cam, si, 16, 16)  # captures
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        pt._render_path_pass(scene, cfg, cam, si, 16, 16)
        counts = cuda_lib.launch_counts()
    assert counts["bounce_prepare"] == counts["bounce_resolve"] == \
        cfg.max_depth
    graphs.clear()

    (args, res_args), = _shade_calls(scene, cfg, cam, dev, keep=1)
    eager = shade.bounce_prepare(*args)
    res_args[2] = eager
    eager_res = shade.bounce_resolve(*res_args)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with tracing.on():  # the capture holds the launch counters' adds
        with torch.cuda.graph(g):
            prep = shade.bounce_prepare(*args)
            res_args[2] = prep
            out = shade.bounce_resolve(*res_args)
        cuda_lib.reset_launch_counts()
        g.replay()
        g.replay()
        torch.cuda.synchronize()
        counts = cuda_lib.launch_counts()
    assert counts["bounce_prepare"] == counts["bounce_resolve"] == 2
    assert _shade_same(prep.result, eager.result)
    assert _shade_same(prep.wb, eager.wb)
    for a, b in zip(out, eager_res):
        assert _shade_same(a, b)


def test_shade_wrappers_refuse_what_they_cannot_launch(dev, graph_scenes):
    """bounce_resolve takes only a prep its kernel made on the card; mixed
    devices raise."""
    from rayito_tpu_torch.render import shade

    scene, cfg, cam = graph_scenes["stage6"]
    (args, res_args), = _shade_calls(scene, cfg, cam, dev, keep=1)
    res_args[2] = shade.bounce_prepare_plain(*args)
    with pytest.raises(ValueError, match="bounce_prepare on the card"):
        shade.bounce_resolve(*res_args)
    args[4] = args[4].cpu()
    with pytest.raises(ValueError, match="bounce_prepare"):
        shade.bounce_prepare(*args)


# ---------------------------------------------------------------------------
# tracing (utils/tracing.py): spans and counters in replayed graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["stage6", "big_instanced"])
def test_traced_pass_replays_the_untraced_bits(dev, graph_scenes, name):
    """A stage-6 pass, and one of the five-domain ``big_instanced``,
    replayed from its traced graph gives the image, the queries and the
    overflow of its untraced graph, bit for bit; the two graphs are cached
    apart."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = graph_scenes[name]
    graphs.clear()
    si = torch.arange(2, dtype=torch.int32, device=dev)
    off = [pt._render_path_pass(scene, cfg, cam, si, 16, 16)
           for _ in range(2)]
    with tracing.on():
        on = [pt._render_path_pass(scene, cfg, cam, si, 16, 16)
              for _ in range(2)]
    gs = graphs.graphs()
    assert len(gs) == 2 and [g.template is None for g in gs] == [True, False]
    assert all(g.replays == 2 for g in gs)
    for p in off[1:] + on:
        _same_pass(p, off[0])
    graphs.clear()


def _chrome_events(prof, tmp_path):
    import json

    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


@pytest.mark.parametrize("name", ["stage6", "big_instanced"])
def test_device_spans_from_the_log_and_the_trace_agree(dev, graph_scenes,
                                                       tmp_path, name):
    """A progressive render replayed with tracing on under the profiler:
    every device span comes back from the log (its %globaltimer stamps)
    and from the trace (its markers paired in order), with durations that
    agree; each band's spans hang below its band.replay and serve its
    request; every mesh query holds one ``domain`` span a traversal domain
    (one in stage 6, five in ``big_instanced``), each with one
    ``domain_merge``."""
    from torch.profiler import ProfilerActivity, profile

    from rayito_tpu_torch.render import progressive as tprog
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = graph_scenes[name]
    graphs.clear()
    with tracing.on():
        tprog.render_progressive(scene, cfg, cam)  # captures
        torch.cuda.synchronize()
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tprog.render_progressive(scene, cfg, cam)
            torch.cuda.synchronize()
        snap = tracing.snapshot()
    clocked = tracing.on_trace(snap, _chrome_events(prof, tmp_path))
    on_clock = {s.id: s for s in clocked if s.kind == "device"}
    assert len(on_clock) == len(snap.device) > 0
    replays = [s for s in snap.host if s.name == "band.replay"]
    assert len(replays) == 12  # 3 bands of 16 rows, 4 samples
    for rep in replays:
        top = [s for s in snap.device if s.parent == rep.id]
        assert [s.name for s in top] == ["camera_rays", "bounce[0]",
                                         "bounce[1]", "bounce[2]", "image"]
    kids = {}
    for s in snap.device:
        kids.setdefault(s.parent, []).append(s.name)
    meshes = [s for s in snap.device if s.name == "mesh"]
    domains = [s for s in snap.device if s.name == "domain"]
    assert meshes and all(kids[m.id] == ["domain"] * len(scene.ktab_xf)
                          for m in meshes)
    assert all(kids[d.id].count("domain_merge") == 1 for d in domains)
    by_id = {s.id: s for s in snap.device}
    host = {s.id: s for s in snap.host}
    for s in snap.device:
        root = s
        while root.parent in by_id:
            root = by_id[root.parent]
        # a band's replay, or its read-back (the copy: "readback")
        band = host[root.parent]
        assert band.name in ("band.replay", "band.readback")
        assert s.request == band.request and s.end > s.start
        log_us = (s.end - s.start) / 1e3
        trace_us = on_clock[s.id].end - on_clock[s.id].start
        assert abs(log_us - trace_us) <= 5.0 + 0.02 * trace_us, s.name
    graphs.clear()


def _device_ops(events):
    return [e["name"] for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


@pytest.mark.parametrize("name", ["stage6", "big_instanced"])
def test_an_untraced_graph_holds_no_marker_or_counter_add(dev, graph_scenes,
                                                          tmp_path, name):
    """One replay of a stage-6 pass graph, and of a five-domain
    ``big_instanced`` one, under the profiler, captured with tracing off
    and with it on: the untraced replay runs no marker kernel, and the
    traced one runs exactly its template's markers and counter adds more
    device operations; the traced template books ``traverse.lanes`` once
    a replay, and the untraced graph has no template."""
    from torch.profiler import ProfilerActivity, profile

    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = graph_scenes[name]
    graphs.clear()
    si = torch.arange(2, dtype=torch.int32, device=dev)
    ops = {}
    for traced in (False, True):
        with tracing.on(traced):
            pt._render_path_pass(scene, cfg, cam, si, 16, 16)  # captures
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                pt._render_path_pass(scene, cfg, cam, si, 16, 16)
                torch.cuda.synchronize()
            ops[traced] = _device_ops(_chrome_events(prof, tmp_path))
    (tpl,) = [g.template for g in graphs.graphs() if g.template is not None]
    # 3 bounces x 3 queries of two samples of 64 x 16 lanes, a call a domain
    assert tpl.counts["traverse.lanes"] == (
        9 * len(scene.ktab_xf) * 2 * 64 * 16)
    markers = [n for n in ops[True] if tracing.MARKER_KERNEL in n]
    assert not any(tracing.MARKER_KERNEL in n for n in ops[False])
    assert len(markers) == len(tpl.codes) > 0 and tpl.adds > 0
    assert len(ops[True]) - len(ops[False]) == len(markers) + tpl.adds
    graphs.clear()


def test_device_counters_equal_the_host_plain_counts(dev, graph_scenes,
                                                     monkeypatch):
    """A stage-6 pass on the card with tracing on, eagerly: the pair
    counter that cluster_masks adds to on the device equals a popcount of
    cluster_masks_plain on the same inputs, the live rays that ray_pack
    adds the live lanes of the plain coherence keys of its rows, and the
    query counters sum to the pass's queries. Its
    replayed graph then counts the same, launches included; the slices
    the folds ran, which an any-hit fold's early stop makes vary, are
    more than none and at most 16 a listed pair in both."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = graph_scenes["stage6"]
    graphs.clear()
    si = torch.arange(2, dtype=torch.int32, device=dev)
    row0 = torch.full((), 16, dtype=torch.int32, device=dev)
    calls, keys = [], []
    masks, pack = tv.cluster_masks, tv.ray_pack

    def spy_masks(soat, cl_box, tmin, n_live=None, b=128):
        calls.append((soat.clone(), cl_box, tmin,
                      None if n_live is None else n_live.clone(), b))
        return masks(soat, cl_box, tmin, n_live, b)

    def spy_pack(o, d, tmax, cl_box, tmin, sb=2048, key=True, chain=None):
        out = pack(o, d, tmax, cl_box, tmin, sb, key, chain)
        col = lambda k: out[0][:, k]
        keys.append(tv.coherence_key(*(col(k) for k in range(7)), cl_box,
                                     tmin))
        return out

    # the wrappers count their launches on the name they are called by
    spy_masks.__name__, spy_masks.launches = "cluster_masks", 0
    spy_pack.__name__, spy_pack.launches = "ray_pack", 0

    with tracing.on():
        tracing.reset()
        monkeypatch.setattr(tv, "cluster_masks", spy_masks)
        monkeypatch.setattr(tv, "ray_pack", spy_pack)
        eager = pt._path_pass_body(scene, cfg, cam.to(dev), si, row0, 16)
        eager_counts = tracing.counters()
        monkeypatch.undo()
        pt._render_path_pass(scene, cfg, cam, si, 16, 16)  # captures
        torch.cuda.synchronize()
        tracing.reset()
        again = pt._render_path_pass(scene, cfg, cam, si, 16, 16)
        replay_counts = tracing.counters()
    _same_pass(again, eager)
    assert len(calls) == len(keys) == 9  # 3 bounces x 3 queries
    pairs = sum(int(tv.popcount(tv.cluster_masks_plain(*c))) for c in calls)
    assert eager_counts["traverse.pairs"] == pairs > 0
    assert eager_counts["traverse.live_rays"] == sum(
        int((k < (1 << 30)).sum()) for k in keys) > 0
    assert (eager_counts["query.rays.closest"]
            + eager_counts["query.rays.shadow"]) == int(eager[2])
    # the slices an any-hit fold runs depend on when other warps' hits
    # land, so they may differ between two runs of one pass
    runs = [c.pop("traverse.slices") for c in (eager_counts, replay_counts)]
    assert all(0 < n <= pairs * 16 for n in runs)
    assert replay_counts == eager_counts
    graphs.clear()


# ---------------------------------------------------------------------------
# the tiny-mesh fold's counters, its chains in a slot table, and the stage-7
# tumbling cell's two samples a launch
# ---------------------------------------------------------------------------


def _s7b_rays(dev, n, seed):
    """n seeded rays from stage 7b's camera at the cubes, lane times in
    [0, 1], every 9th cut short."""
    rs = np.random.default_rng(seed)
    o = np.tile(np.float32([-4.0, 10.0, 30.0]), (n, 1))
    target = np.stack([rs.uniform(-10.0, 11.0, n), rs.uniform(-2.0, 11.0, n),
                       rs.uniform(1.0, 4.0, n)], 1)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 1e30)
    tmax[::9] = 30.0
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa
    v3 = lambda a: V3(f(a[:, 0]), f(a[:, 1]), f(a[:, 2]))  # noqa: E731
    return v3(o), v3(d), f(rs.uniform(0.0, 1.0, n)), f(tmax), rs


def _inf_best(dev, n):
    from rayito_tpu_torch.ops.quaternion import Quat

    one, zero = torch.ones((n,), device=dev), torch.zeros((n,), device=dev)
    return (torch.full((n,), float("inf"), device=dev),
            torch.full((n,), -1, dtype=torch.int32, device=dev), zero,
            zero.clone(), Quat(one, V3(zero, zero, zero)))


def _fold_counts(fn):
    """(fn(), the fold's nonzero counters it added)."""
    tracing.reset()
    out = fn()
    c = {k: v for k, v in tracing.counters().items()
         if k.startswith("fold_small.") and v}
    tracing.reset()
    return out, c


@pytest.mark.parametrize("chained", [False, True])
def test_fold_small_counters_equal_the_plain_twins(dev, chained,
                                                   monkeypatch):
    """A 131,072-lane band of stage 7b's ten cubes at seeded times, closest
    and any hit (a fifth of the lanes occluded before the fold): the four
    counters the kernel adds on the device equal the plain twin's, in one
    launch a query and in four chained ones."""
    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.render import mesh_intersect as mi

    sd = demo.stage7_scene2().compile(dev)
    n = 131072
    o, d, time, tmax, rs = _s7b_rays(dev, n, seed=19)
    if chained:
        monkeypatch.setattr(mi, "FOLD_MAX_MESHES", 3)
    per_query = len(mi._fold_specs(sd))
    assert per_query == (4 if chained else 1)
    args = (sd, o, d, time, 1e-4, tmax)
    occ0 = torch.from_numpy(rs.random(n) < 0.2).to(dev)
    with tracing.on():
        got, c_k = _fold_counts(lambda: mi.fold_small(
            *args, best=_inf_best(dev, n)))
        want, c_p = _fold_counts(lambda: mi.fold_small_query_plain(
            *args, best=_inf_best(dev, n)))
        occ, a_k = _fold_counts(lambda: mi.fold_small(*args,
                                                      occluded=occ0))
        occ_p, a_p = _fold_counts(lambda: mi.fold_small_query_plain(
            *args, occluded=occ0))
    assert all(_same_bits(g, w) for g, w in zip(got[:4], want[:4]))
    assert torch.equal(occ, occ_p)
    assert c_k == c_p == {"fold_small.lanes.closest": n * per_query,
                          "fold_small.links": n * 10,
                          "fold_small.tests.closest": n * 120}
    assert a_k == a_p and a_k["fold_small.lanes.any"] == n * per_query
    assert 0 < a_k["fold_small.tests.any"] < n * 120
    assert 0 < a_k["fold_small.links"] < n * 10


def _tumbling(dev, width=512, height=256, seed=2**31 + 7):
    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(width=width, height=height, pixel_samples=2,
                       light_samples=1, max_depth=3,
                       max_rays_per_pass=262144, seed=seed)
    cam = PerspectiveCamera.make(30.0, *demo.STAGE7_SCENE2_CAMERA,
                                 focal_distance=16.0, lens_radius=0.0,
                                 shutter_open=0.0, shutter_close=1.0)
    return demo.stage7_scene2().compile(dev), cfg, cam


def test_an_untraced_tumbling_pass_counts_nothing(dev, tmp_path):
    """Stage 7b's pass captured with tracing off and with it on: the
    untraced graph holds no marker and adds nothing to the fold's counters
    (its kernel is the uncounted instance), and the traced one runs no
    more device operations than its markers and counter adds: the fold's
    counts ride inside its kernel."""
    from torch.profiler import ProfilerActivity, profile

    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = _tumbling(dev, 64, 32)
    graphs.clear()
    si = torch.arange(2, dtype=torch.int32, device=dev)
    ops, counts = {}, {}
    for traced in (True, False):
        with tracing.on():
            tracing.reset()
        with tracing.on(traced):
            pt._render_path_pass(scene, cfg, cam, si, 0, 32)  # captures
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                pt._render_path_pass(scene, cfg, cam, si, 0, 32)
                torch.cuda.synchronize()
        ops[traced] = _device_ops(_chrome_events(prof, tmp_path))
        counts[traced] = {k: v for k, v in tracing.counters().items()
                          if k.startswith("fold_small.")}
    (tpl,) = [g.template for g in graphs.graphs() if g.template is not None]
    markers = [n for n in ops[True] if tracing.MARKER_KERNEL in n]
    assert not any(tracing.MARKER_KERNEL in n for n in ops[False])
    assert len(ops[True]) - len(ops[False]) == len(markers) + tpl.adds
    lanes = counts[True]["fold_small.lanes.closest"]
    assert lanes > 0 and lanes % (9 * 2 * 64 * 32) == 0  # 9 queries a pass
    assert counts[False] == {k: 0 for k in counts[True]}
    graphs.clear()


def test_two_samples_a_launch_replay_the_eager_body(dev):
    """The stage-7 tumbling cell's render: 512x256 at 2x2 samples under a
    262,144-lane budget, two samples a launch, two passes. Replayed through
    render_progressive (once traced, once not), the image is the eager pass
    bodies' sum bit for bit, the queries theirs; each pass launches the
    tiny-mesh fold 9 times (3 bounces x 3 queries)."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.render.progressive import render_progressive
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = _tumbling(dev)
    graphs.clear()
    with tracing.on():
        render_progressive(scene, cfg, cam)  # captures the traced graph
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        traced, st_t = render_progressive(scene, cfg, cam)
        counts = cuda_lib.launch_counts()
    plain, st = render_progressive(scene, cfg, cam)
    labels = sorted(g.label for g in graphs.graphs())
    assert labels == ["path pass 512x256, 2 samples"] * 2
    assert counts["fold_small"] == 2 * 9 and counts["analytic_fold"] == 2 * 9
    acc = np.zeros((256, 512, 3), np.float32)
    queries = 0
    row0 = torch.zeros((), dtype=torch.int32, device=dev)
    for s0 in (0, 2):
        si = torch.arange(s0, s0 + 2, dtype=torch.int32, device=dev)
        img, _, q = pt._path_pass_body(scene, cfg, cam.to(dev), si, row0,
                                       256)
        acc += img.cpu().numpy()
        queries += int(q)
    want = acc / np.float32(4)
    for got, stats in ((traced, st_t), (plain, st)):
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        assert stats.rays_traced == queries > 0
    graphs.clear()


def test_a_tiny_mesh_nine_links_deep_renders_on_the_card(dev):
    """A cube nine and twelve links deep (past the 8 a mesh once held):
    the kernel launches once a query, the chain in its launch's slot table,
    and agrees with the plain twin bit for bit, closest and any hit. The
    nine-link pass replays from a captured graph bit for bit against the
    eager body, the kernel launching once a query (9 a pass)."""
    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.render import mesh_intersect as mi
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import graphs
    from rayito_tpu_torch.utils.config import RenderConfig

    rs = np.random.default_rng(23)
    n = 131072
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa
    org = np.float32([0.3, 0.8, 6.0])
    tgt = rs.uniform(-1.2, 1.6, (n, 3)).astype(np.float32)
    o = V3(*(torch.full((n,), float(v), device=dev) for v in org))
    d = V3(*(f(tgt[:, k] - org[k]) for k in range(3)))
    time, tmax = f(rs.uniform(0.0, 1.0, n)), f(np.full(n, 1e30))
    scenes = {depth: demo.deep_cube_scene(depth).compile(dev)
              for depth in (9, 12)}
    for depth, sd in scenes.items():
        (spec,) = mi._fold_specs(sd)
        assert spec.n_link == depth
    with tracing.on():
        cuda_lib.reset_launch_counts()
        for depth, sd in scenes.items():
            args = (sd, o, d, time, 1e-4, tmax)
            got = mi.fold_small(*args, best=_inf_best(dev, n))
            want = mi.fold_small_query_plain(*args, best=_inf_best(dev, n))
            assert all(_same_bits(g, w) for g, w in zip(got[:4], want[:4]))
            assert int((got[1] >= 0).sum()) > 1000, depth
            occ0 = torch.zeros((n,), dtype=torch.bool, device=dev)
            assert torch.equal(mi.fold_small(*args, occluded=occ0),
                               mi.fold_small_query_plain(*args,
                                                         occluded=occ0))
        assert cuda_lib.launch_counts()["fold_small"] == 4
    scene = scenes[9]
    cfg = RenderConfig(width=64, height=48, pixel_samples=2, light_samples=1,
                       max_depth=3, max_rays_per_pass=64 * 48 * 2)
    cam = PerspectiveCamera.make(30.0, (0.5, 1.0, 7.0), (0.0, -0.5, 0.0),
                                 (0.0, 1.0, 0.0), shutter_close=1.0)
    graphs.clear()
    si = torch.arange(2, dtype=torch.int32, device=dev)
    row0 = torch.zeros((), dtype=torch.int32, device=dev)
    eager = pt._path_pass_body(scene, cfg, cam.to(dev), si, row0, 48)
    with tracing.on():
        first = pt._render_path_pass(scene, cfg, cam, si, 0, 48)  # captures
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        again = pt._render_path_pass(scene, cfg, cam, si, 0, 48)
        counts = cuda_lib.launch_counts()
    _same_pass(first, eager)
    _same_pass(again, eager)
    assert counts["fold_small"] == counts["analytic_fold"] == 9
    graphs.clear()


# ---------------------------------------------------------------------------
# the traversal's plumbing (csrc/ray_prep.cu): ray_pack, ray_reorder and
# ray_unsort around the coherence sort
# ---------------------------------------------------------------------------

# the cells' launches (stable sort), a chip_smoke band (packed sort) and a
# ragged launch (padded to 262,144)
PLUMBING_LANES = [262144, 131072, 261760]


@pytest.fixture(scope="module")
def plumbing_scenes(dev, tmp_path_factory):
    """Stage 6 and stage 7 (its rotating mesh the traversal domain) on the
    n=8 stand-in, on the card."""
    from rayito_tpu_torch.models import demo

    path = str(tmp_path_factory.mktemp("obj") / "bumpy8.obj")
    demo.write_bumpy_standin(path, n=8)
    return {"stage6": demo.stage6_scene(path).compile(dev),
            "stage7": demo.stage7_scene1(path).compile(dev)}


def _plumbing_rays(scenes, name, kind, n, dev, nan=True):
    """(o, d, tmax, cl_box, time) of ``n`` camera, bounce or shadow rays of
    stage 6 or 7 in the traversal domain's space (stage 7's at seeded lane
    times), a few lanes dead (tmax 0) and, with ``nan``, one NaN."""
    from rayito_tpu_torch.models import demo

    scene = scenes[name]
    time = None
    if name == "stage7":
        rs = np.random.default_rng(n)
        time = torch.from_numpy(rs.uniform(0.0, 1.0, n).astype(
            np.float32)).to(dev)
    o, d, tmax = _stage6_population(
        scene, kind, dev, n, time,
        demo.STAGE7_CAMERA if name == "stage7" else None)
    o, d, _ = xf.local_ray(scene, scene.ktab_xf[0], o, d, time)
    o, d = (V3(v.x.contiguous(), v.y.contiguous(), v.z.contiguous())
            for v in (o, d))
    tmax = tmax.clone()
    tmax[::97] = 0.0
    if nan:
        tmax[5] = float("nan")
    return o, d, tmax, scene.ktab_box[0], time


def _bits_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    view = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    return a.shape == b.shape and torch.equal(view(a), view(b))


def _live_rays(fn):
    """(fn()'s outputs, the lanes it added to traverse.live_rays)."""
    with tracing.on():
        tracing.reset()
        out = fn()
        torch.cuda.synchronize()
        live = tracing.counters().get("traverse.live_rays", 0)
    return out, live


@pytest.mark.parametrize("n", PLUMBING_LANES)
@pytest.mark.parametrize("kind", ["camera", "bounce", "shadow"])
@pytest.mark.parametrize("name", ["stage6", "stage7"])
def test_ray_prep_kernels_match_plain(dev, plumbing_scenes, name, kind, n):
    """Each plumbing kernel against its plain twin on the card, bit for
    bit: ray_pack's rows, sort operand and live-ray count; ray_reorder's
    rows, permutation and live steps (with and without the live prefix)
    after the unchanged torch.sort; ray_unsort's prim and t from the
    traversal's own results, sorted and not, closest hit and any hit."""
    o, d, tmax, box, _ = _plumbing_rays(plumbing_scenes, name, kind, n, dev)
    (soa8, operand), live = _live_rays(
        lambda: tv.ray_pack(o, d, tmax, box, 1e-4, SB))
    (soa8_p, operand_p), live_p = _live_rays(
        lambda: tv.ray_pack_plain(o, d, tmax, box, 1e-4, SB))
    assert _bits_equal(soa8, soa8_p) and _bits_equal(operand, operand_p)
    assert live == live_p and 0 < live < n
    bare = tv.ray_pack(o, d, tmax, box, 1e-4, SB, key=False)
    assert bare[1] is None and _bits_equal(bare[0], soa8_p)
    vals, idx = tv.coherence_sort(operand)
    assert (idx is None) == (soa8.shape[0] <= 1 << 17)
    for live_prefix in (False, True):
        got = tv.ray_reorder(soa8, vals, idx, SB, live_prefix)
        ref = tv.ray_reorder_plain(soa8, vals, idx, SB, live_prefix)
        assert all(_bits_equal(a, b) for a, b in zip(got, ref))
    soat, perm, n_live = got[0].view(-1, SB, 8), got[1], got[2]
    assert int(n_live) == -(-live // SB)
    masks = tv.cluster_masks(soat, box, 1e-4)
    tri = plumbing_scenes[name].ktab_mxu[0]
    t_bn, p_bn = (x.view(-1) for x in tv.traverse_blocks(
        masks, soat, tri, 1e-4, "bw",
        slices=plumbing_scenes[name].ktab_slice[0]))
    assert int((p_bn >= 0).sum()) > 100
    for sorted_, t_in, hit_only in ((True, t_bn, False), (True, None, True),
                                    (False, t_bn, False),
                                    (False, None, True)):
        args = (p_bn, t_in, perm if sorted_ else None, o.x.shape[0],
                hit_only)
        got, ref = tv.ray_unsort(*args), tv.ray_unsort_plain(*args)
        assert _bits_equal(got[0], ref[0]) and _bits_equal(got[1], ref[1])


# the domain's transform chain inside ray_pack: stage 7's rotating mesh
# (three keys), each of big_instanced's four one-key copies, a nested
# two-link chain (a keyed link outside a one-key one), and big_instanced's
# world-space copy (no chain: the depth-0 instance)
CHAIN_CASES = ["stage7", "big0", "big1", "big2", "big3", "nested", "depth0"]


def _chain_case(case, plumbing_scenes, graph_scenes):
    """(scene, domain, chain slots i32 [depth] on the card, camera of the
    rays) of a case: the scene's own slot table (``ktab_chain``), which is
    ``chain_slots``' chain, but for the nested case."""
    from rayito_tpu_torch.models import demo

    if case in ("stage7", "nested"):
        scene = plumbing_scenes["stage7"]
        slots = scene.ktab_chain[0]
        assert slots.tolist() == xf.chain_slots(scene, scene.ktab_xf[0])
        if case == "nested":
            one = next(s for s in range(1, scene.xf_nkeys.shape[0])
                       if int(scene.xf_nkeys[s]) == 1)
            slots = torch.tensor(slots.tolist() + [one], dtype=torch.int32,
                                 device=slots.device)
        return scene, 0, slots, demo.STAGE7_CAMERA
    scene = graph_scenes["big_instanced"][0]
    moving = [di for di, x in enumerate(scene.ktab_xf)
              if xf.chain_slots(scene, x)]
    di = ([di for di in range(len(scene.ktab_xf)) if di not in moving][0]
          if case == "depth0" else moving[int(case[-1])])
    slots = scene.ktab_chain[di]
    assert slots.tolist() == xf.chain_slots(scene, scene.ktab_xf[di])
    return scene, di, slots, None


def _chain_times(n, dev):
    """Seeded lane times over and past the shutter: before the first key,
    after the last and exactly on each key among them."""
    rs = np.random.default_rng(n + 3)
    t = rs.uniform(-0.25, 1.25, n).astype(np.float32)
    t[:: 7] = 0.0
    t[1:: 7] = 0.5
    t[2:: 7] = 1.0
    t[3:: 11] = -1.0
    t[4:: 11] = 2.0
    return torch.from_numpy(t).to(dev)


@pytest.mark.parametrize("n", [262144, 131072])
@pytest.mark.parametrize("kind", ["camera", "shadow"])
@pytest.mark.parametrize("case", CHAIN_CASES)
def test_ray_pack_chain_matches_plain(dev, plumbing_scenes, graph_scenes,
                                      case, kind, n):
    """ray_pack with the domain's chain against its plain twin (the torch
    chain of ops/transform.py, then the packing) on the card, bit for bit:
    the local rows, the sort operand, the local ray and the rotation, the
    live-ray count; without the key, and asking for less, the same rows.
    The depth-0 launch (no chain) equals the twin on the world ray."""
    import dataclasses

    scene, di, slots, camera = _chain_case(case, plumbing_scenes,
                                           graph_scenes)
    time = _chain_times(n, dev)
    o, d, tmax = _stage6_population(scene, kind, dev, n, time, camera)
    o, d = (V3(v.x.contiguous(), v.y.contiguous(), v.z.contiguous())
            for v in (o, d))
    tmax = tmax.clone()
    tmax[::97] = 0.0
    box = scene.ktab_box[di]
    chain = None
    if case != "depth0":
        assert slots.shape[0] == (2 if case == "nested" else 1)
        chain = tv.Chain((scene.xf_times, scene.xf_translate, scene.xf_scale,
                          scene.xf_rotate, scene.xf_nkeys), slots, time,
                         want_ray=True, want_rot=True)
    else:
        assert slots.shape[0] == 0
    got, live = _live_rays(
        lambda: tv.ray_pack(o, d, tmax, box, 1e-4, SB, chain=chain))
    ref, live_p = _live_rays(
        lambda: tv.ray_pack_plain(o, d, tmax, box, 1e-4, SB, chain=chain))
    assert len(got) == len(ref) == (2 if chain is None else 3)
    assert _bits_equal(got[0], ref[0]) and _bits_equal(got[1], ref[1])
    assert live == live_p and 0 < live < n
    if chain is None:
        return
    assert all(_bits_equal(a, b) for a, b in zip(got[2], ref[2]))
    if case != "nested":
        o_l, d_l, rot = xf.local_ray(scene, scene.ktab_xf[di], o, d, time)
        assert _bits_equal(got[2][0], torch.stack((o_l.x, o_l.y, o_l.z,
                                                   d_l.x, d_l.y, d_l.z)))
        assert _bits_equal(got[2][1], torch.stack((rot.w, rot.v.x,
                                                   rot.v.y, rot.v.z)))
    bare = tv.ray_pack(o, d, tmax, box, 1e-4, SB, key=False,
                       chain=dataclasses.replace(chain, want_ray=False,
                                                 want_rot=False))
    assert bare[1] is None and bare[2] == (None, None)
    assert _bits_equal(bare[0], ref[0])


@pytest.mark.parametrize("mt,any_hit", MODES)
@pytest.mark.parametrize("case", ["stage7", "big1"])
def test_traverse_through_the_chain_equals_traverse_of_the_local_ray(
        dev, plumbing_scenes, graph_scenes, case, mt, any_hit):
    """traverse() given the world ray and the domain's chain equals
    traverse() given ops/transform.py local_ray's ray on the card: prim
    (and t on closest hits) bit for bit, at 261,760 lanes."""
    scene, di, slots, camera = _chain_case(case, plumbing_scenes,
                                           graph_scenes)
    n = 261760
    time = _chain_times(n, dev)
    o, d, tmax = _stage6_population(scene, "bounce", dev, n, time, camera)
    tri = scene.ktab_tri[di] if mt == "vpu" else scene.ktab_mxu[di]
    kw = dict(mt_mode=mt, any_hit=any_hit, slices=scene.ktab_slice[di])
    chain = tv.Chain((scene.xf_times, scene.xf_translate, scene.xf_scale,
                      scene.xf_rotate, scene.xf_nkeys), slots, time)
    box = scene.ktab_box[di]
    t, p, local = tv.traverse(o, d, tmax, box, tri, 1e-4, chain=chain, **kw)
    o_l, d_l, _ = xf.local_ray(scene, scene.ktab_xf[di], o, d, time)
    t_l, p_l = tv.traverse(o_l, d_l, tmax, box, tri, 1e-4, **kw)
    torch.cuda.synchronize()
    assert local == (None, None)
    assert int((p_l >= 0).sum()) > 100
    if any_hit:
        assert torch.equal(p >= 0, p_l >= 0)
    else:
        assert _bits_equal(t, t_l) and torch.equal(p, p_l)


def _plain_route(monkeypatch):
    for name in ("ray_pack", "ray_reorder", "ray_unsort"):
        monkeypatch.setattr(tv, name, getattr(tv, name + "_plain"))


@pytest.mark.parametrize("kind", ["bounce", "shadow"])
@pytest.mark.parametrize("name", ["stage6", "stage7"])
def test_traverse_through_the_plumbing_kernels_matches_the_plain_route(
        dev, plumbing_scenes, monkeypatch, name, kind):
    """traverse() through the three kernels equals traverse() through their
    plain twins on the card and traverse() without the sort: prim and t
    bits on closest hits, prim on any hits, at a ragged launch. No lane
    has a NaN tmax here: the sort puts such a lane past the live prefix,
    while unsorted it may take a hit in its block's clusters, in the
    reference as here."""
    o, d, tmax, box, _ = _plumbing_rays(plumbing_scenes, name, kind, 261760,
                                        dev, nan=False)
    scene = plumbing_scenes[name]
    cases = (("bw", False, True, scene.ktab_mxu[0]),
             ("vpu", True, False, scene.ktab_tri[0]))
    for mt, any_hit, want_t, tri in cases:
        run = lambda **kw: tv.traverse(o, d, tmax, box, tri, 1e-4,
                                       want_t=want_t, mt_mode=mt,
                                       any_hit=any_hit,
                                       slices=scene.ktab_slice[0], **kw)
        kern, unsorted = run(), run(sort_rays=False)
        with monkeypatch.context() as m:
            _plain_route(m)
            plain = run()
        torch.cuda.synchronize()
        assert int((plain[1] >= 0).sum()) > 100
        for other in (plain, unsorted):
            if any_hit:
                assert torch.equal(kern[1] >= 0, other[1] >= 0)
            else:
                assert _bits_equal(kern[0], other[0])
                assert torch.equal(kern[1], other[1])


def test_ray_prep_replayed_in_a_graph(dev, plumbing_scenes):
    """prepare_rays, the traversal and the unsort captured in one CUDA graph
    and replayed on two populations copied into its inputs: each replay
    equals the plain twins' rows, permutation and live steps and an eager
    traverse()'s hits, so nothing of one replay (the live count above all)
    carries into the next."""
    pops = [_plumbing_rays(plumbing_scenes, "stage6", kind, 262144, dev)
            for kind in ("camera", "bounce")]
    o, d, tmax, box, _ = pops[0]
    o, d = (V3(v.x.clone(), v.y.clone(), v.z.clone()) for v in (o, d))
    tmax = tmax.clone()
    tri = plumbing_scenes["stage6"].ktab_mxu[0]
    slices = plumbing_scenes["stage6"].ktab_slice[0]

    def body():
        soat, perm, n_live = tv.prepare_rays(o, d, tmax, box, 1e-4)
        masks = tv.cluster_masks(soat, box, 1e-4, n_live)
        t_bn, p_bn = tv.traverse_blocks(masks, soat, tri, 1e-4, "bw", False,
                                        n_live, slices=slices)
        return soat, perm, n_live, tv.ray_unsort(
            p_bn.view(-1), t_bn.view(-1), perm, o.x.shape[0])

    body()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()
    for po, pd, ptmax, _, _ in pops * 2:
        for dst, src in zip((o.x, o.y, o.z, d.x, d.y, d.z, tmax),
                            (po.x, po.y, po.z, pd.x, pd.y, pd.z, ptmax)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        soa8, operand = tv.ray_pack_plain(po, pd, ptmax, box, 1e-4, SB)
        ref = tv.ray_reorder_plain(soa8, *tv.coherence_sort(operand), SB)
        assert _bits_equal(out[0].view(-1, 8), ref[0])
        assert _bits_equal(out[1], ref[1]) and _bits_equal(out[2], ref[2])
        t, p = tv.traverse(po, pd, ptmax, box, tri, 1e-4, mt_mode="bw",
                           slices=slices)
        assert _bits_equal(out[3][0], t) and torch.equal(out[3][1], p)


def test_ray_prep_launches_once_per_traverse_call(dev, graph_scenes):
    """A replayed stage-6 pass launches ray_pack, ray_reorder and
    ray_unsort once per traverse() call (3 bounces x 3 queries), as the
    device counters read."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = graph_scenes["stage6"]
    graphs.clear()
    si = torch.arange(2, dtype=torch.int32, device=dev)
    with tracing.on():
        pt._render_path_pass(scene, cfg, cam, si, 16, 16)  # captures
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        pt._render_path_pass(scene, cfg, cam, si, 16, 16)
        counts = cuda_lib.launch_counts()
    calls = cfg.max_depth * (1 + 2 * cfg.light_samples)
    assert (counts["ray_pack"] == counts["ray_reorder"]
            == counts["ray_unsort"] == counts["traverse_blocks"] == calls
            == 9)
    graphs.clear()


def test_ray_prep_wrappers_refuse_mixed_devices(dev):
    """A wrapper launches or raises: rays on the card with a box table on
    the CPU (or the reverse) raise, and no launch is counted."""
    o = V3(*(torch.zeros(SB, device=dev) for _ in range(3)))
    tmax = torch.zeros(SB, device=dev)
    box = torch.zeros((8, 32))
    tv.ray_pack.launches = tv.ray_unsort.launches = 0
    with pytest.raises(ValueError):
        tv.ray_pack(o, o, tmax, box, 1e-4)
    p = torch.zeros(SB, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        tv.ray_unsort(p, None, torch.zeros(SB, dtype=torch.int32), SB)
    assert tv.ray_pack.launches == 0 and tv.ray_unsort.launches == 0


# ---------------------------------------------------------------------------
# the fold's slice cull (csrc/fold.cuh): a warp runs a 32-lane slice of a
# cluster only when one of its rays slab-hits the slice's box
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cull_scenes(dev, tmp_path_factory):
    """Stage 6 and stage 7 (its rotating mesh the traversal domain) on the
    n=24 stand-in (6,912 triangles, 54 clusters), on the card."""
    from rayito_tpu_torch.models import demo

    path = str(tmp_path_factory.mktemp("obj") / "bumpy24.obj")
    demo.write_bumpy_standin(path, n=24)
    return {"stage6": demo.stage6_scene(path).compile(dev),
            "stage7": demo.stage7_scene1(path).compile(dev)}


CULL_LANES = 65536


def _counted(fn):
    """(fn()'s outputs, the slices its fold ran: traverse.slices)."""
    with tracing.on():
        tracing.reset()
        out = fn()
        torch.cuda.synchronize()
        runs = tracing.counters().get("traverse.slices", 0)
    return out, runs


@pytest.mark.parametrize("b", [128, 256, 512])
@pytest.mark.parametrize("kind", ["camera", "bounce", "shadow"])
@pytest.mark.parametrize("name", ["stage6", "stage7"])
def test_slice_cull_matches_the_plain_fold(dev, cull_scenes, name, kind, b):
    """traverse_blocks with the slice cull against the plain fold, which
    runs every test, on camera, bounce and shadow rays of stage 6 and of
    stage 7's moving domain (its local space, lane times) at ray blocks of
    128, 256 and 512 (4, 8 and 16 warp groups): closest hits (BW rows)
    bit for bit in t and prim, any hits (MT rows) in prim >= 0. The
    slices the closest-hit fold ran equal fold_slices_plain's count and
    are fewer than the masks' b / 8 a (ray block, cluster) pair; the
    any-hit fold runs at most that count. At b = 128 the item route too,
    closest and any hit bit for bit, its count equal to the plain count
    over its items."""
    o, d, tmax, box, _ = _plumbing_rays(cull_scenes, name, kind, CULL_LANES,
                                        dev)
    scene = cull_scenes[name]
    sl = scene.ktab_slice[0]
    soat, _, n_live = tv.prepare_rays(o, d, tmax, box, 1e-4)
    masks = tv.cluster_masks(soat, box, 1e-4, n_live, b)
    listed = int(tv.popcount(masks)) * b // 8
    for mt, any_hit in (("bw", False), ("vpu", True)):
        tri = scene.ktab_mxu[0] if mt == "bw" else scene.ktab_tri[0]
        got, runs = _counted(lambda: tv.traverse_blocks(
            masks, soat, tri, 1e-4, mt, any_hit, n_live, b, slices=sl))
        ref = tv.traverse_blocks_plain(masks, soat, tri, 1e-4, mt, any_hit,
                                       n_live, b)
        torch.cuda.synchronize()
        assert int((ref[1] >= 0).sum()) > 100
        _check_blocks(got, ref, any_hit)
        want = int(tv.fold_slices_plain(masks, soat, sl, 1e-4, mt, n_live,
                                        b))
        assert 0 < want < listed
        assert runs <= want if any_hit else runs == want
        if b != 128:
            continue
        nblk, c_pad = masks.shape[0], box.shape[1]
        items, steps, overflow, _ = tv.build_items(masks, 4, nblk * c_pad,
                                                   c_pad)
        soab = soat.view(nblk, b, 8)
        got, runs = _counted(lambda: tv.traverse_items(
            items, steps, soab, tri, 1e-4, mt, 4, slices=sl))
        ref = tv.traverse_items_plain(items, steps, soab, tri, 1e-4, mt, 4)
        torch.cuda.synchronize()
        assert not bool(overflow)
        _equal(got, ref)
        assert runs == int(tv._item_slices_plain(items, steps, soab, sl,
                                                 1e-4, mt, 4)) > 0


def test_slice_counter_on_a_traced_render(dev, graph_scenes):
    """A stage-6 pass captured and replayed with tracing on: the slices its
    folds ran are more than none and at most the masks' 16 a (128-ray
    block, cluster) pair; the same pass captured and replayed with tracing
    off adds nothing to the counter."""
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import graphs

    scene, cfg, cam = graph_scenes["stage6"]
    graphs.clear()
    si = torch.arange(2, dtype=torch.int32, device=dev)
    counts = {}
    for traced in (True, False):
        with tracing.on():
            tracing.reset()
        with tracing.on(traced):
            pt._render_path_pass(scene, cfg, cam, si, 16, 16)  # captures
            pt._render_path_pass(scene, cfg, cam, si, 16, 16)
            torch.cuda.synchronize()
        with tracing.on():
            counts[traced] = tracing.counters()
    c = counts[True]
    assert 0 < c["traverse.slices"] <= c["traverse.pairs"] * 16
    assert counts[False]["traverse.slices"] == 0
    assert counts[False]["traverse.pairs"] == 0
    graphs.clear()
